"""Seconds from the process's start to the window's first call: imports,
scenes, learning, builds and the warm-up pass."""


def read(rec):
    return rec.get("setup_s")
