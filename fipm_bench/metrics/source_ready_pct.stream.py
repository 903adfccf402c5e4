"""The share of the frames a VideoCaptureSource yielded that were
already queued when the consumer asked: 100 x the port's source.ready
over source.frames, counted in the port's span table over the traced
window."""
from fipm_bench.program import counter_pct


def read(rec):
    return counter_pct(rec, "source.ready", "source.frames")
