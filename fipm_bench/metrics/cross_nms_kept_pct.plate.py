"""The share of labelled matches that the suppression across glyphs
keeps: 100 x the port's ocr.kept over ocr.matches, counted in the port's
span table over the traced window."""
from fipm_bench.program import counter_pct


def read(rec):
    return counter_pct(rec, "ocr.kept", "ocr.matches")
