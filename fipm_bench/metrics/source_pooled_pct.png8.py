"""The share of the frames a FileSource yielded that its read-ahead pool
decoded: 100 x the port's source.pooled over source.frames, counted in
the port's span table over the traced window."""
from fipm_bench.program import counter_pct


def read(rec):
    return counter_pct(rec, "source.pooled", "source.frames")
