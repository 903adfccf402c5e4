"""Host ms a frame inside the port's fipm.sweep spans (the top layer's rotation
sweep: warps, score maps, peak rounds), from the port's span table over the
traced window."""
from fipm_bench.program import span_ms_per_frame


def read(rec):
    return span_ms_per_frame(rec, "fipm.sweep")
