"""Host ms a frame inside the port's fipm.descent spans, a call's frames
sharing them, from the port's span table over the traced window."""
from fipm_bench.program import span_ms_per_frame


def read(rec):
    return span_ms_per_frame(rec, "fipm.descent")
