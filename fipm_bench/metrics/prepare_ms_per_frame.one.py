"""Host ms a frame inside the port's fipm.prepare spans (input checks, plan,
template pyramid and sweep arrays to the card, build_stages, and the frame's
upload), from the port's span table over the traced window."""
from fipm_bench.program import span_ms_per_frame


def read(rec):
    return span_ms_per_frame(rec, "fipm.prepare")
