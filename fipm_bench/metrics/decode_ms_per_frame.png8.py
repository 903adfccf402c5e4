"""Host time in the frame source's next() (file read and decode) per
frame, from the entry's "decode" spans."""
from fipm_bench.readers import span_ms_per_frame


def read(rec):
    return span_ms_per_frame(rec, "decode")
