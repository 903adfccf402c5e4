"""Host ms a frame inside the port's fipm.peaks spans
(ops/peaks.py::extract_peaks, all of its rounds), from the port's span table
over the traced window."""
from fipm_bench.program import span_ms_per_frame


def read(rec):
    return span_ms_per_frame(rec, "fipm.peaks")
