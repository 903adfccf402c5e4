"""Host ms a frame inside the port's fipm.source.grab spans (read and
grey conversion on the grabber thread), from the port's span table over
the traced window."""
from fipm_bench.program import span_ms_per_frame, table


def read(rec):
    rows = table()
    if not any(r[0] == "fipm.source.grab" for r in rows):
        return None               # a port whose source keeps no such span
    return span_ms_per_frame(rec, "fipm.source.grab", rows)
