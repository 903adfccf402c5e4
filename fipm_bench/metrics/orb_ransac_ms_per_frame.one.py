"""Host ms a frame inside the port's fipm.orb.ransac spans (4-point
hypotheses and their scoring, LO refits and the pick), from the port's
span table over the traced window; no reading where the port opens no
such span."""
from fipm_bench.program import span_ms_per_frame, table


def read(rec):
    rows = table()
    if not any(r[0] == "fipm.orb.ransac" for r in rows):
        return None
    return span_ms_per_frame(rec, "fipm.orb.ransac", rows)
