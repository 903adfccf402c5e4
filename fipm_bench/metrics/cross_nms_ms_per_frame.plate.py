"""Host ms a frame inside the port's fipm.ocr.cross_nms spans (the
suppression across glyphs in float64 on the host: pair areas and the
greedy), from the port's span table over the traced window; no reading
where the port opens no such span."""
from fipm_bench.program import span_ms_per_frame, table


def read(rec):
    rows = table()
    if not any(r[0] == "fipm.ocr.cross_nms" for r in rows):
        return None
    return span_ms_per_frame(rec, "fipm.ocr.cross_nms", rows)
