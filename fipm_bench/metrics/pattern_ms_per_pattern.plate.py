"""Host ms a glyph pattern inside the port's fipm.patterns.pattern spans
(one pattern's candidates of a models/batch.py::match_patterns call:
sweep score maps and peaks, selection, descent; and its finalize) over
the patterns the window ran (the counter patterns.run), from the port's
span table over the traced window; no reading where the port opens no
such span."""
from fipm_bench.program import counts, inclusive_ms, table


def read(rec):
    rows = table()
    runs = counts(rows, "patterns.run")
    if runs <= 0 or not any(r[0] == "fipm.patterns.pattern" for r in rows):
        return None
    return inclusive_ms(rows, "fipm.patterns.pattern") / runs
