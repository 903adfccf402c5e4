"""The live share of the descent's candidate rows: 100 x the port's
descent.live over descent.slots (the rows of the descent chunks that ran),
counted in the port's span table over the traced window."""
from fipm_bench.program import counter_pct


def read(rec):
    return counter_pct(rec, "descent.live", "descent.slots")
