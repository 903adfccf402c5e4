"""The 95th percentile of the host-clock latency of all calls of the
window, in ms."""
from fipm_bench.readers import latency_quantile_ms


def read(rec):
    return latency_quantile_ms(rec, 95)
