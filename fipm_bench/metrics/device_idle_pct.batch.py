"""The share of the traced window in which no operation ran on the card."""
from fipm_bench.readers import device_idle_pct as read  # noqa: F401
