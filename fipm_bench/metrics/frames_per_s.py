"""All frames that the window completed over its whole length."""
from fipm_bench.readers import frames_per_s as read  # noqa: F401
