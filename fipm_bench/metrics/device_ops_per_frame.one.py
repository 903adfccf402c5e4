"""Device events (kernels, copies, fills) of the traced window per frame."""
from fipm_bench.readers import device_ops_per_frame as read  # noqa: F401
