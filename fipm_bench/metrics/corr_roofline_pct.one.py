"""The correlation kernel's share of its roofline: the least time of the
large-map correlations that the reference needs for the window's frames
over the device time of the port's correlation kernel
(csrc/ccorr_valid.cu)."""
from fipm_bench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "corr", "ccorr_valid_kernel")
