"""The warp kernel's share of its roofline: the least time of the warps
that the reference needs for the window's frames over the device time of
the port's warp kernel (csrc/warp_affine.cu)."""
from fipm_bench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "warp", "warp_affine_kernel")
