"""How the port rounds f32 arithmetic where the order of operations decides
the last bit.

The JAX reference, compiled for the CPU, fuses some multiply-adds into one
rounding; PyTorch rounds every op on its own, and the card's f32 trig
functions differ from the CPU's by an ulp. These helpers pin each such step
to one rounding that is the same on both devices.
"""

from __future__ import annotations

import numpy as np
import torch


def f32(x) -> float:
    """A Python float holding the f32 rounding of x, so that mixing it into
    f32 tensor arithmetic gives the same result as a f32 scalar would."""
    return float(np.float32(x))


def fma(a, b, c) -> torch.Tensor:
    """f32 fused multiply-add a*b + c, rounded once. Evaluated in f64: the
    product of two f32 values is exact there, and the sum is rounded to f32
    after one f64 rounding, which equals the single rounding except in
    cases far rarer than the warp contract's .5-boundary flips."""
    def d(x):
        return x.to(torch.float64) if torch.is_tensor(x) else float(x)
    return (d(a) * d(b) + d(c)).to(torch.float32)


def cos_sin(x: torch.Tensor):
    """f32 cosine and sine of a f32 tensor, evaluated in f64 and rounded.
    This gives the same bits on the CPU and on the card, whose f32 trig
    functions differ by an ulp."""
    xd = x.to(torch.float64)
    return torch.cos(xd).to(torch.float32), torch.sin(xd).to(torch.float32)
