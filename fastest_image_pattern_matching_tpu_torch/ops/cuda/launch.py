"""The launch path both kernel wrappers share: the current stream of a
device as a raw handle, the device's context entered only when it is not
the current one, and small per-device counters that the kernels add to.

Every function here runs at launch time, never on import.
"""

from __future__ import annotations

import torch

_COUNTERS = {}


def _raw_stream(index: int) -> int:
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(fn, device: torch.device, *args) -> int:
    """Call the C launcher fn(*args, stream) with the current stream of
    `device`, in that device's context; returns fn's error code."""
    index = device.index
    if index == torch.cuda.current_device():
        return fn(*args, _raw_stream(index))
    with torch.cuda.device(index):
        return fn(*args, _raw_stream(index))


def counters(name: str, device: torch.device, n: int) -> torch.Tensor:
    """The int32 [n] device counters `name` of `device`, made (as zeros) at
    first use and kept for the process."""
    key = (name, device.index)
    c = _COUNTERS.get(key)
    if c is None:
        c = torch.zeros(n, dtype=torch.int32, device=device)
        _COUNTERS[key] = c
    return c


def read_counters(name: str, n: int, reset: bool = False) -> list:
    """The n counters `name`, summed over devices (one host sync each);
    with reset, set them to 0 after reading."""
    total = [0] * n
    for (key, _), c in _COUNTERS.items():
        if key == name:
            total = [a + b for a, b in zip(total, c.tolist())]
            if reset:
                c.zero_()
    return total
