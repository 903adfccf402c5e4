"""Chunked batch mapping to bound peak device memory.

The angle sweep and the candidate descent would otherwise materialise all
[A, Hc, Wc] canvases or [3C, h+6, w+6] ROIs at once. Here a chunk is one
iteration of a Python loop.
"""

from __future__ import annotations

import torch

from .profiling import count, span


def chunked_map(fn, xs, n: int, chunk: int, pred=None, count_as=None):
    """Apply fn over the leading axis (length n) of the tensor tuple `xs`,
    `chunk` rows at a time, and concatenate the outputs.

    fn takes a tuple of tensors with a leading dim of at most `chunk` (the
    last chunk may be shorter) and returns a tuple of tensors with the same
    leading dim. Returns the tuple of concatenated outputs.

    pred: optional [n] bool tensor. The loop stops after the last chunk
    that holds any True entry; chunks past it, and interior chunks with no
    True entry, give zeros without running fn. Reading which chunks are
    alive costs one host sync per call. If no chunk is alive, fn still runs
    once on the first chunk to learn the output shapes, and its output is
    zeroed.

    count_as: with pred, a counter prefix: the rows of the chunks that run
    are counted as `<count_as>.slots` and the True entries among them as
    `<count_as>.live` (utils/profiling.py::count), from the same host
    read. The outputs are joined in a span "fipm.join"
    (utils/profiling.py::span).
    """
    chunk = max(1, min(chunk, n))
    n_chunks = (n + chunk - 1) // chunk
    bounds = [(i * chunk, min(n, (i + 1) * chunk)) for i in range(n_chunks)]

    if pred is None:
        run = [True] * n_chunks
    else:
        pad = n_chunks * chunk - n
        p = torch.nn.functional.pad(pred.to(torch.int32), (0, pad))
        live = p.reshape(n_chunks, chunk).sum(dim=1,
                                              dtype=torch.int32).tolist()
        run = [v > 0 for v in live]
        if count_as is not None:
            ran = [b for b, r in zip(bounds, run) if r] or bounds[:1]
            count(count_as + ".slots", sum(hi - lo for lo, hi in ran))
            count(count_as + ".live", sum(live))

    def call(lo, hi):
        return tuple(fn(tuple(x[lo:hi] for x in xs)))

    if all(run):
        outs = [call(lo, hi) for lo, hi in bounds]
        with span("fipm.join"):
            return tuple(torch.cat([o[k] for o in outs], dim=0)
                         for k in range(len(outs[0])))
    # Dead chunks cost nothing: the outputs start as zeros (one fill each,
    # however many chunks are dead) and the alive chunks are copied in.
    alive = [(lo, hi, call(lo, hi))
             for (lo, hi), a in zip(bounds, run) if a]
    ref = alive[0][2] if alive else call(*bounds[0])
    with span("fipm.join"):
        full = tuple(y.new_zeros((n,) + y.shape[1:]) for y in ref)
        for lo, hi, o in alive:
            for f, y in zip(full, o):
                f[lo:hi] = y
    return full
