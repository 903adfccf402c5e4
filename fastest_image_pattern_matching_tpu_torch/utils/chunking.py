"""Chunked batch mapping to bound peak device memory.

The angle sweep and the candidate descent would otherwise materialise all
[A, Hc, Wc] canvases or [3C, h+6, w+6] ROIs at once. Here a chunk is one
iteration of a Python loop.
"""

from __future__ import annotations

import torch


def chunked_map(fn, xs, n: int, chunk: int, pred=None):
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
    """
    chunk = max(1, min(chunk, n))
    n_chunks = (n + chunk - 1) // chunk
    bounds = [(i * chunk, min(n, (i + 1) * chunk)) for i in range(n_chunks)]

    if pred is None:
        run = [True] * n_chunks
    else:
        pad = n_chunks * chunk - n
        p = torch.nn.functional.pad(pred.to(torch.int32), (0, pad))
        run = p.reshape(n_chunks, chunk).any(dim=1).tolist()

    def call(lo, hi):
        return tuple(fn(tuple(x[lo:hi] for x in xs)))

    if all(run):
        outs = [call(lo, hi) for lo, hi in bounds]
        return tuple(torch.cat([o[k] for o in outs], dim=0)
                     for k in range(len(outs[0])))
    # Dead chunks cost nothing: the outputs start as zeros (one fill each,
    # however many chunks are dead) and the alive chunks are copied in.
    alive = [(lo, hi, call(lo, hi))
             for (lo, hi), a in zip(bounds, run) if a]
    ref = alive[0][2] if alive else call(*bounds[0])
    full = tuple(y.new_zeros((n,) + y.shape[1:]) for y in ref)
    for lo, hi, o in alive:
        for f, y in zip(full, o):
            f[lo:hi] = y
    return full
