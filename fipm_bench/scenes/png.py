"""An 8-bit grey PNG writer that filters and deflates as libpng's
defaults do: each row takes the filter of the five (None, Sub, Up,
Average, Paeth) whose bytes, read as signed, have the least sum of
absolute values (the earlier filter on a tie), and the rows are deflated
by zlib at level 6 with the Z_FILTERED strategy, in IDAT chunks of 8192
bytes. numpy and zlib only."""

from __future__ import annotations

import struct
import zlib

import numpy as np

IDAT_BYTES = 8192


# A filtered byte's share of a row's sum: its magnitude read as signed.
_COST = np.minimum(np.arange(256), 256 - np.arange(256)).astype(np.uint16)


def _filtered_rows(img: np.ndarray) -> np.ndarray:
    """[h, 1 + w] u8: each row's filter type and its filtered bytes (the
    byte arithmetic wraps modulo 256, as the format's does)."""
    h, w = img.shape
    a = np.zeros_like(img)
    a[:, 1:] = img[:, :-1]
    b = np.zeros_like(img)
    b[1:] = img[:-1]
    c = np.zeros_like(img)
    c[1:, 1:] = img[:-1, :-1]
    ai, bi, ci = (v.astype(np.int16) for v in (a, b, c))
    p = ai + bi - ci
    pa, pb, pc = np.abs(p - ai), np.abs(p - bi), np.abs(p - ci)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    avg = ((ai + bi) >> 1).astype(np.uint8)
    rows = np.empty((h, w + 1), np.uint8)
    best = None
    for f, pred in enumerate((None, a, b, avg, paeth)):
        cand = img if pred is None else img - pred
        cost = _COST[cand].sum(axis=1, dtype=np.uint32)
        # The earlier filter keeps a tie.
        take = np.ones(h, bool) if best is None else cost < best
        best = cost if best is None else np.where(take, cost, best)
        rows[take, 0] = f
        rows[take, 1:] = cand[take]
    return rows


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def png_bytes(img: np.ndarray, level: int = 6) -> bytes:
    """The PNG file of a 2-D u8 image."""
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"expected a 2-D u8 image, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape
    z = zlib.compressobj(level, zlib.DEFLATED, 15, 8, zlib.Z_FILTERED)
    data = z.compress(_filtered_rows(img).tobytes()) + z.flush()
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))]
    out += [_chunk(b"IDAT", data[i:i + IDAT_BYTES])
            for i in range(0, len(data), IDAT_BYTES)]
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img, level))


SUFFIX = ".png"


def write(path: str, img, spec: dict) -> None:
    """The writer of a traffic's "file" spec {"format": "png", "level":
    zlib level}."""
    write_png(path, img, spec.get("level", 6))
