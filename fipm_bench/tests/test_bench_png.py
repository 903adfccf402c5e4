"""The benchmark's PNG writer read back through zlib alone: chunks, CRCs,
each row's filter (libpng's least sum of signed magnitudes, the earlier
filter on a tie) and the pixels."""

import struct
import zlib

import numpy as np
import pytest

from fipm_bench.scenes import png


def read_png(data: bytes):
    """(pixels, filter of each row, IDAT chunk sizes) of an 8-bit grey
    PNG, decoded with zlib and numpy."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, sizes, hdr = 8, b"", [], None
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(kind + body)
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
            sizes.append(n)
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    assert (depth, ctype) == (8, 0)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    out = np.zeros((h, w), np.int32)
    for y in range(h):
        f, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        up = out[y - 1] if y else np.zeros(w, np.int32)
        for x in range(w):
            a = out[y, x - 1] if x else 0
            b = up[x]
            c = up[x - 1] if (x and y) else 0
            pred = [0, a, b, (a + b) // 2, None][f]
            if f == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[y, x] = (row[x] + pred) & 0xFF
    return out.astype(np.uint8), raw[:, 0], sizes


def best_filters(img):
    """Each row's filter by libpng's rule, one row at a time."""
    h, w = img.shape
    x = img.astype(np.int32)
    best = []
    for y in range(h):
        a = np.concatenate([[0], x[y, :-1]])
        b = x[y - 1] if y else np.zeros(w, np.int32)
        c = np.concatenate([[0], b[:-1]])
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        sums = []
        for pred in (0, a, b, (a + b) // 2, paeth):
            v = (x[y] - pred) & 0xFF
            sums.append(int(np.minimum(v, 256 - v).sum()))
        best.append(int(np.argmin(sums)))
    return best


@pytest.mark.parametrize("kind", ["noise", "gradient", "flat", "bars"])
def test_png_round_trip(kind):
    rng = np.random.default_rng(3)
    h, w = 37, 53
    yy, xx = np.mgrid[:h, :w]
    img = {"noise": rng.integers(0, 256, (h, w)),
           "gradient": (3 * xx + 5 * yy) % 256,
           "flat": np.full((h, w), 77),
           "bars": np.where((xx // 4) % 2 == 0, 20, 230)
           + rng.integers(0, 3, (h, w))}[kind].astype(np.uint8)
    data = png.png_bytes(img)
    got, filters, sizes = read_png(data)
    np.testing.assert_array_equal(got, img)
    assert list(filters) == best_filters(img)
    if kind == "noise":
        assert len(set(filters.tolist())) >= 3
    assert all(s <= png.IDAT_BYTES for s in sizes)


def test_long_data_splits_into_idat_chunks():
    img = np.random.default_rng(4).integers(0, 256, (120, 200)).astype(
        np.uint8)
    got, _, sizes = read_png(png.png_bytes(img))
    np.testing.assert_array_equal(got, img)
    assert len(sizes) >= 3 and sizes[:-1] == [png.IDAT_BYTES] * (
        len(sizes) - 1)
