"""PNM (P1-P6) decode to the grey levels of OpenCV's cv2.imread(path,
IMREAD_GRAYSCALE), and binary PGM encode, with numpy alone.

OpenCV's PxM decoder, reproduced here:
  - the header is magic, width, height and (not for PBM) maxval, each
    number after whitespace and '#' comments, and the raster starts one
    byte after maxval's last digit; maxval above 255 means 16-bit samples;
  - ASCII samples above maxval read as maxval; 8-bit ASCII samples are
    scaled to v * 255 // maxval, binary ones are taken as they are;
  - 16-bit samples (big-endian in binary) become v >> 8;
  - PBM: 1 is black (0), 0 is white (255); P1 reads one digit a sample;
  - colour greys with OpenCV's 14-bit weights (4899 R + 9617 G + 1868 B
    + 8192) >> 14 on the 8-bit samples.
A truncated raster or a malformed header raises ValueError.
"""

from __future__ import annotations

import numpy as np

from . import gray14

_WS = b" \t\n\v\f\r"


def is_magic(head: bytes) -> bool:
    """True when `head`, a file's first bytes, starts a PNM (P1-P6 and whitespace)."""
    return (len(head) >= 3 and head[:1] == b"P" and head[1:2] in b"123456"
            and head[2:3] in _WS)


class _Reader:
    """OpenCV's ReadNumber over a byte string."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("PNM: unexpected end of file")
        c = self.data[self.pos]
        self.pos += 1
        return c

    def number(self, max_digits: int = 0) -> int:
        c = self.byte()
        while not 48 <= c <= 57:
            if c == 35:  # '#': skip to the end of the line
                while c not in (10, 13):
                    c = self.byte()
                c = self.byte()
            elif c in _WS:
                c = self.byte()
            else:
                raise ValueError(f"PNM: unexpected byte {c:#x}")
        val, digits = 0, 0
        while True:
            val = val * 10 + c - 48
            if val > 0x7FFFFFFF:
                raise ValueError("PNM: number too large")
            digits += 1
            if max_digits and digits >= max_digits:
                break
            c = self.byte()
            if not 48 <= c <= 57:
                break
        return val

    def ascii(self, n: int, max_digits: int = 0) -> np.ndarray:
        """n numbers; split on whitespace at once where the raster holds
        nothing but digits and whitespace."""
        if not max_digits:
            fields = self.data[self.pos:].split(None, n)[:n]
            if len(fields) == n and all(f.isdigit() for f in fields):
                return np.array(fields, np.int64)
        return np.array([self.number(max_digits) for _ in range(n)],
                        np.int64)


def read_gray(data: bytes) -> np.ndarray:
    """Decode P1-P6 bytes to 2-D u8 grey as cv2.imread(IMREAD_GRAYSCALE)
    does."""
    if not is_magic(data[:3]):
        raise ValueError("not a PNM file")
    kind = data[1] - 48
    rd = _Reader(data, 2)
    w, h = rd.number(), rd.number()
    maxval = 1 if kind in (1, 4) else rd.number()
    if not (w > 0 and h > 0 and 0 < maxval < 65536):
        raise ValueError(f"PNM: bad header {w}x{h}, maxval {maxval}")
    ch = 3 if kind in (3, 6) else 1
    n = w * h * ch
    if kind == 1:
        v = rd.ascii(w * h, max_digits=1)
        return np.where(v != 0, 0, 255).astype(np.uint8).reshape(h, w)
    if kind == 4:
        pitch = (w + 7) // 8
        raw = data[rd.pos:rd.pos + pitch * h]
        if len(raw) < pitch * h:
            raise ValueError("PNM: truncated raster")
        bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(h, pitch),
                             axis=1)[:, :w]
        return np.where(bits != 0, 0, 255).astype(np.uint8)
    wide = maxval > 255
    if kind in (2, 3):
        v = np.minimum(rd.ascii(n), maxval)
        v = v >> 8 if wide else v * 255 // maxval
    else:
        size = n * (2 if wide else 1)
        raw = data[rd.pos:rd.pos + size]
        if len(raw) < size:
            raise ValueError("PNM: truncated raster")
        v = np.frombuffer(raw, ">u2" if wide else np.uint8)
        if wide:
            v = v >> 8
    v = v.astype(np.uint8).reshape(h, w, ch)
    if ch == 1:
        return v[..., 0]
    v = v.astype(np.int64)
    return gray14(v[..., 0], v[..., 1], v[..., 2])


def encode_pgm(img: np.ndarray) -> bytes:
    """A 2-D u8 image as a binary PGM (P5, maxval 255)."""
    h, w = img.shape
    return b"P5\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(
        img, np.uint8).tobytes()
