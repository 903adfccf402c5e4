"""PNG decode to the grey levels of OpenCV's cv2.imread(path,
IMREAD_GRAYSCALE), and 8-bit grey PNG encode, with numpy and zlib alone.

OpenCV asks libpng to expand palettes to RGB and 1/2/4-bit grey to 8
bits, to strip alpha, to grey colour with png_set_rgb_to_gray(.., 0.299,
0.587) and to strip 16-bit samples to their high byte. So here:
  - grey: 1/2/4-bit v * 255 / (2**depth - 1), 8-bit v, 16-bit v >> 8;
  - colour, and a palette once expanded: libpng's 15-bit weights (9797,
    19234, 3737), truncated on 8-bit samples, rounded on 16-bit samples
    and then >> 8; a pixel with R = G = B passes through;
  - a file gamma (gAMA before PLTE, or sRGB) that differs from 1 by more
    than 5% makes libpng grey colour in linear light through its gamma
    tables, reproduced here (_Gamma);
  - an eXIf chunk's Orientation turns the image as imread turns it;
  - alpha, tRNS and every other ancillary chunk are dropped.
A critical chunk whose CRC fails, a truncated stream or too little image
data raises ValueError; an ancillary chunk whose CRC fails is skipped, as
libpng does. The filter loop runs in the native library
(native/decode.py) or, without g++, in _unfilter_py here (counted in
native/decode.py::FALLBACKS).
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

from ...native import decode as native_decode
from ..profiling import span
from . import exif_orientation, orient

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# png_set_rgb_to_gray(png, 1, 0.299, 0.587): (int)(c * 32768 / 100000).
_RC, _GC = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_BC = 32768 - _RC - _GC
_SRGB_GAMMA = 45455
_PNG_FP_1 = 100000


def is_magic(head: bytes) -> bool:
    """True when `head`, a file's first bytes, starts a PNG (its signature)."""
    return head[:8] == SIGNATURE


# ------------------------------------------------------------ unfiltering

def _unfilter_py(data: np.ndarray, rows: int, row_bytes: int,
                 bpp: int) -> np.ndarray:
    """The twin of native/decode.py::png_unfilter: Sub and Up in numpy,
    Average and Paeth byte by byte."""
    if data.size < rows * (row_bytes + 1):
        raise ValueError("PNG: not enough image data")
    src = data[:rows * (row_bytes + 1)].reshape(rows, row_bytes + 1)
    out = np.zeros((rows, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for y in range(rows):
        ft, raw = int(src[y, 0]), src[y, 1:]
        if ft == 0:
            cur = raw.copy()
        elif ft == 1:
            pad = (-row_bytes) % bpp
            r = np.concatenate([raw, np.zeros(pad, np.uint8)])
            cur = np.cumsum(r.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)[:row_bytes]
        elif ft == 2:
            cur = raw + prev
        elif ft in (3, 4):
            cur = bytearray(row_bytes)
            up = prev.tolist()
            for i, v in enumerate(raw.tolist()):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == 3:
                    cur[i] = (v + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (v + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter type in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def _unfilter(data: np.ndarray, rows: int, row_bytes: int,
              bpp: int) -> np.ndarray:
    if native_decode.available():
        return native_decode.png_unfilter(data, rows, row_bytes, bpp)
    return _unfilter_py(data, rows, row_bytes, bpp)


# ------------------------------------------------------------------ gamma

def _reciprocal(a: int) -> int:
    return int(math.floor(1e10 / a + .5))


def _product2(a: int, b: int) -> int:
    r = a * 1e-5
    r *= b
    return int(math.floor(r + .5))


def _significant(g: int) -> bool:
    return g < _PNG_FP_1 - 5000 or g > _PNG_FP_1 + 5000


def _table8(g: int) -> np.ndarray:
    """png_build_8bit_table."""
    if not _significant(g):
        return np.arange(256, dtype=np.int64)
    return np.array([v if v in (0, 255) else int(math.floor(
        255 * math.pow(v / 255., g * .00001) + .5)) for v in range(256)],
        np.int64)


def _table16(shift: int, g: int) -> np.ndarray:
    """png_build_16bit_table, flat over v >> shift."""
    top = (1 << (16 - shift)) - 1
    if _significant(g):
        fmax = 1.0 / top
        return np.array([int(math.floor(65535. * math.pow(
            ig * fmax, g * .00001) + .5)) for ig in range(top + 1)],
            np.int64)
    ig = np.arange(top + 1, dtype=np.int64)
    if shift:
        ig = (ig * 65535 + (1 << (15 - shift))) // top
    return ig


def _gamma16_correct(v: int, g: int) -> int:
    if 0 < v < 65535:
        return int(math.floor(65535 * math.pow(v / 65535., g * .00001)
                              + .5))
    return v


def _table16to8(shift: int, g: int) -> np.ndarray:
    """png_build_16to8_table, flat over v >> shift."""
    top = (1 << (16 - shift)) - 1
    table = np.full(top + 1, 65535, np.int64)
    last = 0
    for i in range(255):
        out = i * 257
        bound = (_gamma16_correct(out + 128, g) * top + 32768) // 65535 + 1
        table[last:bound] = out
        last = max(last, bound)
    return table


class _Gamma:
    """libpng's rgb-to-gray in linear light, for a file gamma `g` (1e5
    fixed point) that is significant: the screen gamma is its reciprocal
    (libpng's default), the samples go through gamma_to_1, are weighed
    with rounding, and come back through gamma_from_1; a pixel with R = G
    = B goes through gamma_table (16-bit: gamma_16_table) alone."""

    def __init__(self, g: int, depth: int, sig_bit: int):
        screen = _reciprocal(g)
        product = _product2(g, screen)
        to_1, from_1 = _reciprocal(g), _reciprocal(screen)
        if depth <= 8:
            self.shift = 0
            self.same = _table8(product)
            self.to_1, self.from_1 = _table8(to_1), _table8(from_1)
            return
        shift = 16 - sig_bit if 0 < sig_bit < 16 else 0
        # png_set_strip_16 keeps PNG_MAX_GAMMA_8 = 11 bits of the input.
        self.shift = min(max(shift, 16 - 11), 8)
        self.same = _table16to8(self.shift, product)
        self.to_1 = _table16(self.shift, to_1)
        self.from_1 = _table16(self.shift, from_1)

    def gray(self, r, g, b):
        s = self.shift
        lin = (_RC * self.to_1[r >> s] + _GC * self.to_1[g >> s]
               + _BC * self.to_1[b >> s] + 16384) >> 15
        out = self.from_1[lin >> s]
        same = (r == g) & (r == b)
        return np.where(same, self.same[r >> s], out)


def _png_rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """libpng's png_set_rgb_to_gray(.., 0.299, 0.587) on 8-bit RGB, which
    OpenCV's PNG decoder asks for: 15-bit weights (9797, 19234, 3737; they
    sum to 32768, so grey pixels pass through) and a truncating shift."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((_RC * r + _GC * g + _BC * b) >> 15).astype(np.uint8)


def _rgb_gray(rgb: np.ndarray, depth: int, gamma) -> np.ndarray:
    if gamma is None and depth == 8:
        return _png_rgb_to_gray(rgb)
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    if gamma is not None:
        v = gamma.gray(r, g, b)
    else:  # 16 bits: rounded, as libpng greys 16-bit samples
        v = (_RC * r + _GC * g + _BC * b + 16384) >> 15
    return (v >> 8 if depth == 16 else v).astype(np.uint8)


# ----------------------------------------------------------------- decode

def _chunks(data: bytes):
    """(type, payload) of every chunk up to IEND; critical chunks must pass
    their CRC, ancillary ones that fail it are skipped."""
    if not is_magic(data):
        raise ValueError("not a PNG file")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated before IEND")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + n
        if end > len(data):
            raise ValueError(f"PNG: truncated {kind!r} chunk")
        body = data[pos + 8:end - 4]
        crc = int.from_bytes(data[end - 4:end], "big")
        pos = end
        if zlib.crc32(kind + body) != crc:
            if kind[0] & 0x20 == 0:
                raise ValueError(f"PNG: CRC error in {kind!r}")
            continue
        yield kind, body
        if kind == b"IEND":
            return


def _samples(rows: np.ndarray, w: int, depth: int, ch: int) -> np.ndarray:
    """(h, row_bytes) unfiltered rows to (h, w, ch) samples."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, w, ch)
    if depth == 16:
        return rows.view(">u2").reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    v = np.zeros(bits.shape[:2], np.uint8)
    for k in range(depth):
        v = (v << 1) | bits[..., k]
    return v[:, :w, None]


def read_gray(data: bytes) -> np.ndarray:
    """Decode PNG bytes to 2-D u8 grey as cv2.imread(IMREAD_GRAYSCALE)
    does; raises ValueError on a malformed, corrupt or truncated file."""
    with span("fipm.decode.inflate"):
        head, raw = _inflate(data)
    header, palette, gamma, srgb, sig_bit, orientation = head
    w, h, depth, ctype = header[:4]
    ch = _CHANNELS[ctype]
    bitspp = depth * ch
    bpp = max(1, bitspp // 8)
    passes = _passes(header)
    buf = np.frombuffer(raw, np.uint8)
    with span("fipm.decode.unfilter"):
        pos, rows = 0, []
        for (x0, y0, dx, dy), (ph, pw) in passes:
            row_bytes = (pw * bitspp + 7) // 8
            n = ph * (row_bytes + 1)
            rows.append(_unfilter(buf[pos:pos + n], ph, row_bytes, bpp))
            pos += n
    with span("fipm.decode.grey"):
        img = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        for ((x0, y0, dx, dy), (ph, pw)), r in zip(passes, rows):
            img[y0::dy, x0::dx] = _samples(r, pw, depth, ch)
        return _grey(img, depth, ctype, palette, gamma, srgb, sig_bit,
                     orientation)


def _passes(header):
    """The (x0, y0, dx, dy) and (rows, columns) of each non-empty pass."""
    w, h, interlace = header[0], header[1], header[6]
    passes = (_ADAM7 if interlace else ((0, 0, 1, 1),))
    shapes = [((h - y0 + dy - 1) // dy, (w - x0 + dx - 1) // dx)
              for x0, y0, dx, dy in passes]
    return [(p, s) for p, s in zip(passes, shapes) if s[0] and s[1]]


def _inflate(data: bytes):
    """The chunks checked and the image data inflated: -> ((IHDR fields,
    palette, gAMA, sRGB, sBIT, orientation), the filtered rows' bytes)."""
    header, palette, idat = None, None, []
    gamma, srgb, sig_bit, orientation = None, False, 0, 1
    for kind, body in _chunks(data):
        if header is None:
            if kind != b"IHDR" or len(body) != 13:
                raise ValueError("PNG: IHDR is not the first chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3 or not 0 < len(body) <= 768:
                raise ValueError("PNG: bad PLTE length")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            orientation = exif_orientation(body)
        elif not idat and palette is None:
            if kind == b"gAMA" and len(body) == 4:
                g = int.from_bytes(body, "big")
                if 16 <= g <= 625000000 and gamma is None:
                    gamma = g  # libpng ignores a duplicate
            elif kind == b"sRGB" and len(body) == 1:
                srgb = True
            elif kind == b"sBIT":
                sig_bit = max(body) if body else 0
    if header is None:
        raise ValueError("PNG: no IHDR")
    w, h, depth, ctype, comp, filt, interlace = header
    if (ctype not in _DEPTHS or depth not in _DEPTHS[ctype] or comp
            or filt or interlace > 1 or not w or not h
            or w > 0x7FFFFFFF or h > 0x7FFFFFFF):
        raise ValueError(f"PNG: unsupported header {header}")
    if ctype == 3 and palette is None:
        raise ValueError("PNG: palette image without PLTE")
    if not idat:
        raise ValueError("PNG: no IDAT")
    bitspp = depth * _CHANNELS[ctype]
    need = sum(ph * ((pw * bitspp + 7) // 8 + 1)
               for _, (ph, pw) in _passes(header))
    try:
        d = zlib.decompressobj()
        raw = d.decompress(b"".join(idat), need)
    except zlib.error as e:
        raise ValueError(f"PNG: corrupt IDAT stream: {e}") from None
    if len(raw) < need:
        raise ValueError("PNG: not enough image data")
    return (header, palette, gamma, srgb, sig_bit, orientation), raw


def _grey(img, depth, ctype, palette, gamma, srgb, sig_bit, orientation):
    """The samples (h, w, ch) to grey as libpng and OpenCV make it."""
    if ctype in (0, 4):
        grey = img[..., 0]
        if depth < 8:
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        elif depth == 16:
            grey = (grey >> 8).astype(np.uint8)
        return orient(grey, orientation)
    file_gamma = _SRGB_GAMMA if srgb else gamma
    lut = (_Gamma(file_gamma, depth, sig_bit)
           if file_gamma is not None and _significant(file_gamma) else None)
    if ctype == 3:
        # Each palette entry greyed once; indices past PLTE read black.
        pal = np.zeros((1, 256, 3), np.uint8)
        pal[0, :len(palette)] = palette
        return orient(_rgb_gray(pal, 8, lut)[0][img[..., 0]], orientation)
    return orient(_rgb_gray(img, depth, lut), orientation)


# ----------------------------------------------------------------- encode

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_gray8(img: np.ndarray) -> bytes:
    """A 2-D u8 image as an 8-bit grey PNG (filter None, zlib's default
    level)."""
    h, w = img.shape
    rows = np.zeros((h, w + 1), np.uint8)
    rows[:, 1:] = img
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))
