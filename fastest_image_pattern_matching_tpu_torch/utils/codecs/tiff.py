"""Baseline TIFF decode to the grey levels of OpenCV's cv2.imread(path,
IMREAD_GRAYSCALE), with numpy and zlib alone.

For 8-bit output OpenCV reads every TIFF through libtiff's RGBA image
(TIFFReadRGBAStrip / Tile) and greys it with its 14-bit weights
(4899 R + 9617 G + 1868 B + 8192) >> 14. Reproduced here:
  - grey (MinIsBlack, MinIsWhite inverted): 1-bit 0 or 255, 8-bit v,
    16-bit v >> 8; extra samples are ignored;
  - RGB: 16-bit channels to (c * 255 + 32767) // 65535 first;
    unassociated alpha (ExtraSamples 2) premultiplies as
    (c * a + 127) // 255, associated or unspecified alpha is left as
    stored;
  - palette (1, 4 or 8 bits): a colour map whose entries are all below 256
    is taken as 8-bit, else each entry is >> 8;
  - Orientation 1-4 flips the image as imread does (5-8 it refuses).
Read: little- and big-endian files, strips and tiles, compression none,
PackBits, LZW and Adobe Deflate (8, 32946), Predictor 1 and 2, contiguous
planar configuration, unsigned integer samples of 1, 8 and 16 bits, and
4-bit palettes (imread refuses 2 bits, and 4 bits but for a palette). Anything else raises
Unsupported naming its tag, which load_gray routes to PIL (counted in
PIL_ROUTES); a file imread refuses raises ValueError, and so does a
truncated strip or a corrupt stream, where imread hands back a partial
image (zeros from where libtiff stopped). The LZW, PackBits and predictor loops
run in the native library (native/decode.py) or, without g++, in their
twins here (counted in native/decode.py::FALLBACKS).
"""

from __future__ import annotations

import struct
import threading
import zlib

import numpy as np

from ...native import decode as native_decode
from . import gray14, orient

# TIFFs routed to PIL because they use a feature outside the list above.
PIL_ROUTES = 0
_LOCK = threading.Lock()

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 13: 4}
_TYPE_CODE = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h",
              9: "i", 11: "f", 12: "d", 13: "I"}
_COMPRESSION = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate",
                32773: "PackBits"}


class Unsupported(Exception):
    """A TIFF feature outside this reader's list; the message names the
    tag and its value."""


def is_magic(head: bytes) -> bool:
    """True when `head`, a file's first bytes, starts a TIFF (II*\\0, MM\\0*, or BigTIFF's +)."""
    return head[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")


def count_pil_route() -> None:
    global PIL_ROUTES
    with _LOCK:
        PIL_ROUTES += 1


# ------------------------------------------------------------------ twins

def _lzw_py(data: bytes, size: int) -> np.ndarray:
    """The twin of native/decode.py::lzw_decode."""
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    total = len(data) * 8
    src = bytes(data) + b"\x00\x00\x00"
    bitpos, nbits, old = 0, 9, None
    while len(out) < size and bitpos + nbits <= total:
        i = bitpos >> 3
        word = (src[i] << 16) | (src[i + 1] << 8) | src[i + 2]
        code = (word >> (24 - nbits - (bitpos & 7))) & ((1 << nbits) - 1)
        bitpos += nbits
        if code == 256:
            table, nbits, old = table[:258], 9, None
            continue
        if code == 257:
            break
        if old is None:
            if code > 255:
                raise ValueError("TIFF: corrupt LZW code")
            out.append(code)
            old = table[code]
            continue
        if code < len(table):
            s = table[code]
        elif code == len(table) and code < 4096:
            s = old + old[:1]
        else:
            raise ValueError("TIFF: corrupt LZW code")
        out += s
        if len(table) < 4096:
            table.append(old + s[:1])
            if len(table) >= (1 << nbits) - 1 and nbits < 12:
                nbits += 1
        old = s
    return np.frombuffer(bytes(out[:size]), np.uint8)


def _packbits_py(data: bytes, size: int) -> np.ndarray:
    """The twin of native/decode.py::packbits_decode."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < size:
        c = data[i] - 256 if data[i] > 127 else data[i]
        i += 1
        if c >= 0:
            if i + c + 1 > n:
                break
            out += data[i:i + c + 1]
            i += c + 1
        elif c != -128:
            if i >= n:
                break
            out += bytes([data[i]]) * (1 - c)
            i += 1
    return np.frombuffer(bytes(out[:size]), np.uint8)


def _unpredict_np(a: np.ndarray) -> None:
    """The twin of native/decode.py::unpredict (in place)."""
    np.cumsum(a, axis=1, dtype=a.dtype, out=a)


def _lzw(data: bytes, size: int) -> np.ndarray:
    if native_decode.available():
        return native_decode.lzw_decode(data, size)
    return _lzw_py(data, size)


def _packbits(data: bytes, size: int) -> np.ndarray:
    if native_decode.available():
        return native_decode.packbits_decode(data, size)
    return _packbits_py(data, size)


def _unpredict(a: np.ndarray) -> None:
    if native_decode.available():
        native_decode.unpredict(a)
    else:
        _unpredict_np(a)


# ----------------------------------------------------------------- header

def _ifd(data: bytes):
    """The first IFD's entries as {tag: tuple of values}, and the byte
    order ('<' or '>')."""
    order = "<" if data[:2] == b"II" else ">"
    if data[2:4] in (b"+\x00", b"\x00+"):
        raise Unsupported("BigTIFF (version 43)")
    if len(data) < 8:
        raise ValueError("TIFF: truncated header")
    off = struct.unpack(order + "I", data[4:8])[0]
    if off + 2 > len(data):
        raise ValueError("TIFF: IFD offset past the end of the file")
    n = struct.unpack(order + "H", data[off:off + 2])[0]
    if off + 2 + 12 * n > len(data):
        raise ValueError("TIFF: truncated IFD")
    tags = {}
    for k in range(n):
        e = off + 2 + 12 * k
        tag, typ, count = struct.unpack(order + "HHI", data[e:e + 8])
        if typ not in _TYPE_SIZE:
            continue  # libtiff skips entries of unknown type
        size = _TYPE_SIZE[typ] * count
        if size <= 4:
            raw = data[e + 8:e + 8 + size]
        else:
            at = struct.unpack(order + "I", data[e + 8:e + 12])[0]
            raw = data[at:at + size]
            if len(raw) < size:
                raise ValueError(f"TIFF: tag {tag} past the end of the file")
        if typ in (5, 10):
            v = struct.unpack(f"{order}{2 * count}{'I' if typ == 5 else 'i'}",
                              raw)
            tags[tag] = tuple(a / b if b else 0.0
                              for a, b in zip(v[::2], v[1::2]))
        else:
            tags[tag] = struct.unpack(f"{order}{count}{_TYPE_CODE[typ]}", raw)
    return tags, order


def _one(tags, tag, default=None):
    v = tags.get(tag)
    if not v:
        if default is None:
            raise ValueError(f"TIFF: required tag {tag} missing")
        return default
    return v[0]


# ----------------------------------------------------------------- decode

def _decompress(chunk: bytes, compression: int, size: int) -> np.ndarray:
    if compression == 1:
        out = np.frombuffer(chunk[:size], np.uint8)
    elif compression == 5:
        if chunk[:1] == b"\x00" and chunk[1:2] and chunk[1] & 1:
            raise Unsupported("Compression 5 in the old-style (LSB-first) "
                              "LZW code order")
        out = _lzw(chunk, size)
    elif compression == 32773:
        out = _packbits(chunk, size)
    else:
        try:
            out = np.frombuffer(zlib.decompressobj().decompress(chunk, size),
                                np.uint8)
        except zlib.error as e:
            raise ValueError(f"TIFF: corrupt Deflate stream: {e}") from None
    if out.size < size:
        raise ValueError(f"TIFF: not enough data in a strip or tile "
                         f"({out.size} of {size} bytes)")
    return out


def _samples(buf: np.ndarray, rows: int, cols: int, spp: int, bps: int,
             order: str, predictor: int) -> np.ndarray:
    """A decompressed strip or tile to (rows, cols, spp) samples: u8 for
    8 bits and fewer, native-order u16 for 16 bits."""
    if bps == 16:
        a = buf.view(order + "u2").reshape(rows, cols, spp).astype(np.uint16)
    elif bps == 8:
        a = buf.reshape(rows, cols, spp).copy()
    else:
        row_bytes = (cols * spp * bps + 7) // 8
        bits = np.unpackbits(buf.reshape(rows, row_bytes), axis=1)
        bits = bits[:, :cols * spp * bps].reshape(rows, cols * spp, bps)
        a = np.zeros((rows, cols * spp), np.uint8)
        for k in range(bps):
            a = (a << 1) | bits[..., k]
        return a.reshape(rows, cols, spp)
    if predictor == 2:
        _unpredict(a)
    return a


def _raster(data: bytes, tags, order: str, w: int, h: int, spp: int,
            bps: int, compression: int, predictor: int) -> np.ndarray:
    dtype = np.uint16 if bps == 16 else np.uint8
    img = np.empty((h, w, spp), dtype)
    tiled = 322 in tags
    if tiled:
        tw, tl = _one(tags, 322), _one(tags, 323)
        offsets, counts = tags.get(324, ()), tags.get(325, ())
        across = (w + tw - 1) // tw
        n = across * ((h + tl - 1) // tl)
        boxes = [((t // across) * tl, (t % across) * tw, tl, tw)
                 for t in range(n)]
    else:
        rps = min(_one(tags, 278, 0xFFFFFFFF), h)
        offsets, counts = tags.get(273, ()), tags.get(279, ())
        n = (h + rps - 1) // rps
        boxes = [(s * rps, 0, min(rps, h - s * rps), w) for s in range(n)]
    if len(offsets) < n or len(counts) < n:
        raise ValueError(f"TIFF: {len(offsets)} offsets and {len(counts)} "
                         f"byte counts for {n} strips or tiles")
    for (y0, x0, rows, cols), off, cnt in zip(boxes, offsets, counts):
        size = rows * ((cols * spp * bps + 7) // 8)
        a = _samples(_decompress(data[off:off + cnt], compression, size),
                     rows, cols, spp, bps, order, predictor)
        img[y0:y0 + rows, x0:x0 + cols] = a[:h - y0, :w - x0]
    return img


def read_gray(data: bytes) -> np.ndarray:
    """Decode TIFF bytes to 2-D u8 grey as cv2.imread(IMREAD_GRAYSCALE)
    does. Raises Unsupported for a feature outside this reader's list,
    ValueError for a malformed, refused, truncated or corrupt file."""
    if not is_magic(data[:4]):
        raise ValueError("not a TIFF file")
    tags, order = _ifd(data)
    w, h = _one(tags, 256), _one(tags, 257)
    spp = _one(tags, 277, 1)
    bps = _one(tags, 258, 1)
    compression = _one(tags, 259, 1)
    photometric = _one(tags, 262, 1 if spp < 3 else 2)
    predictor = _one(tags, 317, 1)
    for tag, name, ok in ((259, "Compression", compression in _COMPRESSION),
                          (262, "PhotometricInterpretation",
                           photometric in (0, 1, 2, 3)),
                          (284, "PlanarConfiguration",
                           spp == 1 or _one(tags, 284, 1) == 1),
                          (317, "Predictor", predictor in (1, 2)),
                          (339, "SampleFormat",
                           set(tags.get(339, (1,))) == {1}),
                          (266, "FillOrder", _one(tags, 266, 1) == 1)):
        if not ok:
            raise Unsupported(f"tag {tag} ({name}) = {tags[tag][0]}")
    if (bps == 2 or (bps == 4 and photometric != 3) or not w or not h
            or not spp):
        raise ValueError(f"TIFF: {bps} bits a sample, {w}x{h}x{spp} "
                         "(imread refuses 2 bits, and 4 but for a palette)")
    if bps not in (1, 4, 8, 16):
        raise Unsupported(f"tag 258 (BitsPerSample) = {bps}")
    if predictor == 2 and bps < 8:
        raise ValueError("TIFF: Predictor 2 with fewer than 8 bits a sample")
    if photometric == 2 and (spp < 3 or bps < 8):
        raise ValueError(f"TIFF: RGB with {spp} samples of {bps} bits")
    if photometric == 3 and (bps > 8 or 320 not in tags):
        raise ValueError("TIFF: palette of more than 8 bits or no ColorMap")
    if photometric in (0, 1, 3) and bps < 8 and spp != 1:
        raise ValueError("TIFF: sub-byte samples with extra samples")
    orientation = _one(tags, 274, 1)
    if not 1 <= orientation <= 4:
        raise ValueError(f"TIFF: Orientation {orientation} (imread reads "
                         "1 to 4)")
    img = _raster(data, tags, order, w, h, spp, bps, compression, predictor)
    return orient(_gray(img, tags, photometric, bps, spp), orientation)


def _gray(img: np.ndarray, tags, photometric: int, bps: int,
          spp: int) -> np.ndarray:
    """(h, w, spp) samples to grey through libtiff's RGBA image."""
    if photometric in (0, 1):
        v = img[..., 0]
        if bps == 16:
            v = (v >> 8).astype(np.uint8)
        elif bps == 1:
            v = v * np.uint8(255)
        return 255 - v if photometric == 0 else v
    if photometric == 3:
        cmap = np.array(tags[320], np.int64)
        n = 1 << bps
        if cmap.size < 3 * n:
            raise ValueError("TIFF: ColorMap too short")
        cmap = cmap[:3 * n].reshape(3, n)
        if cmap.max() >= 256:
            cmap = cmap >> 8
        return gray14(cmap[0], cmap[1], cmap[2])[img[..., 0]]
    rgb = img[..., :3].astype(np.int64)
    if bps == 16:
        rgb = (rgb * 255 + 32767) // 65535
    extra = tags.get(338, ())
    if spp >= 4 and extra[:1] == (2,):
        a = img[..., 3].astype(np.int64)
        if bps == 16:
            a = (a * 255 + 32767) // 65535
        rgb = (rgb * a[..., None] + 127) // 255
    return gray14(rgb[..., 0], rgb[..., 1], rgb[..., 2])
