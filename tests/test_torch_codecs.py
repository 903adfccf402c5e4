"""The port's PNG, PNM and TIFF readers (utils/codecs/) against the JAX
package's load_gray, which decodes with cv2.imread(IMREAD_GRAYSCALE); the
native decode loops against their Python twins; corrupt files; the
writers of save_gray.

Files are made from a numpy seed. cv2 writes what it can, PIL what cv2
cannot (palettes with tRNS, 1/2/4-bit PNG, grey + alpha, bilevel TIFF);
the writers here make the variants neither writes (Adam7 interlace, every
PNG filter type, gAMA / sRGB / sBIT, big-endian and tiled TIFF, PackBits
and LZW in strips and tiles, MinIsWhite, odd PNM maxvals). Each case is
held at 0 differing pixels against the JAX package where cv2 imports,
and decoded again with PIL hidden, where it must give the same array.
"""

import gc
import os
import struct
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from fastest_image_pattern_matching_tpu.utils import imageio as jio

from fastest_image_pattern_matching_tpu_torch.native import decode as ndec
from fastest_image_pattern_matching_tpu_torch.utils import imageio as tio
from fastest_image_pattern_matching_tpu_torch.utils import sources as tsrc
from fastest_image_pattern_matching_tpu_torch.utils.codecs import png, tiff

torch.set_num_threads(1)

H, W = 29, 43


# ---------------------------------------------------------------- writers

def _filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """PNG-filter (h, row_bytes) u8 rows, row y with filters[y % n]."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        ft = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        out.append(bytes([ft]) + ((row - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _pack_rows(img: np.ndarray, depth: int, order: str = ">") -> np.ndarray:
    """(h, w, ch) samples to (h, row_bytes) u8 rows, MSB first."""
    h, w, ch = img.shape
    if depth == 16:
        return img.astype(order + "u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return img.astype(np.uint8).reshape(h, -1)
    v = img.reshape(h, w * ch).astype(np.uint8)
    bits = np.stack([(v >> (depth - 1 - k)) & 1 for k in range(depth)], -1)
    return np.packbits(bits.reshape(h, -1), axis=1)


def png_bytes(img, depth, ctype, palette=None, trns=None, interlace=False,
              chunks=(), late_chunks=(), filters=(0, 1, 2, 3, 4)):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    bpp = max(1, depth * ch // 8)
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
              (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)) if interlace else (
                  (0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = img[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(_pack_rows(sub, depth), bpp, filters)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    out = png.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    for kind, body in chunks:
        out += chunk(kind, body)
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    for kind, body in late_chunks:
        out += chunk(kind, body)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: Clear first, MSB-first codes, the
    width growing one code early, Clear when the table is full, EOI."""
    out, acc, nacc = bytearray(), 0, 0

    def emit(code, nbits):
        nonlocal acc, nacc
        acc, nacc = (acc << nbits) | code, nacc + nbits
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8
        acc &= (1 << nacc) - 1

    def fresh():
        return {bytes([i]): i for i in range(256)}, 258, 9
    table, nxt, nbits = fresh()
    emit(256, 9)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        emit(table[w], nbits)
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:
            emit(256, nbits)
            table, nxt, nbits = fresh()
        elif nxt > (1 << nbits) - 1:
            nbits += 1
        w = bytes([b])
    if w:
        emit(table[w], nbits)
        if nxt + 1 > (1 << nbits) - 1:
            nbits += 1
    emit(257, nbits)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_bytes(img, bps, photometric, order="<", compression=1,
               predictor=1, tile=None, rps=None, extra=None, cmap=None,
               tags=()):
    """A one-IFD TIFF of (h, w, spp) unsigned samples."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, spp = img.shape
    if tile:
        tw, tl = tile
        boxes = [(y, x, tl, tw) for y in range(0, h, tl)
                 for x in range(0, w, tw)]
    else:
        rps = rps or h
        boxes = [(y, 0, min(rps, h - y), w) for y in range(0, h, rps)]
    chunks = []
    for y, x, rows, cols in boxes:
        block = np.zeros((rows, cols, spp), np.int64)
        part = img[y:y + rows, x:x + cols]
        block[:part.shape[0], :part.shape[1]] = part
        if predictor == 2:
            block[:, 1:] -= block[:, :-1].copy()
            block &= (1 << bps) - 1
        raw = _pack_rows(block, bps, order).tobytes()
        chunks.append({1: lambda b: b, 5: lzw_encode, 8: zlib.compress,
                       32946: zlib.compress, 32773: packbits_encode}[
                           compression](raw))
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp),
               259: (3, [compression]), 262: (3, [photometric]),
               277: (3, [spp]), 284: (3, [1])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra is not None:
        entries[338] = (3, list(extra))
    if cmap is not None:
        entries[320] = (3, list(np.asarray(cmap).reshape(-1)))
    for tag, typ, vals in tags:
        entries[tag] = (typ, list(vals))
    data_off = 8
    body = b"".join(chunks)
    offsets = np.cumsum([0] + [len(c) for c in chunks[:-1]]) + data_off
    if tile:
        entries[322], entries[323] = (3, [tile[0]]), (3, [tile[1]])
        entries[324] = (4, list(offsets))
        entries[325] = (4, [len(c) for c in chunks])
    else:
        entries[278] = (4, [rps])
        entries[273] = (4, list(offsets))
        entries[279] = (4, [len(c) for c in chunks])
    ifd_off = data_off + len(body) + (len(body) & 1)
    codes = {3: "H", 4: "I", 12: "d"}
    extra_at = ifd_off + 2 + 12 * len(entries) + 4
    ifd, tail = b"", b""
    for tag in sorted(entries):
        typ, vals = entries[tag]
        raw = struct.pack(f"{order}{len(vals)}{codes[typ]}",
                          *[int(v) if typ != 12 else v for v in vals])
        if len(raw) <= 4:
            field = raw.ljust(4, b"\0")
        else:
            field = struct.pack(order + "I", extra_at + len(tail))
            tail += raw + (b"\0" if len(raw) & 1 else b"")
        ifd += struct.pack(order + "HHI", tag, typ, len(vals)) + field
    head = (b"II*\x00" if order == "<" else b"MM\x00*") + struct.pack(
        order + "I", ifd_off)
    return (head + body + (b"\0" if len(body) & 1 else b"")
            + struct.pack(order + "H", len(entries)) + ifd
            + struct.pack(order + "I", 0) + tail)


def pnm_bytes(kind, img, maxval, comment=False):
    img = np.asarray(img)
    h, w = img.shape[:2]
    head = b"P%d\n" % kind + (b"# a comment\n" if comment else b"")
    head += b"%d %d\n" % (w, h) + (b"" if kind in (1, 4) else
                                   b"%d\n" % maxval)
    if kind == 1:
        return head + b"\n".join(b"".join(b"%d" % v for v in r)
                                 for r in img) + b"\n"
    if kind == 4:
        return head + np.packbits(img.astype(np.uint8), axis=1).tobytes()
    if kind in (2, 3):
        return head + b"\n".join(b" ".join(b"%d" % v for v in r.reshape(-1))
                                 for r in img) + b"\n"
    return head + img.astype(">u2" if maxval > 255 else np.uint8).tobytes()


# ------------------------------------------------------------------ cases

def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _rgb(rng, top):
    """Colour noise with a band of grey (R = G = B) pixels, which libpng
    passes through on their own path."""
    a = rng.integers(0, top + 1, (H, W, 3))
    a[3:6, :, 1] = a[3:6, :, 2] = a[3:6, :, 0]
    return a


def _cv2_write(path, img, params=()):
    import cv2
    assert cv2.imwrite(path, img, list(params))


def _pil(img, mode=None):
    from PIL import Image
    return Image.fromarray(img, mode) if mode else Image.fromarray(img)


def _gamma(v):
    return [(b"gAMA", struct.pack(">I", v))]


def _exif(o):
    from PIL import Image
    ex = Image.Exif()
    ex[274] = o
    return ex.tobytes()


def _own(ext, make):
    def case(path, rng):
        with open(path + ext, "wb") as f:
            f.write(make(rng))
        return path + ext
    return case


def _by(ext, write):
    def case(path, rng):
        write(path + ext, rng)
        return path + ext
    return case


def _palette_png(bits, trns):
    def write(p, rng):
        idx = rng.integers(0, 1 << bits, (H, W)).astype(np.uint8)
        im = _pil(idx, "P")
        im.putpalette(rng.integers(0, 256, 3 << bits).astype(
            np.uint8).tobytes())
        kw = {"bits": bits} if bits < 8 else {}
        if trns:
            kw["transparency"] = bytes(rng.integers(0, 256, 1 << bits)
                                       .astype(np.uint8))
        im.save(p, **kw)
    return write


CASES = {
    # PNG: grey of every depth, every filter type
    "png_grey1": _own(".png", lambda r: png_bytes(
        r.integers(0, 2, (H, W)), 1, 0)),
    "png_grey2": _own(".png", lambda r: png_bytes(
        r.integers(0, 4, (H, W)), 2, 0)),
    "png_grey4": _own(".png", lambda r: png_bytes(
        r.integers(0, 16, (H, W)), 4, 0)),
    "png_grey8_cv2": _by(".png", lambda p, r: _cv2_write(
        p, r.integers(0, 256, (H, W)).astype(np.uint8))),
    "png_grey16_cv2": _by(".png", lambda p, r: _cv2_write(
        p, r.integers(0, 65536, (H, W)).astype(np.uint16))),
    "png_grey16_filters": _own(".png", lambda r: png_bytes(
        r.integers(0, 65536, (H, W)), 16, 0)),
    "png_grey_alpha8_pil": _by(".png", lambda p, r: _pil(
        r.integers(0, 256, (H, W, 2)).astype(np.uint8), "LA").save(p)),
    "png_grey_alpha16": _own(".png", lambda r: png_bytes(
        r.integers(0, 65536, (H, W, 2)), 16, 4)),
    # PNG: colour, 8 and 16 bits, with and without alpha
    "png_rgb8_cv2": _by(".png", lambda p, r: _cv2_write(
        p, _rgb(r, 255).astype(np.uint8))),
    "png_rgb8_filters": _own(".png", lambda r: png_bytes(
        _rgb(r, 255), 8, 2)),
    "png_rgb16_cv2": _by(".png", lambda p, r: _cv2_write(
        p, _rgb(r, 65535).astype(np.uint16))),
    "png_rgba8_cv2": _by(".png", lambda p, r: _cv2_write(
        p, np.concatenate([_rgb(r, 255), r.integers(0, 256, (H, W, 1))],
                          2).astype(np.uint8))),
    "png_rgba16_filters": _own(".png", lambda r: png_bytes(
        np.concatenate([_rgb(r, 65535), r.integers(0, 65536, (H, W, 1))],
                       2), 16, 6)),
    # PNG: palettes (expanded before the grey), tRNS dropped
    "png_palette1_trns_pil": _by(".png", _palette_png(1, True)),
    "png_palette2_trns_pil": _by(".png", _palette_png(2, True)),
    "png_palette4_pil": _by(".png", _palette_png(4, False)),
    "png_palette8_trns_pil": _by(".png", _palette_png(8, True)),
    "png_palette_short": _own(".png", lambda r: png_bytes(
        r.integers(0, 8, (H, W)), 4, 3,
        palette=r.integers(0, 256, (5, 3)))),
    # PNG: Adam7
    "png_adam7_grey1": _own(".png", lambda r: png_bytes(
        r.integers(0, 2, (H, W)), 1, 0, interlace=True)),
    "png_adam7_grey8": _own(".png", lambda r: png_bytes(
        r.integers(0, 256, (H, W)), 8, 0, interlace=True)),
    "png_adam7_rgb16": _own(".png", lambda r: png_bytes(
        _rgb(r, 65535), 16, 2, interlace=True)),
    "png_adam7_palette4": _own(".png", lambda r: png_bytes(
        r.integers(0, 16, (H, W)), 4, 3, interlace=True,
        palette=r.integers(0, 256, (16, 3)))),
    "png_adam7_tiny": _own(".png", lambda r: png_bytes(
        r.integers(0, 256, (3, 2, 3)), 8, 2, interlace=True)),
    # PNG: file gamma (libpng greys colour in linear light)
    "png_rgb8_gama45455": _own(".png", lambda r: png_bytes(
        _rgb(r, 255), 8, 2, chunks=_gamma(45455))),
    "png_rgb8_srgb": _own(".png", lambda r: png_bytes(
        _rgb(r, 255), 8, 2, chunks=[(b"sRGB", b"\0")])),
    "png_rgb8_gama97000": _own(".png", lambda r: png_bytes(
        _rgb(r, 255), 8, 2, chunks=_gamma(97000))),
    "png_rgb8_gama220000": _own(".png", lambda r: png_bytes(
        _rgb(r, 255), 8, 2, chunks=_gamma(220000))),
    "png_rgba8_gama45455": _own(".png", lambda r: png_bytes(
        np.concatenate([_rgb(r, 255), r.integers(0, 256, (H, W, 1))], 2),
        8, 6, chunks=_gamma(45455))),
    "png_rgb16_gama45455": _own(".png", lambda r: png_bytes(
        _rgb(r, 65535), 16, 2, chunks=_gamma(45455))),
    "png_rgb16_srgb_sbit12": _own(".png", lambda r: png_bytes(
        _rgb(r, 65535), 16, 2,
        chunks=[(b"sRGB", b"\0"), (b"sBIT", b"\x0c\x0c\x0c")])),
    "png_rgb16_gama_sbit7": _own(".png", lambda r: png_bytes(
        _rgb(r, 65535), 16, 2,
        chunks=_gamma(30000) + [(b"sBIT", b"\x07\x06\x05")])),
    "png_palette8_gama45455": _own(".png", lambda r: png_bytes(
        r.integers(0, 256, (H, W)), 8, 3, chunks=_gamma(45455),
        palette=r.integers(0, 256, (256, 3)))),
    "png_palette8_gama_after_plte": _own(".png", lambda r: png_bytes(
        r.integers(0, 256, (H, W)), 8, 3, late_chunks=_gamma(45455),
        palette=r.integers(0, 256, (256, 3)))),
    "png_grey16_gama45455": _own(".png", lambda r: png_bytes(
        r.integers(0, 65536, (H, W)), 16, 0, chunks=_gamma(45455))),
    # PNG: eXIf orientation, as imread turns it
    "png_exif_orient3_pil": _by(".png", lambda p, r: _pil(
        r.integers(0, 256, (H, W)).astype(np.uint8)).save(
            p, exif=_exif(3))),
    "png_exif_orient6_pil": _by(".png", lambda p, r: _pil(
        _rgb(r, 255).astype(np.uint8)).save(p, exif=_exif(6))),
    # PNM: cv2's binary and ASCII files, 8 and 16 bits
    "pgm_cv2": _by(".pgm", lambda p, r: _cv2_write(
        p, r.integers(0, 256, (H, W)).astype(np.uint8))),
    "pgm16_cv2": _by(".pgm", lambda p, r: _cv2_write(
        p, r.integers(0, 65536, (H, W)).astype(np.uint16))),
    "ppm_cv2": _by(".ppm", lambda p, r: _cv2_write(
        p, _rgb(r, 255).astype(np.uint8))),
    "ppm16_cv2": _by(".ppm", lambda p, r: _cv2_write(
        p, _rgb(r, 65535).astype(np.uint16))),
    "pgm_ascii_cv2": _by(".pgm", lambda p, r: _cv2_write(
        p, r.integers(0, 256, (H, W)).astype(np.uint8), (
            __import__("cv2").IMWRITE_PXM_BINARY, 0))),
    "ppm16_ascii_cv2": _by(".ppm", lambda p, r: _cv2_write(
        p, _rgb(r, 65535).astype(np.uint16), (
            __import__("cv2").IMWRITE_PXM_BINARY, 0))),
    "pbm_cv2": _by(".pbm", lambda p, r: _cv2_write(
        p, (r.integers(0, 2, (H, W)) * 255).astype(np.uint8))),
    # PNM: every maxval scaling, comments, P1 and P4
    **{f"p5_maxval{m}": _own(".pgm", lambda r, m=m: pnm_bytes(
        5, r.integers(0, m + 1, (H, W)), m)) for m in (1, 15, 1000, 4095)},
    **{f"p2_maxval{m}": _own(".pgm", lambda r, m=m: pnm_bytes(
        2, r.integers(0, m + 1, (H, W)), m)) for m in (1, 15, 255, 1000,
                                                       4095, 65535)},
    "p2_above_maxval": _own(".pgm", lambda r: pnm_bytes(
        2, r.integers(0, 40, (H, W)), 20)),
    "p5_above_maxval": _own(".pgm", lambda r: pnm_bytes(
        5, r.integers(0, 256, (H, W)), 100)),
    "p3_maxval1000_comment": _own(".ppm", lambda r: pnm_bytes(
        3, _rgb(r, 1000), 1000, comment=True)),
    "p6_maxval15": _own(".ppm", lambda r: pnm_bytes(
        6, _rgb(r, 15), 15)),
    "p1": _own(".pbm", lambda r: pnm_bytes(1, r.integers(0, 2, (H, W)), 1)),
    "p4_comment": _own(".pbm", lambda r: pnm_bytes(
        4, r.integers(0, 2, (H, W)), 1, comment=True)),
    # TIFF: cv2's files (LZW with predictor 2 by default)
    "tif_grey8_cv2": _by(".tif", lambda p, r: _cv2_write(
        p, r.integers(0, 256, (H, W)).astype(np.uint8))),
    "tif_grey16_cv2": _by(".tif", lambda p, r: _cv2_write(
        p, r.integers(0, 65536, (H, W)).astype(np.uint16))),
    "tif_rgb8_cv2": _by(".tif", lambda p, r: _cv2_write(
        p, _rgb(r, 255).astype(np.uint8))),
    "tif_rgb16_cv2": _by(".tif", lambda p, r: _cv2_write(
        p, _rgb(r, 65535).astype(np.uint16))),
    "tif_rgba8_cv2": _by(".tif", lambda p, r: _cv2_write(
        p, np.concatenate([_rgb(r, 255), r.integers(0, 256, (H, W, 1))],
                          2).astype(np.uint8))),
    "tif_grey8_packbits_cv2": _by(".tif", lambda p, r: _cv2_write(
        p, (r.integers(0, 4, (H, W)) * 60).astype(np.uint8),
        (__import__("cv2").IMWRITE_TIFF_COMPRESSION, 32773))),
    "tif_rgb16_deflate_cv2": _by(".tif", lambda p, r: _cv2_write(
        p, _rgb(r, 65535).astype(np.uint16),
        (__import__("cv2").IMWRITE_TIFF_COMPRESSION, 8))),
    "tif_grey16_none_cv2": _by(".tif", lambda p, r: _cv2_write(
        p, r.integers(0, 65536, (H, W)).astype(np.uint16),
        (__import__("cv2").IMWRITE_TIFF_COMPRESSION, 1))),
    # TIFF: PIL's files
    "tif_grey_alpha_pil": _by(".tif", lambda p, r: _pil(
        r.integers(0, 256, (H, W, 2)).astype(np.uint8), "LA").save(p)),
    "tif_bilevel_pil": _by(".tif", lambda p, r: _pil(
        r.integers(0, 2, (H, W)).astype(bool)).save(p)),
    "tif_palette_lzw_pil": _by(".tif", lambda p, r: _pil(
        _rgb(r, 255).astype(np.uint8)).quantize(100).save(
            p, compression="tiff_lzw")),
    # TIFF: big-endian, tiles, PackBits, predictor 2, MinIsWhite, alpha
    "tif_be_grey16_lzw_pred2": _own(".tif", lambda r: tiff_bytes(
        r.integers(0, 65536, (H, W)), 16, 1, ">", 5, 2, rps=7)),
    "tif_be_rgb8_packbits": _own(".tif", lambda r: tiff_bytes(
        _rgb(r, 255), 8, 2, ">", 32773, rps=5)),
    "tif_tiled_grey8_deflate": _own(".tif", lambda r: tiff_bytes(
        r.integers(0, 256, (H, W)), 8, 1, "<", 32946, tile=(16, 16))),
    "tif_tiled_rgb16_lzw_pred2": _own(".tif", lambda r: tiff_bytes(
        _rgb(r, 65535), 16, 2, "<", 5, 2, tile=(32, 16))),
    "tif_be_tiled_grey1_packbits": _own(".tif", lambda r: tiff_bytes(
        r.integers(0, 2, (H, W)), 1, 1, ">", 32773, tile=(16, 32))),
    "tif_grey8_deflate8_pred2": _own(".tif", lambda r: tiff_bytes(
        r.integers(0, 256, (H, W)), 8, 1, "<", 8, 2, rps=4)),
    "tif_miniswhite1": _own(".tif", lambda r: tiff_bytes(
        r.integers(0, 2, (H, W)), 1, 0)),
    "tif_miniswhite8_lzw": _own(".tif", lambda r: tiff_bytes(
        r.integers(0, 256, (H, W)), 8, 0, "<", 5)),
    "tif_miniswhite16_be": _own(".tif", lambda r: tiff_bytes(
        r.integers(0, 65536, (H, W)), 16, 0, ">")),
    "tif_palette1_cmap16": _own(".tif", lambda r: tiff_bytes(
        r.integers(0, 2, (H, W)), 1, 3, cmap=r.integers(0, 65536, 6))),
    "tif_palette8_cmap16_packbits": _own(".tif", lambda r: tiff_bytes(
        r.integers(0, 256, (H, W)), 8, 3, "<", 32773,
        cmap=r.integers(0, 65536, 768))),
    "tif_palette4_cmap16": _own(".tif", lambda r: tiff_bytes(
        r.integers(0, 16, (H, W)), 4, 3, cmap=r.integers(0, 65536, 48))),
    "tif_palette8_cmap_below256": _own(".tif", lambda r: tiff_bytes(
        r.integers(0, 256, (H, W)), 8, 3, cmap=r.integers(0, 256, 768))),
    "tif_rgba8_assoc": _own(".tif", lambda r: tiff_bytes(
        np.concatenate([_rgb(r, 255), r.integers(0, 256, (H, W, 1))], 2),
        8, 2, extra=[1])),
    "tif_rgba8_unspecified": _own(".tif", lambda r: tiff_bytes(
        np.concatenate([_rgb(r, 255), r.integers(0, 256, (H, W, 1))], 2),
        8, 2, extra=[0])),
    "tif_rgba16_unassoc_be": _own(".tif", lambda r: tiff_bytes(
        np.concatenate([_rgb(r, 65535), r.integers(0, 65536, (H, W, 1))],
                       2), 16, 2, ">", 5, 2, extra=[2])),
    "tif_grey16_alpha": _own(".tif", lambda r: tiff_bytes(
        r.integers(0, 65536, (H, W, 2)), 16, 1, extra=[2])),
    "tif_orient3": _own(".tif", lambda r: tiff_bytes(
        r.integers(0, 256, (H, W)), 8, 1, tags=[(274, 3, [3])])),
    "tif_orient2_rgb16": _own(".tif", lambda r: tiff_bytes(
        _rgb(r, 65535), 16, 2, tags=[(274, 3, [2])])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_vs_jax(tmp_path, monkeypatch, case):
    """0 differing pixels against the JAX package's load_gray (cv2), and
    the same array with PIL hidden; no decode route gives way."""
    pytest.importorskip("cv2", reason="the JAX package decodes with cv2 "
                        "only where cv2 imports")
    path = CASES[case](str(tmp_path / "img"), _rng(case))
    want = jio.load_gray(path)
    before = (tiff.PIL_ROUTES, ndec.FALLBACKS)
    got = tio.load_gray(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(tio.load_gray(path), got)
    assert (tiff.PIL_ROUTES, ndec.FALLBACKS) == before


# ---------------------------------------------------- refused and corrupt

def _corrupt_png(kind):
    def make(r):
        good = png_bytes(r.integers(0, 256, (H, W)), 8, 0)
        at = good.index(b"IDAT")
        if kind == "truncated":
            return good[:at + 30]
        if kind == "idat_crc":
            return good[:at + 10] + bytes([good[at + 10] ^ 0xFF]) + \
                good[at + 11:]
        if kind == "short_data":
            return png_bytes(r.integers(0, 256, (H, W)), 8, 0)[:at - 4] + \
                png_bytes(r.integers(0, 256, (H - 5, W)), 8, 0)[at - 4:]
        # an unknown filter type (7) in the first row
        raw = bytearray(zlib.decompress(good[at + 4:good.index(b"IEND") - 8]))
        raw[0] = 7
        body = zlib.compress(bytes(raw))
        return (good[:at - 4] + struct.pack(">I", len(body)) + b"IDAT"
                + body + struct.pack(">I", zlib.crc32(b"IDAT" + body))
                + good[good.index(b"IEND") - 4:])
    return make


# name: (file maker, whether cv2.imread refuses it too). Where a strip
# is corrupt or short, imread hands back a partial image (zeros where
# libtiff stopped); the port raises.
REFUSED = {
    "png_truncated": (_own(".png", _corrupt_png("truncated")), True),
    "png_idat_crc": (_own(".png", _corrupt_png("idat_crc")), True),
    "png_short_data": (_own(".png", _corrupt_png("short_data")), True),
    "png_bad_filter": (_own(".png", _corrupt_png("bad_filter")), True),
    "tif_grey2": (_own(".tif", lambda r: tiff_bytes(
        r.integers(0, 4, (H, W)), 2, 1)), True),
    "tif_grey4_packbits": (_own(".tif", lambda r: tiff_bytes(
        r.integers(0, 16, (H, W)), 4, 1, "<", 32773)), True),
    "tif_palette2": (_own(".tif", lambda r: tiff_bytes(
        r.integers(0, 4, (H, W)), 2, 3, cmap=r.integers(0, 65536, 12))),
        True),
    "tif_orient6": (_own(".tif", lambda r: tiff_bytes(
        r.integers(0, 256, (H, W)), 8, 1, tags=[(274, 3, [6])])), True),
    "tif_truncated_pil": (_by(".tif", lambda p, r: _truncated_pil(p, r)),
                          False),
    "tif_lzw_garbage": (_own(".tif", lambda r: _lzw_garbage(r)), False),
    "tif_packbits_short": (_own(".tif", lambda r: _packbits_short(r)),
                           False),
    "pnm_p5_truncated": (_own(".pgm", lambda r: pnm_bytes(
        5, r.integers(0, 256, (H, W)), 255)[:-10]), True),
    "pnm_p2_short": (_own(".pgm", lambda r: pnm_bytes(
        2, r.integers(0, 256, (H, W)), 255)[:-40]), True),
    "pnm_p6_16bit_truncated": (_own(".ppm", lambda r: pnm_bytes(
        6, r.integers(0, 65536, (H, W, 3)), 65535)[:-1]), True),
}


def _truncated_pil(p, r):
    """PIL writes the IFD first: cutting the file shortens the strip."""
    _pil(r.integers(0, 256, (H, W)).astype(np.uint8)).save(p)
    with open(p, "rb") as f:
        data = f.read()
    with open(p, "wb") as f:
        f.write(data[:-100])


def _replace_strip(data: bytes, strip: bytes) -> bytes:
    """A one-strip little-endian TIFF from tiff_bytes with its strip's
    bytes replaced by `strip` of the same length."""
    return data[:8] + strip + data[8 + len(strip):]


def _lzw_garbage(r):
    data = tiff_bytes(r.integers(0, 256, (H, W)), 8, 1, "<", 5)
    n = struct.unpack("<I", data[4:8])[0] - 8
    # Clear, a literal, then codes far past the table's end.
    return _replace_strip(data, (b"\x80\x00\x7f\xff\xff" + bytes(n))[:n])


def _packbits_short(r):
    data = tiff_bytes(r.integers(0, 256, (H, W)), 8, 1, "<", 32773)
    n = struct.unpack("<I", data[4:8])[0] - 8
    # every run a zero-length no-op (-128): the strip decodes to nothing
    return _replace_strip(data, b"\x80" * n)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_and_corrupt_files_raise(tmp_path, case):
    """ValueError, never a partial image; where cv2 imports and refuses
    the file too, the JAX package raises as well."""
    make, imread_refuses = REFUSED[case]
    path = make(str(tmp_path / "bad"), _rng(case))
    with pytest.raises(ValueError):
        tio.load_gray(path)
    try:
        import cv2  # noqa: F401
    except ImportError:
        return
    if not imread_refuses:
        return
    with pytest.raises(ValueError):
        jio.load_gray(path)


# ------------------------------------------------------ routes through PIL

@pytest.mark.parametrize("compression,tag", [(7, "Compression"),
                                             (None, "SampleFormat")])
def test_tiff_outside_the_list_goes_to_pil_counted(tmp_path, monkeypatch,
                                                    compression, tag):
    """JPEG-in-TIFF and float samples: through PIL, counted in
    tiff.PIL_ROUTES; with PIL hidden, an ImportError naming the tag."""
    cv2 = pytest.importorskip("cv2", reason="cv2 writes these TIFFs")
    pytest.importorskip("PIL")
    rng = _rng(f"outside{compression}")
    p = str(tmp_path / "x.tif")
    if compression is None:
        assert cv2.imwrite(p, rng.random((H, W)).astype(np.float32) * 200)
    else:
        assert cv2.imwrite(p, rng.integers(0, 256, (H, W, 3)).astype(
            np.uint8), [cv2.IMWRITE_TIFF_COMPRESSION, compression])
    before = tiff.PIL_ROUTES
    got = tio.load_gray(p)
    assert got.shape == (H, W) and got.dtype == np.uint8
    assert tiff.PIL_ROUTES == before + 1
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=f"{tag}.*needs PIL"):
        tio.load_gray(p)
    assert tiff.PIL_ROUTES == before + 2


@pytest.mark.parametrize("orientation", [1, 2, 6, 7])
def test_jpeg_exif_orientation_vs_jax(tmp_path, orientation):
    """JPEG through PIL, turned as its EXIF Orientation asks, as imread
    turns it."""
    pytest.importorskip("cv2")
    pytest.importorskip("PIL")
    p = str(tmp_path / "x.jpg")
    _pil(_rgb(_rng("jpeg"), 255).astype(np.uint8)).save(
        p, quality=95, exif=_exif(orientation))
    got, want = tio.load_gray(p), jio.load_gray(p)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_folder_of_pngs_streams_without_pil(tmp_path, monkeypatch):
    """FolderSource over 16-bit grey PNGs with PIL hidden: the frames'
    high bytes, in name order."""
    rng = _rng("folder")
    want = []
    for i in range(3):
        wide = rng.integers(0, 65536, (H, W))
        (tmp_path / f"{i}.png").write_bytes(png_bytes(wide, 16, 0))
        want.append((wide >> 8).astype(np.uint8))
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = list(tsrc.FolderSource(str(tmp_path)))
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------- FileSource's read-ahead pool

def _mixed_files(tmp_path, n=11):
    """n frames as PNG, PGM and TIFF files in turn (more than twice the
    pool's threads, so the read-ahead refills), and their arrays."""
    rng = _rng("pool")
    paths, want = [], []
    for i in range(n):
        img = rng.integers(0, 256, (H + i, W)).astype(np.uint8)
        kind = i % 3
        p = tmp_path / f"f{i:02d}.{('png', 'pgm', 'tif')[kind]}"
        p.write_bytes((png_bytes(img, 8, 0), pnm_bytes(5, img, 255),
                       tiff_bytes(img, 8, 1, "<", 8))[kind])
        paths.append(str(p))
        want.append(img)
    return paths, want


def _decode_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("fipm-decode")]


@pytest.mark.parametrize("n_threads", [1, 4])
@pytest.mark.parametrize("source", ["files", "folder"])
def test_pool_gives_serial_load_gray_in_order(tmp_path, source, n_threads):
    """A FileSource of PNG, PGM and TIFF files and a FolderSource of PNGs
    (FolderSource globs *.bmp, *.jpg, *.png and *.jpeg): bit-equal to
    load_gray on this thread, in path order."""
    paths, _ = _mixed_files(tmp_path)
    if source == "folder":
        paths = sorted(p for p in paths if p.endswith(".png"))
        src = tsrc.FolderSource(str(tmp_path), n_threads=n_threads)
        assert src.paths == paths
    else:
        src = tsrc.FileSource(paths, n_threads=n_threads)
    got = list(src)
    assert len(got) == len(paths)
    for g, p in zip(got, paths):
        np.testing.assert_array_equal(g, tio.load_gray(p))
    assert not _decode_threads()


@pytest.mark.parametrize("n_threads", [1, 4])
def test_pool_raises_a_corrupt_file_in_its_place(tmp_path, n_threads):
    """The k-th file's ValueError, of load_gray's own message, comes after
    frames 0..k-1 and no later frame."""
    paths, want = _mixed_files(tmp_path)
    k = 5
    bad = REFUSED["png_idat_crc"][0](str(tmp_path / "bad"), _rng("bad"))
    paths[k] = bad
    with pytest.raises(ValueError) as serial:
        tio.load_gray(bad)
    got = []
    with pytest.raises(ValueError) as pooled:
        for img in tsrc.FileSource(paths, n_threads=n_threads):
            got.append(img)
    assert str(pooled.value) == str(serial.value)
    assert len(got) == k
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not _decode_threads()


@pytest.mark.parametrize("stop", ["close", "drop"])
def test_pool_stops_with_its_consumer(tmp_path, stop):
    """Closing or dropping the generator after two frames cancels the
    decodes not started and ends every worker thread."""
    paths, want = _mixed_files(tmp_path)
    before = set(threading.enumerate())
    frames = iter(tsrc.FileSource(paths, n_threads=4))
    for i in range(2):
        np.testing.assert_array_equal(next(frames), want[i])
    assert _decode_threads()
    if stop == "close":
        frames.close()
    else:
        del frames
        gc.collect()
    assert set(threading.enumerate()) == before


def test_read_ahead_holds_at_most_two_frames_a_thread(monkeypatch):
    """With a slow stand-in for load_gray, the pool starts frame i + 2n
    (n threads) once frame i is taken, and never a later one."""
    n, total = 2, 12
    started = []
    lock = threading.Lock()

    def slow(path):
        with lock:
            started.append(path)
        time.sleep(0.005)
        return np.full((2, 3), int(path[1:3]), np.uint8)
    monkeypatch.setattr(tio, "load_gray", slow)
    paths = [f"f{i:02d}.png" for i in range(total)]
    frames = iter(tsrc.FileSource(paths, n_threads=n))
    for i in range(total):
        assert next(frames)[0, 0] == i
        bound = min(total, i + 1 + 2 * n)
        deadline = time.monotonic() + 30
        while len(started) < bound and time.monotonic() < deadline:
            time.sleep(0.001)
        time.sleep(0.02)
        assert len(started) == bound
    assert next(frames, None) is None
    assert started == paths


def test_source_counts_frames_and_pooled(tmp_path):
    """source.frames for each frame yielded, on the pool and through the
    BMP loader; source.pooled for each frame a pool thread decoded."""
    from fastest_image_pattern_matching_tpu_torch.native import bmp
    from fastest_image_pattern_matching_tpu_torch.utils import profiling
    paths, _ = _mixed_files(tmp_path, 5)
    bmps = []
    for i in range(3):
        bmps.append(str(tmp_path / f"b{i}.bmp"))
        tio.save_gray(bmps[-1], _rng("bmp").integers(0, 256, (H, W)).astype(
            np.uint8))

    def deltas(src):
        f0, p0 = (profiling.counter("source.frames"),
                  profiling.counter("source.pooled"))
        n = len(list(src))
        return (n, profiling.counter("source.frames") - f0,
                profiling.counter("source.pooled") - p0)
    assert deltas(tsrc.FileSource(paths)) == (5, 5, 5)
    assert deltas(tsrc.FileSource(paths + bmps[:1])) == (6, 6, 6)
    assert deltas(tsrc.FileSource(bmps)) == (
        3, 3, 0 if bmp.available() else 3)
    assert deltas(tsrc.FileSource([])) == (0, 0, 0)


@pytest.mark.parametrize("ext", [".jpg", ".webp"])
def test_pil_only_formats_without_pil_raise(tmp_path, monkeypatch, ext):
    pytest.importorskip("PIL")
    p = str(tmp_path / ("x" + ext))
    tio.save_gray(p, _rng(ext).integers(0, 256, (H, W)).astype(np.uint8))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs PIL"):
        tio.load_gray(p)
    with pytest.raises(ImportError, match="needs PIL"):
        tio.save_gray(p, np.zeros((4, 4), np.uint8))


def test_sun_raster_colour_vs_jax(tmp_path):
    """cv2's colour Sun raster, greyed with OpenCV's 14-bit weights (the
    15-bit cvtColor weights missed by 1 on ~0.3% of pixels)."""
    cv2 = pytest.importorskip("cv2")
    pytest.importorskip("PIL")
    img = np.random.default_rng(11).integers(0, 256, (64, 80, 3))
    p = str(tmp_path / "x.ras")
    assert cv2.imwrite(p, img.astype(np.uint8))
    np.testing.assert_array_equal(tio.load_gray(p), jio.load_gray(p))


# ----------------------------------------------------------------- writers

def _smooth(seed, shape=(256, 256)):
    """Noise blurred with a 5x5 binomial kernel: JPEG keeps it within a
    few grey levels."""
    a = np.random.default_rng(seed).integers(0, 256, shape).astype(float)
    k = np.array([1, 4, 6, 4, 1]) / 16
    for ax in (0, 1):
        a = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax, a)
    return np.clip(np.round(a), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("ext,tol", [(".png", 0), (".pgm", 0), (".webp", 0),
                                     (".jpg", 5)])
def test_save_gray_read_back_by_cv2(tmp_path, monkeypatch, ext, tol):
    """save_gray's files read back by cv2 within the error of
    cv2.imwrite's own: PNG, PGM and WebP lossless, JPEG (quality 95, as
    cv2 writes it) within 5 and no worse than cv2's file; PNG and PGM are
    written and read without PIL."""
    img = _smooth(3)
    p = str(tmp_path / ("x" + ext))
    if ext in (".png", ".pgm"):
        monkeypatch.setitem(sys.modules, "PIL", None)
        tio.save_gray(p, img)
        np.testing.assert_array_equal(tio.load_gray(p), img)
        monkeypatch.delitem(sys.modules, "PIL")
    else:
        pytest.importorskip("PIL")
        tio.save_gray(p, img)
    cv2 = pytest.importorskip("cv2")
    q = str(tmp_path / ("cv2" + ext))
    assert cv2.imwrite(q, img)
    err = np.abs(cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(int) - img).max()
    theirs = np.abs(cv2.imread(q, cv2.IMREAD_GRAYSCALE).astype(int)
                    - img).max()
    assert err <= tol and err <= theirs


# ------------------------------------------------- native loops and twins

@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_png_unfilter_native_equals_twin(bpp):
    rng = np.random.default_rng(bpp)
    rows, row_bytes = 9, 37 + bpp
    data = rng.integers(0, 256, rows * (row_bytes + 1)).astype(np.uint8)
    data[::row_bytes + 1] = rng.integers(0, 5, rows)
    a = ndec.png_unfilter(data, rows, row_bytes, bpp)
    b = png._unfilter_py(data, rows, row_bytes, bpp)
    np.testing.assert_array_equal(a, b)
    data[(row_bytes + 1) * 4] = 5
    for fn in (ndec.png_unfilter, png._unfilter_py):
        with pytest.raises(ValueError, match="filter"):
            fn(data, rows, row_bytes, bpp)


def _lzw_inputs():
    rng = np.random.default_rng(5)
    runs = np.repeat(rng.integers(0, 256, 3000), rng.integers(1, 9, 3000))
    noise = rng.integers(0, 256, 9000)
    return {"runs": bytes(runs.astype(np.uint8)),
            "noise": bytes(noise.astype(np.uint8)),
            "zeros": bytes(20000)}


@pytest.mark.parametrize("name", ["runs", "noise", "zeros"])
def test_lzw_native_equals_twin(name):
    """Round trips through the table resets (noise passes 4094 codes), a
    cut at a smaller size, and garbage: equal bytes or the same error."""
    data = _lzw_inputs()[name]
    enc = lzw_encode(data)
    for size in (len(data), len(data) // 3, len(data) + 10):
        a = ndec.lzw_decode(enc, size)
        b = tiff._lzw_py(enc, size)
        np.testing.assert_array_equal(a, b)
        assert a.tobytes() == data[:size]
    rng = np.random.default_rng(len(name))
    for _ in range(20):
        junk = b"\x80" + bytes(rng.integers(0, 256, 64).astype(np.uint8))
        try:
            a = ndec.lzw_decode(junk, 500)
        except ValueError:
            with pytest.raises(ValueError):
                tiff._lzw_py(junk, 500)
            continue
        np.testing.assert_array_equal(a, tiff._lzw_py(junk, 500))


def test_packbits_native_equals_twin():
    rng = np.random.default_rng(6)
    data = bytes(np.repeat(rng.integers(0, 256, 400),
                           rng.integers(1, 6, 400)).astype(np.uint8))
    enc = packbits_encode(data)
    for size in (len(data), len(data) // 2):
        a = ndec.packbits_decode(enc, size)
        np.testing.assert_array_equal(a, tiff._packbits_py(enc, size))
        assert a.tobytes() == data[:size]
    for _ in range(20):
        junk = bytes(rng.integers(0, 256, 50).astype(np.uint8))
        np.testing.assert_array_equal(ndec.packbits_decode(junk, 300),
                                      tiff._packbits_py(junk, 300))


@pytest.mark.parametrize("dtype,spp", [(np.uint8, 1), (np.uint8, 4),
                                       (np.uint16, 1), (np.uint16, 3)])
def test_unpredict_native_equals_twin(dtype, spp):
    top = np.iinfo(dtype).max
    a = np.random.default_rng(spp).integers(0, top + 1, (7, 33, spp)).astype(
        dtype)
    b = a.copy()
    ndec.unpredict(a)
    tiff._unpredict_np(b)
    np.testing.assert_array_equal(a, b)


def test_twins_without_a_compiler_are_counted(tmp_path, monkeypatch):
    """Without g++, every loop runs in its twin, gives the same image and
    is counted in native/decode.py::FALLBACKS."""
    rng = np.random.default_rng(9)
    files = {"p.png": png_bytes(_rgb(rng, 65535), 16, 2, interlace=True),
             "l.tif": tiff_bytes(rng.integers(0, 65536, (H, W)), 16, 1,
                                 ">", 5, 2, rps=8),
             "k.tif": tiff_bytes(_rgb(rng, 255), 8, 2, "<", 32773)}
    want = {}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        want[name] = tio.load_gray(str(tmp_path / name))
    monkeypatch.setattr(ndec, "can_build", lambda: False)
    before = ndec.FALLBACKS
    for name in files:
        np.testing.assert_array_equal(tio.load_gray(str(tmp_path / name)),
                                      want[name])
    # 7 Adam7 passes unfiltered; 4 strips, each LZW and predictor; 1
    # PackBits strip.
    assert ndec.FALLBACKS == before + 7 + 4 * 2 + 1


def test_codecs_import_no_jax_cv2_or_pil():
    code = ("import sys\n"
            "import fastest_image_pattern_matching_tpu_torch.utils.imageio\n"
            "import fastest_image_pattern_matching_tpu_torch.native.decode\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ("
            "'jax', 'jaxlib', 'cv2', 'PIL', "
            "'fastest_image_pattern_matching_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))))
