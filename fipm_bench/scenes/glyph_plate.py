"""Printed plates read by a glyph set (the OCR configurations): a 5x7
dot-matrix font of 36 glyphs (0-9, A-Z) and plates that stamp a string
of them left to right, as the reference tool's 36-glyph M12 demo reads a
lot code (MatchTool/MatchToolDlg.cpp:714-771; tools/ocr_bench.py's
scene).

params: "frame_hw", "glyph_hw" (a glyph's size), "glyphs" (the glyph
set, in order), "length" (glyphs a plate), "first" (frame 0's string, or
null to draw it), "x0" and "y0" (the first glyph's left edge and row),
"jitter" (each glyph's row moves by up to this many pixels either way),
"gap" (pixels between two glyphs), "background" ([least, most) grey)
and "noise" (the camera's own noise, in [0, noise), taken off every pixel
after the glyphs are stamped, so that no stamped glyph is its pattern's
exact copy, as in a photograph). The seed draws each plate's string from
the glyph set (but frame 0's when "first" is given), its background, the
jitter and the noise; an empty frame is background and noise alone.
numpy only.
"""

from __future__ import annotations

import numpy as np

FONT_5X7 = {
    "0": "01110 10001 10011 10101 11001 10001 01110",
    "1": "00100 01100 00100 00100 00100 00100 01110",
    "2": "01110 10001 00001 00010 00100 01000 11111",
    "3": "11111 00010 00100 00010 00001 10001 01110",
    "4": "00010 00110 01010 10010 11111 00010 00010",
    "5": "11111 10000 11110 00001 00001 10001 01110",
    "6": "00110 01000 10000 11110 10001 10001 01110",
    "7": "11111 00001 00010 00100 01000 01000 01000",
    "8": "01110 10001 10001 01110 10001 10001 01110",
    "9": "01110 10001 10001 01111 00001 00010 01100",
    "A": "01110 10001 10001 11111 10001 10001 10001",
    "B": "11110 10001 10001 11110 10001 10001 11110",
    "C": "01110 10001 10000 10000 10000 10001 01110",
    "D": "11100 10010 10001 10001 10001 10010 11100",
    "E": "11111 10000 10000 11110 10000 10000 11111",
    "F": "11111 10000 10000 11110 10000 10000 10000",
    "G": "01110 10001 10000 10111 10001 10001 01111",
    "H": "10001 10001 10001 11111 10001 10001 10001",
    "I": "01110 00100 00100 00100 00100 00100 01110",
    "J": "00111 00010 00010 00010 00010 10010 01100",
    "K": "10001 10010 10100 11000 10100 10010 10001",
    "L": "10000 10000 10000 10000 10000 10000 11111",
    "M": "10001 11011 10101 10101 10001 10001 10001",
    "N": "10001 10001 11001 10101 10011 10001 10001",
    "O": "01110 10001 10001 10001 10001 10001 01110",
    "P": "11110 10001 10001 11110 10000 10000 10000",
    "Q": "01110 10001 10001 10001 10101 10010 01101",
    "R": "11110 10001 10001 11110 10100 10010 10001",
    "S": "01111 10000 10000 01110 00001 00001 11110",
    "T": "11111 00100 00100 00100 00100 00100 00100",
    "U": "10001 10001 10001 10001 10001 10001 01110",
    "V": "10001 10001 10001 10001 10001 01010 00100",
    "W": "10001 10001 10001 10101 10101 10101 01010",
    "X": "10001 10001 01010 00100 01010 10001 10001",
    "Y": "10001 10001 10001 01010 00100 00100 00100",
    "Z": "11111 00001 00010 00100 01000 10000 11111",
}


def glyph(ch, hw=(52, 34)):
    """Glyph `ch` of FONT_5X7 as a u8 image of hw: dark dots (40) on a
    light ground (220), each of the 5x7 cells scaled to the image with a
    one-pixel gap, and a little deterministic texture."""
    h, w = hw
    rows = [[c == "1" for c in r] for r in FONT_5X7[ch].split()]
    yy = np.arange(h) * 7 // h
    xx = np.arange(w) * 5 // w
    gap_y = (np.arange(h) * 7 % h) < 7
    gap_x = (np.arange(w) * 5 % w) < 5
    ink = np.array(rows)[yy[:, None], xx[None, :]] & ~gap_y[:, None] \
        & ~gap_x[None, :]
    texture = np.random.default_rng(ord(ch)).integers(0, 12, (h, w))
    return np.where(ink, 40 + texture, 220 - texture).astype(np.uint8)


def stamp(text, rng, hw=(360, 640), glyph_hw=(52, 34), x0=40, y0=140,
          jitter=6, gap=14, background=(150, 190)):
    """A plate of background in [background) with `text` stamped left to
    right from x0 at a pitch of the glyph width + gap, each glyph's row
    y0 moved by up to `jitter` px, both drawn from rng in that order.
    Returns (plate, [(char, cx, cy)])."""
    scene = rng.integers(background[0], background[1], hw, dtype=np.uint8)
    x = x0
    placed = []
    for ch in text:
        g = glyph(ch, glyph_hw)
        y = y0 + int(rng.integers(-jitter, jitter + 1))
        scene[y:y + g.shape[0], x:x + g.shape[1]] = g
        placed.append((ch, x + (g.shape[1] - 1) / 2.0,
                       y + (g.shape[0] - 1) / 2.0))
        x += g.shape[1] + gap
    return scene, placed


def ocr_plate(text="M12X05", hw=(360, 640), glyph_hw=(52, 34), seed=4,
              x0=40, y0=140):
    """tools/ocr_bench.py::build_scene with FONT_5X7 glyphs: a plate of
    background 150-190 with `text` stamped left to right at a pitch of the
    glyph width + 14 px, each glyph's row jittered by up to 6 px. Returns
    (plate, [(char, cx, cy)])."""
    return stamp(text, np.random.default_rng(seed), hw, glyph_hw, x0, y0)


def make_pool(params: dict, n_frames: int, n_empty: int, rng):
    """-> (the glyph set {label: u8 [h, w]} in the order of
    params["glyphs"], plates u8 [n, H, W], truths: each plate's string,
    "" for an empty frame)."""
    ghw = tuple(params["glyph_hw"])
    labels = params["glyphs"]
    glyphs = {ch: glyph(ch, ghw) for ch in labels}
    H, W = params["frame_hw"]
    frames = np.empty((n_frames, H, W), np.uint8)
    truths = []
    # Frame k holds a string when rank[k] >= n_empty.
    rank = rng.permutation(n_frames)
    for k in range(n_frames):
        if rank[k] < n_empty:
            frames[k] = rng.integers(*params["background"], (H, W),
                                     dtype=np.uint8)
            truths.append("")
            continue
        if k == 0 and params.get("first"):
            text = params["first"]
        else:
            text = "".join(labels[i] for i in rng.integers(
                0, len(labels), params["length"]))
        frames[k], _ = stamp(text, rng, (H, W), ghw, params["x0"],
                             params["y0"], params["jitter"], params["gap"],
                             params["background"])
        truths.append(text)
    for k in range(n_frames):
        noise = rng.integers(0, params["noise"], (H, W), dtype=np.uint8)
        np.subtract(frames[k], np.minimum(frames[k], noise), out=frames[k])
    return glyphs, frames, truths
