#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py          # every phase
    python3 chip_smoke.py peaks    # phases 1, 2 and 23
    python3 chip_smoke.py descent  # phases 1, 2 and 24

Phases, each of which fails the run (non-zero exit) when it fails:
  1. device: the card's name and power limit; CUDA is required.
  2. build: compiles the four hand-written CUDA kernels (warp,
     correlation, peaks, descent score) from the sources in this checkout
     (nvcc, sm_90a), one nvcc each, in parallel, and the native host
     library (g++).
  3. warp kernel against its plain PyTorch version on the card, at the
     shapes of the flagship's main path (L0 also with all maps at 0, 45
     and 90 deg), a map wholly outside the image and general affine maps
     (which must take the global-tap branch, and only they), plus the
     pyramid on the card against the CPU; times of kernel, plain version
     and F.grid_sample, each as a host-driven loop and as device time
     alone (a CUDA graph); then every warp launch of one flagship match,
     recorded with its own inputs, held against the plain version and
     timed alone, per pyramid level.
  4. the flagship (4024x3036 source, 762x521 template, tolerance 180 deg,
     three planted targets) through learn_pattern + match on the card,
     which must find the three targets and launch the warp kernel; wall
     time, per-stage times and a torch.profiler pass (device busy share,
     device events and host syncs per match, largest device consumers).
  5. the port on the card against the port on the CPU on a 500x600
     three-target scene.
  6. correlation kernel against its plain version on the card (bit-equal
     on integer inputs): Test7's top layer (1824x1824 x 27x27), 8 rotated
     canvases, the template-size corners, a ragged output, fractional
     inputs within the kernel's rounding bound and a canvas with one
     fractional patch; the blocks of each launch on the int8 and f32
     paths; times of kernel (int8 path, and f32 path on the canvas plus
     0.25, in turns), plain version and F.conv2d at Test7's shape.
  7. Test7's many-target scene (3648x3648 source, 100 planted 54x54
     washers, tol 0) through learn_pattern + match on the card, which must
     find all 100 and launch the correlation kernel once, every block on
     its int8 path; wall time, per-stage times, a profiler pass as in
     phase 4, and the sweep's split into score map and peaks.
  8. match_template on the card against the port on the CPU; times of the
     conv and fft routes on each side of the "auto" rule's crossover.
  9. the port on the card against the CPU on a 720x720 many-target scene,
     at tolerance 0 and 30 deg.
 10. the flagship as a batch of four frames (the flagship scene, its poses
     turned 37 and 71 deg, noise alone) through match_many: 3, 3, 3 and 0
     targets found; each frame equal to its own match(); fewer warp
     launches per batch than four matches take, every one bit-equal to the
     plain version at its own inputs; the batched level-0 launch timed
     against its bound; wall per batch and per frame, stages, profiler.
 11. Test7 as a batch of two frames (seeds 7 and 8, one washer): 100 of
     100 in each, one correlation launch for both, every block int8; each
     frame equal to its match(); wall, the peak kernel's share, profiler.
 13. an OCR plate (36 glyphs of a 5x7 dot-matrix font, tools/ocr_bench.py's
     scene and configuration) read as "M12X05" by MultiTemplateMatcher,
     batched and glyph by glyph, with equal matches; both times.
 14. a corpus stream (24 frames of 480x640 and a 400x600 straggler, one
     target each, tools/stream_bench.py's walk, tolerance 15 deg) through
     inspect_corpus in batches of 8, 8, 8 and 1: the target in every
     frame within 1 px, every warp launch bit-equal to the plain version.
 15. ORB (orb_match, the default ORBConfig: 500 features, 8 levels, 150
     good matches, 2000 RANSAC draws) on one pair at two sizes: the ORB
     bench's 265x334 scene with a 200x200 template, and a 4024x3036 camera
     frame with a 762x521 template, each template turned and shifted into
     its scene: the homography found, corners within 3 px of the truth;
     the card against the CPU on the same draws (is_matched and inliers
     equal, corners within 0.5 px); wall, the detect / match / RANSAC
     split, a profiler pass (busy share, launches and host syncs a call).
 16. orb_match_many on eight 480x640 frames (five hold the part): each
     frame's result equal to its own orb_match on the card; wall per frame
     against one call.
 17. the CLI through cli.main: match --json on the flagship scene (3
     targets, equal to match(), warp kernel launched), orb --json on phase
     15's pair, ocr --json on phase 13's plate and glyphs ("M12X05"),
     watch over a directory of three frames, settings; then match --json
     in a fresh `python -m` process, its first call's wall.
 18. the native host library (built in phase 2, its g++ seconds): its BMP codec
     byte-equal to the numpy twin on write and pixel-equal on read; a
     folder of 24 480x640 corpus frames and one of 4 flagship frames as
     BMPs, decoded through FileSource on 1 and 4 threads (ms per frame,
     frames equal); inspect_corpus over FolderSource on 1 and 4 threads
     (ms per frame, reports equal); no fallback to the numpy codec.
 19. profiling: the port's span table over a flagship match (the stages'
     host ms) against device_trace's Chrome trace of the same call: every
     stage span in both on one clock, fipm.match's children covering at
     least 95% of it, the warp kernel named.
 20. torch.distributed with NCCL at world size 1 (127.0.0.1, a free port)
     and make_mesh((1, 1)): match_batch_sharded on phase 10's flagship
     batch equal to match_many_arrays, with warp kernel launches; Test7 as
     a batch of two (phase 11) equal, with a correlation kernel launch;
     orb_match_many_sharded equal to orb_match_many field by field (phase
     16's frames); match_patterns_sharded equal to match_patterns on phase
     13's plate, reading "M12X05"; inspect_corpus(mesh=...) equal to phase
     14's; the wall of each sharded call beside the unsharded one (the
     collectives' and padding's cost at world 1); destroy_process_group.
 21. deployment packs (aot.py), the libraries bundled: the flagship (one
     frame and bucket 4), Test7 and ORB at 480x640 (bucket 8) exported and
     loaded in process, each equal to phases 4, 10, 7 and 16 with their
     kernel launches; export seconds, pack sizes, load ms, first and
     second match; then, in a copy of the package without _build/, a fresh
     `cli aot-match --json` (matches equal to phase 17's match --json) and
     a fresh start-up script (seconds of import torch, torch.cuda.init(),
     the package import, AotMatcher.load, first and second match), with 0
     nvcc runs, 0 g++ runs and 0 bundle rejects, and _build/ holding the
     pack's libraries byte for byte.
 22. frame decode without PIL or cv2 (whether each imports here is
     printed): the flagship frame and its batch as 16-bit PNGs ((u8 << 8)
     | noise) and as an 8-bit palette PNG, Test7's frame as a 16-bit LZW
     TIFF with predictor 2 and the corpus frames as PGMs, written with the
     port's writers and the numpy helpers here, decoded through
     FolderSource (and the CLI's match on a .png): every decoded frame
     bit-equal to the u8 array it came from, every match list equal to
     the u8 array's (valid masks; score 1e-6, centre and angle 1e-5),
     both kernels launched, no decode route giving way (native/bmp.py and
     native/decode.py FALLBACKS, codecs/tiff.py PIL_ROUTES all 0); decode
     ms a frame per format and bit depth at 480x640 and 4024x3036, through
     the native loops and (480x640) through their Python twins.
 23. the peak kernel against the plain loop (on the CPU), bit for bit, on
     the score maps one Test7 match (tile form), one flagship match and a
     flagship batch of 8 (small form) hand to extract_peaks; launches and
     tile-form calls per match; kernel (host loop, device alone), plain
     loop on the card and bound; both forms timed on the same maps around
     the size where the wrapper switches.
 24. the descent-score kernel against its plain version on the card, bit
     for bit, on every descent chunk of one flagship match (levels 5-0),
     one Test7 match, a flagship batch of 8 and ocr.plate's read (36
     glyphs of 52x34 as one stack: the launch with a template index),
     recorded from the calls; the read equal to match_arrays of each
     glyph on the card; launches per call equal to the chunks that ran
     (the fipm.descent.chunk spans under the profiler); kernel (host
     loop, device alone), plain version on the card and bound at the
     flagship's level-0 chunk (24 ROIs), Test7's chunk (32 ROIs) and the
     plate's level-1 and level-0 chunks.
The last three lines of output are the kernels' JSON summary, the card's
name and power limit, and {"ok": true, "device": {...}}. Imports nothing
of JAX.
"""

import contextlib
import dataclasses
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

from fipm_bench.scenes.glyph_plate import (FONT_5X7, glyph, make_pool,
                                           ocr_plate)

FLAGSHIP_POSES = [(1725.9, 1045.4, 0.05), (2662.9, 1537.4, -119.98),
                  (1768.9, 2098.5, 120.15)]
SMALL_POSES = [(150.0, 130.0, 0.0), (430.0, 160.0, 120.0),
               (280.0, 380.0, -120.0)]


def kernel_launches(since=None):
    """(warp, correlation) kernel launches of this process, from the
    port's counters; with `since` (an earlier value), those after it."""
    from fastest_image_pattern_matching_tpu_torch.utils.profiling import (
        counter)
    now = (counter("warp.launches"), counter("corr.launches"))
    return now if since is None else (now[0] - since[0], now[1] - since[1])


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- scenes

def _rect(img, x0, y0, x1, y1, val, thick):
    """Outline of the rectangle with corners (x0, y0), (x1, y1), drawn
    inward-and-outward thick/2 pixels like cv2.rectangle."""
    h = thick // 2
    img[y0 - h:y0 + h + 1, x0 - h:x1 + h + 1] = val
    img[y1 - h:y1 + h + 1, x0 - h:x1 + h + 1] = val
    img[y0 - h:y1 + h + 1, x0 - h:x0 + h + 1] = val
    img[y0 - h:y1 + h + 1, x1 - h:x1 + h + 1] = val


def _disc(img, cx, cy, r, val):
    yy, xx = np.mgrid[:img.shape[0], :img.shape[1]]
    img[(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = val


def _line(img, x0, y0, x1, y1, val, thick):
    yy, xx = np.mgrid[:img.shape[0], :img.shape[1]].astype(np.float64)
    dx, dy = x1 - x0, y1 - y0
    t = np.clip(((xx - x0) * dx + (yy - y0) * dy) / (dx * dx + dy * dy), 0, 1)
    dist = np.hypot(xx - (x0 + t * dx), yy - (y0 + t * dy))
    img[dist <= thick / 2.0] = val


def _paste_rotated(scene, templ, cx, cy, angle_deg):
    """Paste templ rotated by angle_deg (cv::getRotationMatrix2D
    convention, bilinear) around (cx, cy); returns the centre the matcher
    reports for it, in scene coordinates. The matcher's centre is that of
    the rect anchored at the centre of pixel (0, 0) with sides w and h,
    i.e. template point (w/2, h/2) in pixel-centre coordinates."""
    from scipy import ndimage
    th, tw = templ.shape
    diag = int(np.ceil(np.hypot(th, tw))) + 4
    canvas = np.zeros((diag, diag), np.float64)
    mask = np.zeros((diag, diag), np.float64)
    y0, x0 = (diag - th) // 2, (diag - tw) // 2
    canvas[y0:y0 + th, x0:x0 + tw] = templ
    mask[y0:y0 + th, x0:x0 + tw] = 1.0
    c = (diag - 1) / 2.0
    a = math.radians(angle_deg)
    al, be = math.cos(a), math.sin(a)
    fwd = np.array([[al, be, (1 - al) * c - be * c],
                    [-be, al, be * c + (1 - al) * c]])
    det = fwd[0, 0] * fwd[1, 1] - fwd[0, 1] * fwd[1, 0]
    inv_lin = np.array([[fwd[1, 1], -fwd[0, 1]],
                        [-fwd[1, 0], fwd[0, 0]]]) / det
    inv_t = -inv_lin @ fwd[:, 2]
    # scipy indexes (row, col): src_rc = M_rc @ dst_rc + off_rc.
    m_rc = np.array([[inv_lin[1, 1], inv_lin[1, 0]],
                     [inv_lin[0, 1], inv_lin[0, 0]]])
    off_rc = np.array([inv_t[1], inv_t[0]])
    rc = ndimage.affine_transform(canvas, m_rc, off_rc, order=1,
                                  mode="constant", cval=0.0)
    rm = ndimage.affine_transform(mask, m_rc, off_rc, order=0,
                                  mode="constant", cval=0.0)
    rc = np.clip(np.rint(rc), 0, 255).astype(np.uint8)
    ys = int(round(cy - c))
    xs = int(round(cx - c))
    reg = scene[max(ys, 0):ys + diag, max(xs, 0):xs + diag]
    rm2 = rm[:reg.shape[0], :reg.shape[1]] > 0.5
    reg[rm2] = rc[:reg.shape[0], :reg.shape[1]][rm2]
    tcx, tcy = x0 + tw / 2.0, y0 + th / 2.0
    centre = fwd @ np.array([tcx, tcy, 1.0])
    return float(centre[0] + xs), float(centre[1] + ys)


def flagship_scene():
    """bench.py's Src7-like scene at the same shapes, built with numpy and
    scipy: rectangle, disc, thick line and a bar block on a 762x521
    template; three rotated copies in a 4024x3036 noise source."""
    rng = np.random.default_rng(42)
    th, tw = 521, 762
    t = np.full((th, tw), 50, np.uint8)
    _rect(t, 30, 30, tw - 31, th - 31, 210, 12)
    _disc(t, tw // 3, th // 2, 90, 160)
    _line(t, tw // 2, 40, tw - 60, th - 60, 250, 16)
    t[th - 150:th - 70, 60:110] = 240
    t[th - 150:th - 130, 110:260] = 240
    t = np.minimum(t.astype(np.int32)
                   + rng.integers(0, 20, t.shape), 255).astype(np.uint8)
    scene = rng.integers(0, 40, size=(3036, 4024), dtype=np.uint8)
    truth = [(*_paste_rotated(scene, t, cx, cy, a), a)
             for cx, cy, a in FLAGSHIP_POSES]
    return scene, t, truth


def small_scene():
    """The three-target 500x600 scene of the synthetic tests, without
    cv2: a 48x64 template with rectangle, disc and thick line."""
    rng = np.random.default_rng(7)
    h, w = 48, 64
    t = np.full((h, w), 40, np.uint8)
    _rect(t, 6, 6, w - 7, h - 7, 220, 2)
    _disc(t, w // 3, h // 2, 8, 180)
    _line(t, w // 2, 8, w - 10, h - 10, 255, 3)
    t[h - 20:h - 10, 8:20] = 255
    t = np.minimum(t.astype(np.int32)
                   + rng.integers(0, 25, t.shape), 255).astype(np.uint8)
    scene = np.random.default_rng(6).integers(0, 30, size=(500, 600),
                                              dtype=np.uint8)
    truth = [(*_paste_rotated(scene, t, cx, cy, a), a)
             for cx, cy, a in SMALL_POSES]
    return scene, t, truth


def washer_template(rng, size=54):
    """A size x size ring washer on a bright background, the look of the
    reference's Dst10 (round washers on white): dark annulus, bright hole,
    a notch in the ring and pixel noise."""
    c = (size - 1) / 2.0
    yy, xx = np.mgrid[:size, :size]
    r = np.hypot(xx - c, yy - c)
    t = np.full((size, size), 225.0)
    t[(r >= 0.22 * size) & (r <= 0.46 * size)] = 70.0
    t[(np.abs(yy - c) < 0.05 * size) & (xx > c)
      & (r >= 0.22 * size) & (r <= 0.46 * size)] = 150.0
    t -= rng.integers(0, 20, t.shape)
    return np.clip(t, 0, 255).astype(np.uint8)


def many_target_scene(size, n, seed=7, templ=None):
    """The tol=0 many-target scene of tools/suite_bench.py::
    _synthetic_src10 at any size: a size x size source of 235 minus noise
    in [0, 12) and n non-overlapping washer copies at least 6 px apart
    (the washer drawn from the seed, or `templ`). Returns (scene,
    template, planted centres [(cx, cy)]) in the matcher's centre
    convention (top-left + (w/2, h/2))."""
    rng = np.random.default_rng(seed)
    t = washer_template(rng) if templ is None else templ
    scene = (np.full((size, size), 235, np.uint8)
             - rng.integers(0, 12, (size, size), dtype=np.uint8))
    th, tw = t.shape
    placed = []
    attempts = 0
    while len(placed) < n and attempts < 10000:
        attempts += 1
        y = int(rng.integers(40, size - th - 40))
        x = int(rng.integers(40, size - tw - 40))
        if any(abs(y - py) < th + 6 and abs(x - px) < tw + 6
               for py, px in placed):
            continue
        scene[y:y + th, x:x + tw] = t
        placed.append((y, x))
    if len(placed) != n:
        raise ValueError(f"placed {len(placed)} of {n} targets")
    return scene, t, [(x + tw / 2.0, y + th / 2.0) for y, x in placed]


def flagship_batch():
    """Four flagship-sized frames: the flagship scene; the same template at
    the flagship poses turned 37 and 71 deg about the image centre (each
    pose's angle turned as well) on fresh noise; noise alone. Returns
    (frames [4, 3036, 4024] u8, template, planted (cx, cy, angle) per
    frame)."""
    scene, t, truth = flagship_scene()
    frames, truths = [scene], [truth]
    oy, ox = (scene.shape[0] - 1) / 2.0, (scene.shape[1] - 1) / 2.0
    for k, turn in enumerate((37.0, 71.0)):
        f = np.random.default_rng(43 + k).integers(0, 40, size=scene.shape,
                                                   dtype=np.uint8)
        ca, sa = math.cos(math.radians(turn)), math.sin(math.radians(turn))
        poses = [(ox + (cx - ox) * ca + (cy - oy) * sa,
                  oy - (cx - ox) * sa + (cy - oy) * ca,
                  (a + turn + 180.0) % 360.0 - 180.0)
                 for cx, cy, a in FLAGSHIP_POSES]
        truths.append([(*_paste_rotated(f, t, cx, cy, a), a)
                       for cx, cy, a in poses])
        frames.append(f)
    frames.append(np.random.default_rng(45).integers(0, 40, size=scene.shape,
                                                     dtype=np.uint8))
    truths.append([])
    return np.stack(frames), t, truths


def ocr_config(fipm):
    """tools/ocr_bench.py:56-57's configuration."""
    return fipm.MatchConfig(max_pos=8, score=0.85, tolerance_angle=0.0,
                            min_reduce_area=256, max_overlap=0.4)


def stream_template():
    """A 60x80 part for the corpus stream: a disc and two blocks broad
    enough to survive the pyramid's top layer at any sub-cell offset."""
    t = np.full((60, 80), 110, np.uint8)
    _disc(t, 24, 28, 17, 230)
    t[8:52, 48:60] = 20
    t[40:56, 8:40] = 180
    return t


def stream_frames(templ, n, hw=(480, 640), seed=5):
    """tools/stream_bench.py::_write_video's frames without the video:
    noise in [0, 40) and one template per frame at a walk of positions.
    Returns (frames [n, H, W] u8, centres [(cx, cy)])."""
    rng = np.random.default_rng(seed)
    th, tw = templ.shape
    frames, centres = [], []
    for i in range(n):
        f = rng.integers(0, 40, size=hw, dtype=np.uint8)
        y = int(40 + (i * 7) % (hw[0] - th - 80))
        x = int(40 + (i * 13) % (hw[1] - tw - 80))
        f[y:y + th, x:x + tw] = templ
        frames.append(f)
        centres.append((x + tw / 2.0, y + th / 2.0))
    return np.stack(frames), centres


def orb_template(hw, seed):
    """tests/test_orb.py::_textured without cv2: 8x8 blocks of uniform
    noise, a Gaussian blur (sigma 1) and discs of random grey, one per
    1500 px^2 (40 on a 240x320 image)."""
    from scipy import ndimage
    rng = np.random.default_rng(seed)
    h, w = hw
    blocks = rng.integers(0, 255, size=(h // 8 + 1, w // 8 + 1))
    img = np.repeat(np.repeat(blocks, 8, 0), 8, 1)[:h, :w]
    img = np.clip(np.rint(ndimage.gaussian_filter(img.astype(np.float64),
                                                  1.0)), 0, 255)
    img = img.astype(np.uint8)
    for _ in range(max(40, h * w // 1500)):
        x, y = rng.integers(10, w - 10), rng.integers(10, h - 10)
        _disc(img, int(x), int(y), int(rng.integers(3, 9)),
              int(rng.integers(0, 255)))
    return img


def orb_pose(templ, cx, cy, angle_deg):
    """The affine map [2, 3] taking template pixel (x, y) to the scene:
    turn by angle_deg about the template's centre, then put that centre
    at (cx, cy)."""
    th, tw = templ.shape
    a = math.radians(angle_deg)
    ca, sa = math.cos(a), math.sin(a)
    tc = np.array([(tw - 1) / 2.0, (th - 1) / 2.0])
    lin = np.array([[ca, -sa], [sa, ca]])
    return np.concatenate([lin, (np.array([cx, cy]) - lin @ tc)[:, None]],
                          1)


def orb_paste(scene, templ, fwd):
    """Draw templ into scene (in place) through the affine map fwd
    (template -> scene, bilinear). Returns the template's corners in the
    scene, in ORBResult.corners' order: the images of (0, 0), (w, 0),
    (w, h), (0, h)."""
    from scipy import ndimage
    th, tw = templ.shape
    inv = np.linalg.inv(np.vstack([fwd, [0.0, 0.0, 1.0]]))[:2]
    # scipy indexes (row, col): src_rc = M_rc @ dst_rc + off_rc.
    m_rc = np.array([[inv[1, 1], inv[1, 0]], [inv[0, 1], inv[0, 0]]])
    off_rc = np.array([inv[1, 2], inv[0, 2]])
    out = ndimage.affine_transform(templ.astype(np.float64), m_rc, off_rc,
                                   output_shape=scene.shape, order=1)
    inside = ndimage.affine_transform(np.ones(templ.shape), m_rc, off_rc,
                                      output_shape=scene.shape, order=1)
    keep = inside > 0.999
    scene[keep] = np.clip(np.rint(out[keep]), 0, 255).astype(np.uint8)
    tc = np.array([[0, 0], [tw, 0], [tw, th], [0, th]], np.float64)
    return tc @ fwd[:, :2].T + fwd[:, 2]


def orb_pairs():
    """Phase 15's two pairs: the ORB bench's shape (a 265x334 scene, a
    200x200 template, ORB_r05.json image_hw/template_hw) and a flagship
    camera frame (4024x3036, a 762x521 template). Each scene is noise in
    [0, 40) with its template turned and shifted in. Returns [(name, scene,
    template, true corners [4, 2])]."""
    pairs = []
    for name, hw, thw, pose, seed in (
            ("265x334", (265, 334), (200, 200), (170.0, 133.0, 12.0), 51),
            ("4024x3036", (3036, 4024), (521, 762),
             (2210.0, 1480.0, -23.0), 52)):
        t = orb_template(thw, seed)
        scene = np.random.default_rng(seed + 100).integers(
            0, 40, size=hw, dtype=np.uint8)
        pairs.append((name, scene, t,
                      orb_paste(scene, t, orb_pose(t, *pose))))
    return pairs


def orb_frames(templ, n=8, hw=(480, 640), seed=61):
    """Phase 16's frames: noise in [0, 40); frames 0, 1, 3, 4 and 6 hold
    templ turned and shifted. Returns (frames [n, H, W] u8, true corners
    per frame, None where the part is absent)."""
    rng = np.random.default_rng(seed)
    frames, truths = [], []
    for i in range(n):
        f = rng.integers(0, 40, size=hw, dtype=np.uint8)
        corners = None
        if i in (0, 1, 3, 4, 6):
            corners = orb_paste(f, templ, orb_pose(
                templ, 200.0 + 35.0 * i, 180.0 + 12.0 * i, -30.0 + 11.0 * i))
        frames.append(f)
        truths.append(corners)
    return np.stack(frames), truths


def flagship_config(fipm):
    return fipm.MatchConfig(max_pos=3, score=0.7, tolerance_angle=180.0,
                            max_overlap=0.1, use_subpixel=True)


def many_target_config(fipm, max_pos, tolerance_angle=0.0):
    """Test7's configuration (tools/suite_bench.py:101-105)."""
    return fipm.MatchConfig(max_pos=max_pos, score=0.5,
                            tolerance_angle=tolerance_angle, max_overlap=0.5,
                            min_reduce_area=1024)


# ---------------------------------------------------------------- bounds

# One H100 SXM (NVIDIA's data sheet, dense rates): device memory 3.35 TB/s,
# int8 tensor cores 1,979 TOP/s, f32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
# f32 operations per warped pixel: two coordinates (fma, mul, add each),
# two floors and two fractions, two complements, four weights, the
# four-term blend and the rounding.
WARP_OPS_PER_PIXEL = 21


def bound_ms(n_bytes, n_ops, ops_per_s):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type.
    Returns (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def warp_source_pixels(src_hw, maps, out_hw):
    """Distinct source pixels that the bilinear taps of these maps read:
    what the warp must move from its input, for this run's maps."""
    import torch
    H, W = src_hw
    Ho, Wo = out_hw
    dev = maps.device
    y = torch.arange(Ho, device=dev, dtype=torch.float64)[:, None]
    x = torch.arange(Wo, device=dev, dtype=torch.float64)[None, :]
    seen = torch.zeros(H * W, dtype=torch.bool, device=dev)
    for m in maps.double():
        x0 = torch.floor(m[0, 0] * x + m[0, 1] * y + m[0, 2]).long()
        y0 = torch.floor(m[1, 0] * x + m[1, 1] * y + m[1, 2]).long()
        for dy in (0, 1):
            for dx in (0, 1):
                yy, xx = y0 + dy, x0 + dx
                ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                seen[(yy * W + xx)[ok]] = True
    return int(seen.sum())


def warp_bound(src, maps, out_hw):
    B = maps.shape[0]
    n_out = B * out_hw[0] * out_hw[1]
    n_bytes = 4 * (warp_source_pixels(src.shape, maps, out_hw) + n_out
                   + 6 * B)
    return bound_ms(n_bytes, WARP_OPS_PER_PIXEL * n_out, F32_OPS_PER_S)


def corr_bound(canv, templ):
    """Each input read once, the map written once; the multiply-adds at the
    int8 tensor-core rate when both inputs are int8-valued (the centred
    u8 values of the main path), else at the f32 rate."""
    B, H, W = canv.shape
    h, w = templ.shape
    Ho, Wo = H - h + 1, W - w + 1
    n_bytes = 4 * (B * H * W + h * w + B * Ho * Wo)
    int8 = all(bool((t == t.round()).all()) and float(t.min()) >= -128
               and float(t.max()) <= 127 for t in (canv, templ))
    return bound_ms(n_bytes, 2 * B * Ho * Wo * h * w,
                    INT8_OPS_PER_S if int8 else F32_OPS_PER_S)


# ---------------------------------------------------------------- timing

def cuda_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, n=20, reps=5):
    """Device time of one call of fn, apart from the host's: CUDA events
    around the replays of a CUDA graph that holds n calls, so no host work
    sits between the launches. Mean over reps replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (n * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def turns_ms(kernel, plain, iters_kernel, iters_plain, timer=None):
    """Kernel and plain version timed in turns (plain, kernel, kernel,
    plain) within one call, on one card: (kernel ms, plain ms). The timer
    is cuda_ms (host-driven loop) unless another is given."""
    timer = timer or cuda_ms
    pm = [timer(plain, iters_plain)]
    km = [timer(kernel, iters_kernel), timer(kernel, iters_kernel)]
    pm.append(timer(plain, iters_plain))
    return statistics.mean(km), statistics.mean(pm)


def check_quantized(got, ref, ref_unq, tag):
    """The warp contract: |d| <= 1 on < 1e-3 of pixels, only at .5
    rounding boundaries. Returns (mismatches, max |d|)."""
    d = (got - ref).abs()
    bad = d != 0
    n_bad = int(bad.sum())
    max_d = float(d.max()) if d.numel() else 0.0
    if max_d > 1 or n_bad >= 1e-3 * d.numel():
        raise AssertionError(f"{tag}: {n_bad} mismatches, max |d| {max_d}")
    if n_bad:
        u = ref_unq[bad]
        frac = (u - u.floor() - 0.5).abs().max().item()
        if frac >= 1e-2:
            raise AssertionError(f"{tag}: mismatch away from .5 ({frac})")
    return n_bad, max_d


def check_corr(got, want, canv, templ, tag):
    """The correlation kernel's contract against its plain version: bit-
    equal on integer inputs; on fractional inputs within (w + 1) * 2^-24 *
    sum |S||T| over the window plus one f32 ulp of the result, elementwise
    (the kernel's f32 row sums round at most w times). Returns max |d|."""
    from fastest_image_pattern_matching_tpu_torch.ops.ncc import (
        ccorr_tiled_ref)
    d = (got.double() - want.double()).abs()
    if bool((canv == canv.round()).all()):
        if not bool((d == 0).all()):
            raise AssertionError(f"{tag}: {int((d != 0).sum())} outputs "
                                 f"differ on integer inputs")
    else:
        w = templ.shape[1]
        bound = ((w + 1) * 2.0**-24
                 * ccorr_tiled_ref(canv.abs(), templ.abs()).double()
                 + 2.0**-23 * want.double().abs())
        if not bool((d <= bound).all()):
            raise AssertionError(f"{tag}: max |d| {float(d.max())} beyond "
                                 "the rounding bound")
    return float(d.max())


def grid_sample_call(src, maps, out_hw, border, idx=None):
    """The library yardstick of the warp: one F.grid_sample call computing
    the same bilinear BORDER_CONSTANT sample (zero padding of src - border,
    plus border); for a stack of sources, each map's source idx[b] is
    gathered into the input. Its sampling grid and input are made here,
    outside the timed call."""
    import torch
    import torch.nn.functional as F
    B = maps.shape[0]
    H, W = src.shape[-2:]
    Ho, Wo = out_hw
    dev = src.device
    y = torch.arange(Ho, device=dev, dtype=torch.float32)[:, None]
    x = torch.arange(Wo, device=dev, dtype=torch.float32)[None, :]
    m = maps[:, :, :, None, None]
    fx = m[:, 0, 0] * x + m[:, 0, 1] * y + m[:, 0, 2]
    fy = m[:, 1, 0] * x + m[:, 1, 1] * y + m[:, 1, 2]
    grid = torch.stack([fx * (2.0 / (W - 1)) - 1.0,
                        fy * (2.0 / (H - 1)) - 1.0], dim=-1)
    inp = ((src - border)[None, None].expand(B, 1, H, W) if idx is None
           else (src - border)[idx.long()][:, None])
    return lambda: F.grid_sample(inp, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)


# ---------------------------------------------------------------- phases

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import fastest_image_pattern_matching_tpu_torch as fipm
    from fastest_image_pattern_matching_tpu_torch import native
    from fastest_image_pattern_matching_tpu_torch.ops.cuda import (
        build, corr_kernel, descent_score_kernel, peaks_kernel, warp_kernel)

    dev = torch.device("cuda", 0)
    # Phase 1: device.
    smi = nvidia_smi_line()
    log(f"[1 device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    # Phase 2: build every kernel, one nvcc each, all started together.
    t0 = time.perf_counter()
    built = build.build_all([warp_kernel.SOURCE, corr_kernel.SOURCE,
                             peaks_kernel.SOURCE, descent_score_kernel.SOURCE])
    warp_kernel._lib()
    corr_kernel._lib()
    peaks_kernel._lib()
    descent_score_kernel._lib()
    log(f"[2 build] the four kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for path, nvcc_s, report in built:
        log(f"[2 build] {os.path.relpath(path)} nvcc {nvcc_s:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[2 build] ptxas: {line.strip()}")
    t0 = time.perf_counter()
    native_path, gxx_s = native.build()
    native.get_lib()
    log(f"[2 build] {os.path.relpath(native_path)} g++ {gxx_s:.2f} s, built "
        f"and loaded in {time.perf_counter() - t0:.2f} s")
    if sys.argv[1:] == ["peaks"]:
        print(json.dumps({"kernels": [peaks_phase(fipm, peaks_kernel, dev,
                                                  smi)]}))
        print(smi)
        print(json.dumps({"ok": True, "phases": [1, 2, 23]}), flush=True)
        return 0
    if sys.argv[1:] == ["descent"]:
        print(json.dumps({"kernels": [descent_phase(fipm, dev, smi)]}))
        print(smi)
        print(json.dumps({"ok": True, "phases": [1, 2, 24]}), flush=True)
        return 0

    single, warp = flagship_phases(fipm, warp_kernel, dev, smi)
    many, corr = many_target_phases(fipm, corr_kernel, warp_kernel, dev, smi)
    warp.update(batch_phases(fipm, warp_kernel, corr_kernel, dev, smi,
                             single, many))
    orb_phases(fipm, dev, smi)
    (warp["cli_match_launches"], corr["cli_match_launches"]), cli_matches = \
        cli_phase(fipm, warp_kernel, corr_kernel, dev, smi)
    native_phase(fipm, dev, smi, gxx_s)
    profiling_phase(fipm, dev, smi, single)
    warp["sharded_launches"], corr["sharded_launches"] = distributed_phase(
        fipm, warp_kernel, corr_kernel, dev, smi)
    warp["aot_launches"], corr["aot_launches"] = aot_phase(
        fipm, warp_kernel, corr_kernel, dev, smi, warp, corr, cli_matches)
    warp["decode_launches"], corr["decode_launches"] = decode_phase(
        fipm, warp_kernel, corr_kernel, dev, smi)
    peaks = peaks_phase(fipm, peaks_kernel, dev, smi)
    descent = descent_phase(fipm, dev, smi)
    print(json.dumps({"kernels": [warp, corr, peaks, descent]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def flagship_phases(fipm, warp_kernel, dev, smi):
    """Phases 3-5: the warp kernel against its plain version, the flagship
    end to end, the port on the card against the CPU. Returns the warp
    kernel's entry of the kernels line."""
    import torch
    from fastest_image_pattern_matching_tpu_torch.models import (
        template_matcher as tm)
    from fastest_image_pattern_matching_tpu_torch.ops import warp as W
    from fastest_image_pattern_matching_tpu_torch.ops.pyramid import (
        build_pyramid)
    from fastest_image_pattern_matching_tpu_torch.ops.rounding import f32
    from fastest_image_pattern_matching_tpu_torch.utils import geometry

    # Phase 3: kernel against plain version at the main path's shapes.
    scene, templ, truth = flagship_scene()
    cfg = flagship_config(fipm)
    pattern = fipm.learn_pattern(templ, 256, device=dev)
    plan = tm._make_plan(scene.shape, pattern, cfg)
    scene_d = torch.as_tensor(scene.astype(np.float32), device=dev)
    pyr = build_pyramid(scene_d, plan.top)
    pyr_cpu = build_pyramid(scene_d.cpu(), plan.top)
    for lv, (a, b) in enumerate(zip(pyr, pyr_cpu)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"pyramid level {lv} differs card vs CPU")
    log(f"[3 warp] pyramid card == CPU bit-equal, {plan.top + 1} levels")
    inv_sweep = torch.as_tensor(tm._top_sweep_arrays(plan)[0], device=dev)
    rng = np.random.default_rng(3)

    def roi_maps(l, n, near_border=False, angle=None):
        sh_l, sw_l = geometry.pyramid_sizes(scene.shape, plan.top)[l]
        th_l, tw_l = plan.templ_shapes[l]
        if near_border:
            p2 = np.stack([rng.uniform(-tw_l / 2, 8, n),
                           rng.uniform(sh_l - th_l - 8, sh_l - th_l / 2, n)],
                          -1)
        else:
            p2 = np.stack([rng.uniform(0, sw_l - tw_l, n),
                           rng.uniform(0, sh_l - th_l, n)], -1)
        p2 = torch.as_tensor(p2.astype(np.float32), device=dev)
        ang = (rng.uniform(-180, 180, n) if angle is None
               else np.full(n, angle))
        ang = torch.as_tensor(ang.astype(np.float32), device=dev)
        center = ((sw_l - 1) / 2.0, (sh_l - 1) / 2.0)
        ct = torch.tensor([f32(v) for v in center], device=dev)
        lt = W.rotate_pt(p2, ct, ang * f32(math.pi / 180.0))
        return (W.make_rotation_invmaps(center, ang, -(lt - 3.0))
                .contiguous(), (th_l + 6, tw_l + 6))

    shapes = {"sweep": (pyr[plan.top], inv_sweep, plan.canvas_hw,
                        float(plan.border_color))}
    for name, l, nb in (("L5", plan.top - 1, False), ("L0", 0, False),
                        ("L0_border", 0, True)):
        maps, hw = roi_maps(l, 24, nb)
        shapes[name] = (pyr[l], maps, hw, 0.0)
    for a in (0.0, 45.0, 90.0):
        maps, hw = roi_maps(0, 24, angle=a)
        shapes[f"L0 at {a:g} deg"] = (pyr[0], maps, hw, 0.0)
    shapes["identity"] = (pyr[0], torch.tensor(
        [[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]], device=dev), scene.shape, 0.0)
    # Off the main path: every tile wholly outside the image (all border),
    # and general affine maps (scale about 3) whose tap boxes exceed the
    # staging buffer, so every block (all are full 32x32 tiles) reads its
    # taps from global memory.
    shapes["outside"] = (pyr[0], torch.tensor(
        [[[0.8, 0.6, -9000.0], [-0.6, 0.8, 50.0]]], device=dev),
        (200, 300), 7.0)
    shapes["general affine"] = (pyr[0], torch.tensor(
        [[[3.0, 0.4, 10.5], [-0.3, 2.5, 20.25]],
         [[-2.7, 1.1, 3900.0], [0.9, 2.9, 100.0]]], device=dev),
        (288, 384), 0.0)

    max_err = 0.0
    warp_kernel.global_tap_blocks(reset=True)
    for name, (src, maps, hw, border) in shapes.items():
        got = warp_kernel.warp_affine_cuda(src, maps, hw, border, True)
        got_u = warp_kernel.warp_affine_cuda(src, maps, hw, border, False)
        ref = W.warp_affine_batch(src, maps, hw, border, quantize=True)
        ref_u = W.warp_affine_batch(src, maps, hw, border, quantize=False)
        torch.cuda.synchronize()
        n_bad, d = check_quantized(got, ref, ref_u, name)
        du = float((got_u - ref_u).abs().max())
        if du > 5e-3:
            raise AssertionError(f"{name}: unquantized max |d| {du}")
        max_err = max(max_err, d, du)
        n_blocks = 2 * maps.shape[0] * math.ceil(hw[0] / 32) * math.ceil(
            hw[1] / 32)
        n_global = warp_kernel.global_tap_blocks(reset=True)
        if (n_global == n_blocks) != (name == "general affine") \
                or (n_global and n_global != n_blocks):
            raise AssertionError(f"{name}: {n_global} of {n_blocks} blocks "
                                 "read their taps from global memory")
        log(f"[3 warp] {name}: {tuple(maps.shape)} -> {tuple(got.shape)} "
            f"from {tuple(src.shape)}; quantized mismatches {n_bad}, max "
            f"|d| {d} (allowed: |d| <= 1 on < 1e-3 of pixels, at .5 "
            f"boundaries only); unquantized max |d| {du} (atol 5e-3); "
            f"blocks with global taps {n_global} of {n_blocks}")
    src0, maps0, hw0, _ = shapes["identity"]
    if not torch.equal(warp_kernel.warp_affine_cuda(src0, maps0, hw0, 0.0,
                                                    True)[0], src0):
        raise AssertionError("identity warp does not reproduce the source")

    # Times: "loop" is a host-driven loop of launches (CUDA events around
    # it, host work between launches included); "device" the replay of a
    # CUDA graph of 20 launches (device time alone).
    times = {}
    for name, iters in (("sweep", 200), ("L0", 20), ("L0 at 0 deg", 20),
                        ("L0 at 45 deg", 20), ("L0 at 90 deg", 20)):
        src, maps, hw, border = shapes[name]
        kern = lambda: warp_kernel.warp_affine_cuda(src, maps, hw, border,
                                                    True)
        plain = lambda: W.warp_affine_batch(src, maps, hw, border,
                                            quantize=True)
        if name in ("sweep", "L0"):
            km, pm = turns_ms(kern, plain, iters, iters)
        else:
            km, pm = cuda_ms(kern, iters), float("nan")
        kdm = device_ms(kern)
        lib = grid_sample_call(src, maps, hw, border)
        lib_d = float((lib()[:, 0] + border - W.warp_affine_batch(
            src, maps, hw, border, quantize=False)).abs().max())
        lm, ldm = cuda_ms(lib, iters), device_ms(lib)
        bms, by = warp_bound(src, maps, hw)
        times[name] = (km, pm, lm, bms, by, kdm, ldm)
        log(f"[3 warp] time {name}: kernel loop {km:.4f} ms, device "
            f"{kdm:.4f} ms ({100 * bms / kdm:.0f}% of bound); plain loop "
            f"{pm:.4f} ms; F.grid_sample loop {lm:.4f} ms, device "
            f"{ldm:.4f} ms (its max |d| from the plain unquantized warp "
            f"{lib_d:.3g}); bound {bms:.4f} ms by {by} ({smi})")
        if name == "sweep":
            kl, ll = turns_ms(kern, lib, iters, iters)
            log(f"[3 warp] sweep loop in turns with F.grid_sample: kernel "
                f"{kl:.4f} ms, F.grid_sample {ll:.4f} ms ({smi})")
    d, rows = main_path_warps(fipm, warp_kernel, W, scene, pattern, cfg, dev,
                              plan, smi)
    max_err = max(max_err, d)

    # Phase 4: the flagship end to end, through the user entry points.
    k0 = kernel_launches()
    warp_kernel.global_tap_blocks(reset=True)
    res = fipm.match(scene, pattern, cfg, device=dev)
    torch.cuda.synchronize()
    launches = kernel_launches(k0)[0]
    n_global = warp_kernel.global_tap_blocks(reset=True)
    log(f"[4 flagship] {len(res)} matches, warp kernel launches {launches} "
        f"(blocks that read taps from global memory: {n_global})")
    for r in res:
        log(f"[4 flagship]   score {r.score:.4f} angle {r.angle:.3f} "
            f"centre ({r.center[0]:.2f}, {r.center[1]:.2f})")
    if launches <= 0:
        raise AssertionError("the main path never launched the warp kernel")
    if n_global:
        raise AssertionError("a rotation map exceeded the staging buffer")
    if len(res) != 3:
        raise AssertionError(f"expected 3 targets, found {len(res)}")
    for cx, cy, a in truth:
        r = min(res, key=lambda r: math.hypot(r.center[0] - cx,
                                              r.center[1] - cy))
        err_a = (r.angle - a + 180.0) % 360.0 - 180.0
        dist = math.hypot(r.center[0] - cx, r.center[1] - cy)
        log(f"[4 flagship]   planted ({cx:.2f}, {cy:.2f}, {a}): centre off "
            f"{dist:.3f} px, angle off {err_a:.3f} deg, score {r.score:.4f}")
        if r.score < 0.9 or dist > 2.0 or abs(err_a) > 0.5:
            raise AssertionError("flagship target not recovered")
    run = lambda: fipm.match(scene, pattern, cfg, device=dev)
    wall = log_walls("[4 flagship]", run, smi)
    prof = profile_match("[4 flagship]", run, smi)
    stage_ms = stage_times(fipm, scene, pattern, cfg, dev)
    log("[4 flagship] stages ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_ms.items()) + f" ({smi})")

    # Phase 5: the port on the card against the port on the CPU.
    s_scene, s_templ, _ = small_scene()
    s_cfg = fipm.MatchConfig(max_pos=3, score=0.5, tolerance_angle=180.0,
                             min_reduce_area=256, max_overlap=0.1)
    s_pat = fipm.learn_pattern(s_templ, 256, device="cpu")
    card_vs_cpu("[5 card vs cpu]", tm, s_scene, s_pat, s_cfg, dev, 3, 1e-4)

    km, pm, lm, bms, by, kdm, ldm = times["L0"]
    single = dict(launches=launches, wall=wall, profile=prof,
                  l0_ms=[r[2] for r in rows["L0"]], l0_bound_ms=[
                      r[5] for r in rows["L0"]], stage_ms=stage_ms)
    return single, {
        "name": "warp_affine",
        "route": "cuda",
        "source": "fastest_image_pattern_matching_tpu_torch/csrc/"
                  "warp_affine.cu",
        "replaces": "fastest_image_pattern_matching_tpu/ops/pallas/"
                    "warp_kernel.py:86",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kdm,
        "plain_ms": pm,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": ldm,
        "loop_ms": km,
        "library_loop_ms": lm,
    }


def many_target_phases(fipm, corr_kernel, warp_kernel, dev, smi):
    """Phases 6-9: the correlation kernel against its plain version, the
    Test7 many-target scene end to end, match_template on the card against
    the CPU, and a small many-target scene on the card against the CPU.
    Returns the correlation kernel's entry of the kernels line."""
    import torch
    import torch.nn.functional as F
    from fastest_image_pattern_matching_tpu_torch.models import (
        template_matcher as tm)
    from fastest_image_pattern_matching_tpu_torch.ops import ncc
    from fastest_image_pattern_matching_tpu_torch.ops import warp as W
    from fastest_image_pattern_matching_tpu_torch.ops.peaks import (
        extract_peaks)
    from fastest_image_pattern_matching_tpu_torch.ops.pyramid import (
        build_pyramid)

    # Phase 6: kernel against plain version. The Test7 top layer is the
    # main path's own input: the pyramid of the 3648x3648 scene.
    scene, templ, truth = many_target_scene(3648, 100)
    cfg = many_target_config(fipm, 100)
    pattern = fipm.learn_pattern(templ, cfg.min_reduce_area, device=dev)
    plan = tm._make_plan(scene.shape, pattern, cfg)
    top = plan.top
    log(f"[6 corr] Test7 plan: top layer {top}, canvas {plan.canvas_hw}, "
        f"template {plan.templ_shapes[top]}, {len(plan.angles)} angle, "
        f"K {plan.k_peaks}")
    pyr = build_pyramid(torch.as_tensor(scene.astype(np.float32),
                                        device=dev), top)
    t7_canv = (pyr[top] - 128.0)[None].contiguous()
    t7_templ = torch.as_tensor(pattern.levels[top].templ, device=dev) - 128.0

    s_scene, s_templ, s_truth = many_target_scene(720, 20)
    r_cfg = many_target_config(fipm, 20, 30.0)
    s_pat = fipm.learn_pattern(s_templ, 1024, device="cpu")
    r_plan = tm._make_plan(s_scene.shape, s_pat, r_cfg)
    r_top = r_plan.top
    r_pyr = build_pyramid(torch.as_tensor(s_scene.astype(np.float32),
                                          device=dev), r_top)
    r_maps = torch.as_tensor(tm._top_sweep_arrays(r_plan)[0][:8], device=dev)
    r_templ = torch.as_tensor(s_pat.levels[r_top].templ, device=dev) - 128.0
    rotated = {q: W.warp_affine_batch(r_pyr[r_top], r_maps, r_plan.canvas_hw,
                                      float(r_plan.border_color),
                                      quantize=q) - 128.0
               for q in (True, False)}

    rng = np.random.default_rng(11)

    def ints(shape):
        return torch.as_tensor(rng.integers(-128, 128, shape).astype(
            np.float32), device=dev)

    cases = [("Test7 top layer", t7_canv, t7_templ),
             ("Test7 top layer, fractional", t7_canv + torch.as_tensor(
                 rng.uniform(-0.5, 0.5, t7_canv.shape).astype(np.float32),
                 device=dev), t7_templ),
             ("8 rotated canvases, quantized", rotated[True], r_templ),
             ("8 rotated canvases, unquantized", rotated[False], r_templ),
             ("h=64 w=129", ints((1, 300, 500)), ints((64, 129))),
             ("w=2", ints((3, 70, 1000)), ints((13, 2))),
             ("h=1", ints((2, 97, 131)), ints((1, 9))),
             ("ragged 307x529 output", ints((2, 333, 555)), ints((27, 27)))]
    # One fractional patch: the blocks that stage it take the f32 path, the
    # others the int8 path, in one launch.
    mixed = t7_canv.clone()
    mixed[0, 500:540, 700:760] += 0.5
    cases.append(("Test7 top layer, one fractional patch", mixed, t7_templ))
    max_err = 0.0
    corr_kernel.path_blocks(reset=True)
    for tag, canv, tc in cases:
        got = corr_kernel.ccorr_valid_cuda(canv, tc)
        want = ncc.ccorr_tiled_ref(canv, tc)
        torch.cuda.synchronize()
        d = check_corr(got, want, canv, tc, tag)
        max_err = max(max_err, d)
        n_int8, n_f32 = corr_kernel.path_blocks(reset=True)
        exact = bool((canv == canv.round()).all())
        if (exact and n_f32) or (n_f32 == 0) != exact \
                or ("patch" in tag and not (n_int8 and n_f32)):
            raise AssertionError(f"{tag}: {n_int8} int8 and {n_f32} f32 "
                                 "blocks")
        log(f"[6 corr] {tag}: {tuple(canv.shape)} x {tuple(tc.shape)} -> "
            f"{tuple(got.shape)}; max |d| {d} ("
            + ("integer inputs: bit-equal required)" if exact else
               "fractional: (w+1) 2^-24 sum|S||T| + 1 ulp, elementwise)")
            + f"; blocks int8 {n_int8}, f32 {n_f32}")

    km, pm = turns_ms(lambda: corr_kernel.ccorr_valid_cuda(t7_canv, t7_templ),
                      lambda: ncc.ccorr_tiled_ref(t7_canv, t7_templ), 50, 5)
    assert not torch.backends.cudnn.allow_tf32
    lib = lambda: F.conv2d(t7_canv[:, None], t7_templ[None, None])
    lib_d = float((lib()[:, 0] - ncc.ccorr_tiled_ref(t7_canv, t7_templ))
                  .abs().max())
    lm = cuda_ms(lib, 20)
    bms, by = corr_bound(t7_canv, t7_templ)
    # Device time alone (CUDA graph of 20 launches): the integer canvas
    # against the same canvas plus 0.25 (every block fractional), in turns.
    frac = t7_canv + 0.25
    kdm, kdm_frac = turns_ms(
        lambda: corr_kernel.ccorr_valid_cuda(t7_canv, t7_templ),
        lambda: corr_kernel.ccorr_valid_cuda(frac, t7_templ), 20, 20,
        timer=device_ms)
    ldm = device_ms(lib, 5, 2)
    log(f"[6 corr] time Test7 top layer: kernel loop {km:.4f} ms, device "
        f"{kdm:.4f} ms ({100 * bms / kdm:.0f}% of bound), device on the "
        f"fractional canvas {kdm_frac:.4f} ms; plain (f64 conv) loop "
        f"{pm:.4f} ms; F.conv2d f32 without TF32 loop {lm:.4f} ms, device "
        f"{ldm:.4f} ms (its max |d| from the plain version {lib_d}); bound "
        f"{bms:.4f} ms by {by} ({smi})")

    # Phase 7: Test7's many-target scene end to end on the card.
    k0 = kernel_launches()
    corr_kernel.path_blocks(reset=True)
    res = fipm.match(scene, pattern, cfg, device=dev)
    torch.cuda.synchronize()
    launches = kernel_launches(k0)[1]
    n_int8, n_f32 = corr_kernel.path_blocks(reset=True)
    log(f"[7 many-target] {len(res)} matches, correlation kernel launches "
        f"{launches} (blocks on the int8 path {n_int8}, on the f32 path "
        f"{n_f32}), warp kernel launches {kernel_launches(k0)[0]}")
    if launches != 1 or n_int8 <= 0 or n_f32:
        raise AssertionError("the many-target path did not take the "
                             "correlation kernel's int8 path once")
    if len(res) != len(truth):
        raise AssertionError(f"expected {len(truth)} targets, found "
                             f"{len(res)}")
    worst = 0.0
    for cx, cy in truth:
        r = min(res, key=lambda r: math.hypot(r.center[0] - cx,
                                              r.center[1] - cy))
        dist = math.hypot(r.center[0] - cx, r.center[1] - cy)
        worst = max(worst, dist)
        if r.score < 0.99 or dist > 1.0 or r.angle != 0.0:
            raise AssertionError(f"target at ({cx}, {cy}) not recovered: "
                                 f"score {r.score}, {dist} px off, angle "
                                 f"{r.angle}")
    log(f"[7 many-target] all {len(truth)} planted washers found: scores "
        f"{min(r.score for r in res):.4f}-{max(r.score for r in res):.4f}, "
        f"centres at most {worst:.3f} px off, angle 0")
    run = lambda: fipm.match(scene, pattern, cfg, device=dev)
    wall = log_walls("[7 many-target]", run, smi)
    prof = profile_match("[7 many-target]", run, smi)
    stage_ms = stage_times(fipm, scene, pattern, cfg, dev)
    log("[7 many-target] stages ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_ms.items()) + f" ({smi})")
    lv = pattern.levels[top]
    t7_templ_u8 = t7_templ + 128.0
    smap = ncc.ncc_score_map(t7_canv + 128.0, t7_templ_u8, lv.mean, lv.norm,
                             lv.inv_area, lv.result_equal1)
    tw_t, th_t = plan.templ_shapes[top][1], plan.templ_shapes[top][0]
    score_ms = cuda_ms(lambda: ncc.ncc_score_map(
        t7_canv + 128.0, t7_templ_u8, lv.mean, lv.norm, lv.inv_area,
        lv.result_equal1), 5)
    peaks_ms = cuda_ms(lambda: extract_peaks(smap, plan.k_peaks,
                                             (tw_t, th_t), cfg.max_overlap),
                       3)
    log(f"[7 many-target] sweep split: score map {tuple(smap.shape)} "
        f"{score_ms:.3f} ms (of which the kernel {km:.3f} ms), peaks "
        f"(the peak kernel, K {plan.k_peaks}) {peaks_ms:.3f} ms ({smi})")

    # Phase 8: match_template on the card against the port on the CPU.
    src = np.random.default_rng(12).integers(0, 256, (1000, 1100),
                                             dtype=np.uint8)
    mt_templ = src[300:320, 400:424].copy()
    k0 = kernel_launches()
    on_card = fipm.match_template(src, mt_templ, device=dev)
    mt_launches = kernel_launches(k0)[1]
    on_cpu = fipm.match_template(src, mt_templ, device="cpu")
    d = float(np.abs(on_card - on_cpu).max())
    peak = np.unravel_index(np.argmax(on_card), on_card.shape)
    log(f"[8 match_template] {src.shape} x {mt_templ.shape}: card vs CPU "
        f"max |d| {d} (atol 1e-5), kernel launches {mt_launches}, peak at "
        f"{tuple(int(v) for v in peak)}")
    if d > 1e-5 or mt_launches != 1 or peak != (300, 400):
        raise AssertionError("match_template on the card disagrees")
    # The conv and fft routes on the card, on each side of the crossover of
    # the JAX package's cost rule (auto_method), which the port follows.
    big = torch.as_tensor(np.random.default_rng(13).integers(
        -128, 128, (1, 1500, 1500)).astype(np.float32), device=dev)
    for n in (350, 400):
        tc = big[0, 200:200 + n, 300:300 + n].contiguous()
        conv_ms = cuda_ms(lambda: ncc.ccorr_conv(big, tc), 1)
        fft_ms = cuda_ms(lambda: ncc.ccorr_fft(big, tc), 5)
        exact = ncc.ccorr_conv(big, tc)
        rel = float((ncc.ccorr_fft(big, tc) - exact).abs().max()
                    / exact.abs().max())
        log(f"[8 match_template] routes at (1, 1500, 1500) x ({n}, {n}): "
            f"auto takes {ncc.auto_method(1500, 1500, n, n)}; conv (f64) "
            f"{conv_ms:.3f} ms, fft {fft_ms:.3f} ms (max |d| from conv "
            f"{rel:.3g} of the largest |output|) ({smi})")

    # Phase 9: the small many-target scene, card against CPU.
    for tol in (0.0, 30.0):
        s_cfg = many_target_config(fipm, 20, tol)
        k0 = kernel_launches()
        card_vs_cpu(f"[9 card vs cpu, tol {tol:g}]", tm, s_scene, s_pat,
                    s_cfg, dev, 20, 1e-5)
        if kernel_launches(k0)[1] <= 0:
            raise AssertionError("no correlation kernel launch")

    return dict(wall=wall, profile=prof, peaks_ms=peaks_ms,
                score_ms=score_ms), {
        "name": "ccorr_valid",
        "route": "cuda",
        "source": "fastest_image_pattern_matching_tpu_torch/csrc/"
                  "ccorr_valid.cu",
        "replaces": "fastest_image_pattern_matching_tpu/ops/pallas/"
                    "corr_kernel.py:223",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kdm,
        "plain_ms": pm,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": ldm,
        "loop_ms": km,
        "library_loop_ms": lm,
        "fractional_ms": kdm_frac,
    }


def same_results(tag, got, want, atol_score, atol_pose):
    """Result arrays of one frame against another run's: valid masks
    equal, scores within atol_score, centre and angle of the valid entries
    within atol_pose. Returns the largest difference of each."""
    if not np.array_equal(got["valid"], want["valid"]):
        raise AssertionError(f"{tag}: valid masks differ: {got['valid']} vs "
                             f"{want['valid']}")
    v = want["valid"]
    d = {"score": float(np.abs(got["score"] - want["score"]).max())}
    for k in ("center", "angle"):
        d[k] = float(np.abs(got[k][v] - want[k][v]).max()) if v.any() else 0.0
    if d["score"] > atol_score or max(d["center"], d["angle"]) > atol_pose:
        raise AssertionError(f"{tag}: results differ, max |d| {d}")
    return d


def check_found(tag, res, truth, dist_px, angle_deg, min_score):
    """Each planted (cx, cy[, angle]) has a match within dist_px (and
    angle_deg); no more matches than targets. Returns the worst offset."""
    if len(res) != len(truth):
        raise AssertionError(f"{tag}: expected {len(truth)} targets, found "
                             f"{len(res)}")
    worst = 0.0
    for t in truth:
        r = min(res, key=lambda r: math.hypot(r.center[0] - t[0],
                                              r.center[1] - t[1]))
        dist = math.hypot(r.center[0] - t[0], r.center[1] - t[1])
        err_a = ((r.angle - t[2] + 180.0) % 360.0 - 180.0) if len(t) > 2 \
            else r.angle
        worst = max(worst, dist)
        if r.score < min_score or dist > dist_px or abs(err_a) > angle_deg:
            raise AssertionError(f"{tag}: target {t} not recovered: score "
                                 f"{r.score}, {dist} px, angle off {err_a}")
    return worst


def hold_batched_warps(tag, warp_kernel, W, calls):
    """Every recorded warp launch against the plain version at its own
    inputs, bit-equal. Returns the number of launches with a stack of
    sources."""
    import torch
    n_stack = 0
    for args in calls:
        src, maps, hw, border, quantize = args[:5]
        idx = args[5] if len(args) > 5 else None
        n_stack += idx is not None
        got = warp_kernel.warp_affine_cuda(*args)
        ref = W.warp_affine_batch(src, maps, hw, border, quantize=quantize,
                                  src_index=idx)
        if not torch.equal(got, ref):
            raise AssertionError(f"{tag}: warp {tuple(maps.shape)} from "
                                 f"{tuple(src.shape)} differs from the plain "
                                 f"version, max |d| "
                                 f"{float((got - ref).abs().max())}")
    log(f"{tag} {len(calls)} warp launches ({n_stack} on a stack of "
        "sources) bit-equal to the plain version at their own inputs")
    return n_stack


def warp_bound_stack(src, maps, idx, out_hw):
    """warp_bound for a stack of sources: the distinct pixels each frame's
    maps touch, summed over frames, plus the outputs."""
    B = maps.shape[0]
    n_src = sum(warp_source_pixels(src.shape[1:], maps[idx == f], out_hw)
                for f in range(src.shape[0]))
    n_out = B * out_hw[0] * out_hw[1]
    return bound_ms(4 * (n_src + n_out + 6 * B + B),
                    WARP_OPS_PER_PIXEL * n_out, F32_OPS_PER_S)


def warp_launch_only(warp_kernel, src, maps, hw, border, quantize, idx):
    """The warp kernel's launch on a stack of sources, without the
    wrapper's range check of the index (a host read, which a CUDA graph
    cannot capture), for timing the device alone on inputs the wrapper
    has checked. Returns a function that launches into one output."""
    import torch
    from fastest_image_pattern_matching_tpu_torch.ops.cuda import launch
    lib = warp_kernel._lib()
    out = torch.empty((maps.shape[0],) + tuple(hw), device=src.device)
    counter = launch.counters("warp_global_blocks", src.device, 1)

    def run():
        err = launch.launch(
            lib.fipm_warp_affine, src.device, src.data_ptr(), src.shape[1],
            src.shape[2], idx.data_ptr(), maps.data_ptr(), maps.shape[0],
            out.data_ptr(), hw[0], hw[1], float(border), int(quantize),
            counter.data_ptr())
        if err:
            raise RuntimeError(lib.fipm_error_string(err).decode())
        return out
    return run


def batch_phases(fipm, warp_kernel, corr_kernel, dev, smi, single, many):
    """Phases 10, 11, 13 and 14: the flagship as a batch of four frames,
    Test7 as a batch of two, the OCR plate and the corpus stream, each
    through the user entry points on the card. Returns the
    warp kernel's batched numbers for its entry of the kernels line."""
    import torch
    from fastest_image_pattern_matching_tpu_torch.models import (
        template_matcher as tm)
    from fastest_image_pattern_matching_tpu_torch.models.multi_template \
        import read_string
    from fastest_image_pattern_matching_tpu_torch.ops import ncc
    from fastest_image_pattern_matching_tpu_torch.ops import warp as W
    from fastest_image_pattern_matching_tpu_torch.ops.peaks import (
        extract_peaks)
    from fastest_image_pattern_matching_tpu_torch.ops.pyramid import (
        build_pyramid)

    # Phase 10: the flagship as a batch of four frames.
    frames, templ, truths = flagship_batch()
    cfg = flagship_config(fipm)
    pattern = fipm.learn_pattern(templ, 256, device=dev)
    N = frames.shape[0]
    fipm.match_many(frames, pattern, cfg, device=dev)
    k0 = kernel_launches()
    res = fipm.match_many(frames, pattern, cfg, device=dev)
    torch.cuda.synchronize()
    launches = kernel_launches(k0)[0]
    log(f"[10 flagship batch] {N} frames: warp kernel launches {launches} "
        f"per batch, against {single['launches']} per single match "
        f"({N * single['launches']} for {N} matches)")
    if not 0 < launches < N * single["launches"]:
        raise AssertionError("the frames of the batch do not share the warp "
                             "launches")
    for i, (r, t) in enumerate(zip(res, truths)):
        worst = check_found(f"[10 flagship batch] frame {i}", r, t, 2.0, 0.5,
                            0.9)
        log(f"[10 flagship batch] frame {i}: {len(r)} matches of {len(t)} "
            f"planted, centres at most {worst:.3f} px off")
    batched = fipm.match_many_arrays(frames, pattern, cfg, device=dev)
    worst = {}
    for i in range(N):
        d = same_results(f"[10 flagship batch] frame {i} vs match()",
                         {k: v[i] for k, v in batched.items()},
                         tm.match_arrays(frames[i], pattern, cfg, device=dev),
                         1e-6, 1e-5)
        worst = {k: max(worst.get(k, 0.0), v) for k, v in d.items()}
    log(f"[10 flagship batch] each frame equal to its own match() on the "
        f"card (valid masks; score 1e-6, centre and angle 1e-5): max |d| "
        f"{worst}")
    calls = record_calls(warp_kernel, "warp_affine_cuda",
                         lambda: fipm.match_many(frames, pattern, cfg,
                                                 device=dev))
    hold_batched_warps("[10 flagship batch]", warp_kernel, W, calls)
    l0 = [c for c in calls if len(c) > 5 and c[0].shape[1:] == frames.shape[1:]]
    batch_l0 = []
    for args in l0:
        kern = warp_launch_only(warp_kernel, *args)
        if not torch.equal(kern(), warp_kernel.warp_affine_cuda(*args)):
            raise AssertionError("the timed launch differs from the wrapper")
        bms, by = warp_bound_stack(args[0], args[1], args[5], args[2])
        src, maps, hw, border, quantize, idx = args
        plain_ms = cuda_ms(lambda: W.warp_affine_batch(
            src, maps, hw, border, quantize=quantize, src_index=idx), 3)
        lib_ms = device_ms(grid_sample_call(src, maps, hw, border, idx), 5,
                           2)
        batch_l0.append((device_ms(kern, 10, 3), bms, by,
                         tuple(maps.shape), plain_ms, lib_ms))
    for ms, bms, by, shape, plain_ms, lib_ms in batch_l0:
        log(f"[10 flagship batch] L0 warp {shape[0]}x{l0[0][2][0]}x"
            f"{l0[0][2][1]} from {N}x{frames.shape[1]}x{frames.shape[2]}: "
            f"device {ms:.4f} ms, bound {bms:.4f} ms by {by} "
            f"({100 * bms / ms:.0f}% of bound); plain loop {plain_ms:.4f} "
            f"ms; F.grid_sample device {lib_ms:.4f} ms; single-frame L0 "
            f"launch {single['l0_ms']} ms (bound {single['l0_bound_ms']}) "
            f"({smi})")
    run = lambda: fipm.match_many(frames, pattern, cfg, device=dev)
    wall = log_walls("[10 flagship batch]", run, smi)
    log(f"[10 flagship batch] wall per frame {wall / N:.2f} ms against "
        f"{single['wall']:.2f} ms for one match() (phase 4) ({smi})")
    share, events, syncs = profile_match("[10 flagship batch]", run, smi,
                                         frames=N)
    log(f"[10 flagship batch] per frame: busy {share:.1f}%, {events:.0f} "
        f"device events, {syncs:.0f} host copies or syncs; phase 4: busy "
        f"{single['profile'][0]:.1f}%, {single['profile'][1]:.0f} events, "
        f"{single['profile'][2]:.0f} syncs")
    stage_ms = stage_times(fipm, frames, pattern, cfg, dev)
    log("[10 flagship batch] stages ms per batch: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_ms.items()) + f" ({smi})")
    del frames, calls, l0
    torch.cuda.empty_cache()

    # Phase 11: Test7 as a batch of two frames.
    s7, t7, truth7 = many_target_scene(3648, 100)
    s8, _, truth8 = many_target_scene(3648, 100, seed=8, templ=t7)
    mframes = np.stack([s7, s8])
    mcfg = many_target_config(fipm, 100)
    mpat = fipm.learn_pattern(t7, mcfg.min_reduce_area, device=dev)
    fipm.match_many(mframes, mpat, mcfg, device=dev)
    k0 = kernel_launches()
    corr_kernel.path_blocks(reset=True)
    res = fipm.match_many(mframes, mpat, mcfg, device=dev)
    torch.cuda.synchronize()
    n_int8, n_f32 = corr_kernel.path_blocks(reset=True)
    log(f"[11 many-target batch] 2 frames: correlation kernel launches "
        f"{kernel_launches(k0)[1]} (blocks int8 {n_int8}, f32 {n_f32})")
    if kernel_launches(k0)[1] != 1 or n_int8 <= 0 or n_f32:
        raise AssertionError("the two frames did not share one int8 "
                             "correlation launch")
    for i, (r, t) in enumerate(zip(res, (truth7, truth8))):
        worst = check_found(f"[11 many-target batch] frame {i}", r, t, 1.0,
                            0.0, 0.99)
        log(f"[11 many-target batch] frame {i}: {len(r)} of {len(t)} "
            f"washers, centres at most {worst:.3f} px off")
    batched = fipm.match_many_arrays(mframes, mpat, mcfg, device=dev)
    for i in range(2):
        d = same_results(f"[11 many-target batch] frame {i} vs match()",
                         {k: v[i] for k, v in batched.items()},
                         tm.match_arrays(mframes[i], mpat, mcfg, device=dev),
                         1e-6, 1e-5)
        log(f"[11 many-target batch] frame {i} equal to its match(): max "
            f"|d| {d}")
    run = lambda: fipm.match_many(mframes, mpat, mcfg, device=dev)
    mwall = log_walls("[11 many-target batch]", run, smi)
    plan = tm._make_plan(mframes.shape[1:], mpat, mcfg)
    top = plan.top
    pyr = build_pyramid(torch.as_tensor(mframes, device=dev).float(), top)
    lv = mpat.levels[top]
    tt = torch.as_tensor(lv.templ, device=dev)
    smap = ncc.ncc_score_map(pyr[top], tt, lv.mean, lv.norm, lv.inv_area,
                             lv.result_equal1)
    th_t, tw_t = plan.templ_shapes[top]
    peaks_ms = cuda_ms(lambda: extract_peaks(smap, plan.k_peaks, (tw_t, th_t),
                                             mcfg.max_overlap), 3)
    log(f"[11 many-target batch] wall per frame {mwall / 2:.2f} ms against "
        f"{many['wall']:.2f} ms for one match() (phase 7); peak kernel on "
        f"both maps ({plan.k_peaks} rounds) {peaks_ms:.3f} ms, "
        f"{100 * peaks_ms / mwall:.0f}% of the batch's wall, against "
        f"{many['peaks_ms']:.3f} ms for one map ({smi})")
    share, events, syncs = profile_match("[11 many-target batch]", run, smi,
                                         frames=2)
    del mframes, pyr, smap
    torch.cuda.empty_cache()

    # Phase 13: the OCR plate, 36 glyphs, batched and glyph by glyph.
    plate, placed = ocr_plate()
    ocfg = ocr_config(fipm)
    m = fipm.MultiTemplateMatcher(ocfg, device=dev)
    for ch in FONT_5X7:
        m.learn(ch, glyph(ch))
    m.match_all(plate)
    k0 = kernel_launches()
    m.match_all(plate)
    torch.cuda.synchronize()
    log(f"[13 ocr] kernel launches of one batched read: warp "
        f"{kernel_launches(k0)[0]}, correlation {kernel_launches(k0)[1]} (tol "
        f"0: the canvases are the plate itself and the ROIs translated, and "
        f"the top score map is below the correlation kernel's 65536 "
        f"outputs)")
    reads, times = {}, {}
    for mode, batched_mode in (("batched", True), ("per glyph", False)):
        m.match_all(plate, batched=batched_mode)
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = m.match_all(plate, batched=batched_mode)
            ts.append((time.perf_counter() - t0) * 1e3)
        reads[mode], times[mode] = out, statistics.median(ts)
        text = read_string(out, ocfg.score)
        log(f"[13 ocr] {mode}: read {text!r}, {len(out)} matches, median "
            f"{times[mode]:.2f} ms of {[round(t, 2) for t in ts]} ({smi})")
        if text != "M12X05":
            raise AssertionError(f"[13 ocr] {mode} read {text!r}")
    a, b = reads["batched"], reads["per glyph"]
    if [x.label for x in a] != [x.label for x in b] or any(
            abs(x.result.score - y.result.score) > 1e-6
            or abs(x.result.pos_x - y.result.pos_x) > 1e-5
            or abs(x.result.pos_y - y.result.pos_y) > 1e-5
            for x, y in zip(a, b)):
        raise AssertionError("[13 ocr] batched and per-glyph matches differ")
    log(f"[13 ocr] batched labels, scores and centres equal to per glyph; "
        f"{len(FONT_5X7)} glyphs of {glyph('0').shape} on {plate.shape}: "
        f"batched {times['batched']:.2f} ms, per glyph "
        f"{times['per glyph']:.2f} ms ({smi})")

    # Phase 14: the corpus stream, 24 frames and a straggler of another
    # shape, in batches of 8.
    stpl = stream_template()
    sframes, centres = stream_frames(stpl, 24)
    straggler, s_centre = stream_frames(stpl, 1, hw=(400, 600), seed=6)
    corpus = list(sframes) + [straggler[0]]
    centres = centres + s_centre
    scfg = fipm.MatchConfig(max_pos=1, score=0.6, tolerance_angle=15.0)
    spat = fipm.learn_pattern(stpl, 256, device=dev)
    from fastest_image_pattern_matching_tpu_torch.models import corpus as cp
    list(fipm.inspect_corpus(corpus, spat, scfg, batch_size=8, device=dev))
    sizes = []
    orig = cp.match_many_arrays

    def counted(srcs, *a, **k):
        sizes.append(len(srcs))
        return orig(srcs, *a, **k)

    cp.match_many_arrays = counted
    try:
        calls = record_calls(warp_kernel, "warp_affine_cuda", lambda: list(
            fipm.inspect_corpus(corpus, spat, scfg, batch_size=8,
                                device=dev)))
    finally:
        cp.match_many_arrays = orig
    n_stack = hold_batched_warps("[14 corpus]", warp_kernel, W, calls)
    if sizes != [8, 8, 8, 1] or not n_stack:
        raise AssertionError(f"[14 corpus] batches {sizes}, {n_stack} "
                             "launches on a stack of sources")
    k0 = kernel_launches()
    reports = list(fipm.inspect_corpus(corpus, spat, scfg, batch_size=8,
                                       device=dev))
    torch.cuda.synchronize()
    if kernel_launches(k0)[0] <= 0:
        raise AssertionError("[14 corpus] no warp kernel launch")
    if [r.index for r in reports] != list(range(len(corpus))):
        raise AssertionError("[14 corpus] reports out of order")
    worst = max(check_found(f"[14 corpus] frame {r.index}", r.results,
                            [c], 1.0, 1.0, 0.6)
                for r, c in zip(reports, centres))
    ms = [r.execution_ms for r in reports]
    log(f"[14 corpus] {len(corpus)} frames in batches {sizes}, warp kernel "
        f"launches {kernel_launches(k0)[0]}: target found "
        f"in every frame, at most {worst:.3f} px off; ms per frame "
        f"{[round(v, 3) for v in sorted(set(ms), key=ms.index)]} (batches "
        f"of 8, 8, 8, then the {straggler.shape[1]}x{straggler.shape[2]} "
        f"straggler alone) ({smi})")

    return {"batch_launches": launches,
            "batch_l0_ms": [r[0] for r in batch_l0],
            "batch_l0_bound_ms": [r[1] for r in batch_l0],
            "batch_l0_plain_ms": [r[4] for r in batch_l0],
            "batch_l0_library_ms": [r[5] for r in batch_l0],
            "batch_l0_shapes": [list(r[3]) for r in batch_l0]}


def orb_fields(r):
    """An ORBResult's fields as numpy arrays / numbers, for equality."""
    return {k: (np.asarray(v) if v is not None else None)
            for k, v in dataclasses.asdict(r).items()}


def orb_same(tag, got, want):
    """Two ORBResults equal field by field, bit for bit."""
    a, b = orb_fields(got), orb_fields(want)
    for k in a:
        if (a[k] is None) != (b[k] is None) or (
                a[k] is not None and not np.array_equal(a[k], b[k])):
            raise AssertionError(f"{tag}: {k} differs: {a[k]} vs {b[k]}")


def corner_err(res, truth):
    """Largest distance (px) of res.corners from the true corners."""
    if not res.is_matched or res.corners is None:
        return math.inf
    return float(np.abs(np.linalg.norm(res.corners - truth, axis=1)).max())


def orb_split(orb, scene, templ, cfg, dev, seed=0):
    """CUDA-event times of one orb_match's stages, composed from the same
    functions it runs: upload, detect (template and source), match
    (Hamming and the best N), RANSAC (hypotheses and LO refits), and the
    packed copy back."""
    import torch
    from fastest_image_pattern_matching_tpu_torch.models.template_matcher \
        import upload_frames
    marks = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))

    torch.cuda.synchronize()
    mark("start")
    tpl = upload_frames(templ, dev)[None]
    src = upload_frames(scene[None], dev)
    mark("upload")
    pt, dt, vt = orb._detect_and_describe(tpl, cfg)
    feats = orb._detect_and_describe(src, cfg)
    mark("detect")
    s_pts, t_pts, good, _ = orb._good_matches(feats, (pt[0], dt[0], vt[0]),
                                              cfg.max_good_matches)
    mark("match")
    H, mask = orb._ransac(s_pts, t_pts, good, cfg.ransac_threshold,
                          orb._ransac_samples(seed, cfg.ransac_iters,
                                              str(dev)))
    mark("ransac")
    torch.cat([H.reshape(1, 9), mask.float()], 1).cpu()
    mark("copy back")
    torch.cuda.synchronize()
    return {name: prev.elapsed_time(e)
            for (_, prev), (name, e) in zip(marks, marks[1:])}


def orb_phases(fipm, dev, smi):
    """Phases 15-16: ORB on one pair at the ORB bench's size and at the
    flagship's, card against CPU; then orb_match_many against per-frame
    orb_match. Nothing here launches either hand-written kernel: ORB is
    plain PyTorch, as it is plain jnp in the JAX package."""
    import torch
    from fastest_image_pattern_matching_tpu_torch.models import orb

    cfg = fipm.ORBConfig()
    pairs = orb_pairs()
    for name, scene, templ, truth in pairs:
        tag = f"[15 orb {name}]"
        fipm.orb_match(scene, templ, cfg, device=dev)
        res = fipm.orb_match(scene, templ, cfg, device=dev)
        err = corner_err(res, truth)
        log(f"{tag} scene {scene.shape[1]}x{scene.shape[0]}, template "
            f"{templ.shape[1]}x{templ.shape[0]}: matched {res.is_matched}, "
            f"{res.num_inliers} inliers of {res.num_good_matches} good "
            f"matches, corners at most {err:.3f} px from the truth, "
            f"rotation {res.rotation_angle:.3f} deg")
        if not res.is_matched or err > 3.0:
            raise AssertionError(f"{tag} homography not recovered")
        t0 = time.perf_counter()
        cpu = fipm.orb_match(scene, templ, cfg, device="cpu")
        cpu_s = time.perf_counter() - t0
        d = float(np.abs(res.corners - cpu.corners).max()) \
            if cpu.is_matched else math.inf
        log(f"{tag} card vs CPU (same draws): matched {res.is_matched} / "
            f"{cpu.is_matched}, inliers {res.num_inliers} / "
            f"{cpu.num_inliers}, corners max |d| {d:.6f} px; the CPU call "
            f"took {cpu_s:.2f} s")
        if cpu.is_matched != res.is_matched \
                or cpu.num_inliers != res.num_inliers or d > 0.5:
            raise AssertionError(f"{tag} the card disagrees with the CPU")
        run = lambda: fipm.orb_match(scene, templ, cfg, device=dev)
        log_walls(tag, run, smi)
        split = [orb_split(orb, scene, templ, cfg, dev) for _ in range(3)]
        log(f"{tag} split ms (CUDA events, median of 3): " + ", ".join(
            f"{k} {statistics.median(x[k] for x in split):.3f}"
            for k in split[0]) + f" ({smi})")
        profile_match(tag, run, smi)
        del scene
        torch.cuda.empty_cache()

    # Phase 16: orb_match_many against per-frame orb_match.
    templ = pairs[0][2]
    frames, truths = orb_frames(templ)
    many = fipm.orb_match_many(frames, templ, cfg, device=dev)
    for i, (r, t) in enumerate(zip(many, truths)):
        orb_same(f"[16 orb many] frame {i}", r,
                 fipm.orb_match(frames[i], templ, cfg, device=dev))
        err = corner_err(r, t) if t is not None else None
        log(f"[16 orb many] frame {i}: part {'in' if t is not None else
            'absent'}, matched {r.is_matched}, {r.num_inliers} inliers"
            + (f", corners at most {err:.3f} px off" if t is not None
               else ""))
        if t is not None and err > 3.0:
            raise AssertionError(f"[16 orb many] frame {i}: part not found")
    held = min(r.num_inliers for r, t in zip(many, truths) if t is not None)
    stray = max(r.num_inliers for r, t in zip(many, truths) if t is None)
    if stray >= held:
        raise AssertionError(f"[16 orb many] a frame without the part has "
                             f"{stray} inliers, one with it {held}")
    log(f"[16 orb many] each of {len(frames)} frames equal to its own "
        f"orb_match on the card, field by field; inliers {held} or more "
        f"with the part, {stray} or fewer without")
    n = len(frames)
    wall_many = log_walls(f"[16 orb many] batch of {n}", lambda:
                          fipm.orb_match_many(frames, templ, cfg,
                                              device=dev), smi, n=3)
    wall_one = log_walls("[16 orb many] one frame", lambda: fipm.orb_match(
        frames[0], templ, cfg, device=dev), smi)
    log(f"[16 orb many] wall per frame {wall_many / n:.2f} ms against "
        f"{wall_one:.2f} ms for one orb_match ({wall_many / n / wall_one:.2f}"
        f"x) ({smi})")
    profile_match(f"[16 orb many] batch of {n}", lambda: fipm.orb_match_many(
        frames, templ, cfg, device=dev), smi, frames=n)


def cli_phase(fipm, warp_kernel, corr_kernel, dev, smi):
    """Phase 17: the CLI through its normal entry point, cli.main(argv),
    on images written with save_gray to a temporary directory and with
    its settings in a temporary file; then one fresh `python -m` process.
    Returns the warp and correlation kernel launches of the in-process
    `match` run, and its JSON matches."""
    import contextlib
    import io
    import tempfile
    import torch
    from fastest_image_pattern_matching_tpu_torch import cli
    from fastest_image_pattern_matching_tpu_torch.utils.imageio import (
        save_gray)

    def run_cli(argv):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if rc != 0:
            raise AssertionError(f"[17 cli] {argv[0]} exited {rc}: "
                                 f"{out.getvalue()[-2000:]}")
        return out.getvalue(), ms

    old_env = os.environ.get("FIPM_TPU_SETTINGS")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["FIPM_TPU_SETTINGS"] = os.path.join(tmp, "settings.json")
        try:
            scene, templ, _ = flagship_scene()
            src_p, tpl_p = (os.path.join(tmp, f) for f in ("src.bmp",
                                                             "tpl.bmp"))
            save_gray(src_p, scene)
            save_gray(tpl_p, templ)
            cfg = flagship_config(fipm)
            argv = ["match", "-s", src_p, "-t", tpl_p, "--json",
                    "--max-pos", "3", "--score", "0.7", "--tolerance-angle",
                    "180", "--max-overlap", "0.1"]
            run_cli(argv)
            k0 = kernel_launches()
            text, ms = run_cli(argv)
            launches = kernel_launches(k0)
            got = json.loads(text)
            want = fipm.match(scene, fipm.learn_pattern(templ, 256,
                                                        device=dev),
                              cfg, device=dev)
            same = got["count"] == len(want) == 3 and all(
                m["score"] == r.score and m["angle"] == r.angle
                and m["pos_x"] == r.pos_x and m["pos_y"] == r.pos_y
                for m, r in zip(got["matches"], want))
            log(f"[17 cli] match --json: {got['count']} targets, equal to "
                f"match(): {same}; warp kernel launches {launches[0]}, "
                f"correlation {launches[1]}; execution_ms "
                f"{got['execution_ms']}, call {ms:.2f} ms in process "
                f"({smi})")
            if not same or launches[0] <= 0:
                raise AssertionError("[17 cli] match differs from match() "
                                     "or launched no warp kernel")

            name, oscene, otempl, otruth = orb_pairs()[0]
            osrc, otpl = (os.path.join(tmp, f) for f in ("osrc.bmp",
                                                           "otpl.bmp"))
            save_gray(osrc, oscene)
            save_gray(otpl, otempl)
            text, ms = run_cli(["orb", "-s", osrc, "-t", otpl, "--json"])
            o = json.loads(text)
            err = float(np.abs(np.linalg.norm(
                np.asarray(o["corners"]) - otruth, axis=1)).max()) \
                if o["corners"] is not None else math.inf
            log(f"[17 cli] orb --json ({name}): matched {o['is_matched']}, "
                f"{o['num_inliers']} inliers, corners at most {err:.3f} px "
                f"off; execution_ms {o['execution_ms']}, call {ms:.2f} ms")
            if not o["is_matched"] or err > 3.0:
                raise AssertionError("[17 cli] orb missed the homography")

            gdir = os.path.join(tmp, "glyphs")
            os.makedirs(gdir)
            for ch in FONT_5X7:
                save_gray(os.path.join(gdir, f"{ch}.bmp"), glyph(ch))
            plate, _ = ocr_plate()
            plate_p = os.path.join(tmp, "plate.bmp")
            save_gray(plate_p, plate)
            ocfg = ocr_config(fipm)
            text, ms = run_cli([
                "ocr", "--glyphs-dir", gdir, "-s", plate_p, "--json",
                "--score", str(ocfg.score), "--max-pos", str(ocfg.max_pos),
                "--tolerance-angle", str(ocfg.tolerance_angle),
                "--max-overlap", str(ocfg.max_overlap),
                "--min-reduce-area", str(ocfg.min_reduce_area)])
            o = json.loads(text)
            log(f"[17 cli] ocr --json: read {o['text']!r} with "
                f"{o['glyphs']} glyphs, time_ms {o['time_ms']:.2f}, call "
                f"{ms:.2f} ms")
            if o["text"] != "M12X05":
                raise AssertionError(f"[17 cli] ocr read {o['text']!r}")

            wdir = os.path.join(tmp, "watch")
            os.makedirs(wdir)
            stpl = stream_template()
            sframes, centres = stream_frames(stpl, 3)
            for i, f in enumerate(sframes):
                save_gray(os.path.join(wdir, f"frame{i}.bmp"), f)
            stpl_p = os.path.join(tmp, "part.bmp")
            save_gray(stpl_p, stpl)
            jsonl = os.path.join(tmp, "watch.jsonl")
            text, ms = run_cli(["watch", "-t", stpl_p, "--directory", wdir,
                                "--max-frames", "3", "--out", jsonl,
                                "--max-pos", "1", "--score", "0.6",
                                "--tolerance-angle", "15"])
            with open(jsonl) as f:
                recs = [json.loads(line) for line in f]
            offs = [math.hypot(r["matches"][0]["pos_x"] - c[0],
                               r["matches"][0]["pos_y"] - c[1])
                    if r["count"] == 1 else math.inf
                    for r, c in zip(recs, centres)]
            log(f"[17 cli] watch: {len(recs)} records, the part at most "
                f"{max(offs):.3f} px off; execution_ms "
                f"{[round(r['execution_ms'], 2) for r in recs]}, call "
                f"{ms:.2f} ms")
            if len(recs) != 3 or max(offs) > 1.0:
                raise AssertionError("[17 cli] watch missed a frame")

            text, _ = run_cli(["settings"])
            st = json.loads(text)["settings"]
            log(f"[17 cli] settings: {len(st)} keys, last_source "
                f"{os.path.basename(st.get('last_source', ''))!r}")
            if st.get("last_source") != src_p or st.get("max_pos") != 3:
                raise AssertionError("[17 cli] settings not saved")

            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m",
                 "fastest_image_pattern_matching_tpu_torch.cli"] + argv,
                capture_output=True, text=True, timeout=300,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            proc_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"[17 cli] fresh process exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            fresh = json.loads(proc.stdout.strip().splitlines()[-1])
            if fresh["matches"] != got["matches"]:
                raise AssertionError("[17 cli] the fresh process's matches "
                                     "differ")
            log(f"[17 cli] fresh process match --json: {fresh['count']} "
                f"targets, equal to the in-process run; first call "
                f"execution_ms {fresh['execution_ms']} (kernel loading "
                f"included) against {got['execution_ms']} warm; process "
                f"wall {proc_s:.2f} s ({smi})")
        finally:
            if old_env is None:
                os.environ.pop("FIPM_TPU_SETTINGS", None)
            else:
                os.environ["FIPM_TPU_SETTINGS"] = old_env
    return launches, got["matches"]


def record_calls(module, name, run):
    """Run `run` with module.<name> wrapped so that every call's arguments
    are kept (tensors cloned); returns [args]."""
    import torch
    orig = getattr(module, name)
    calls = []

    def recorder(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args))
        return orig(*args)

    setattr(module, name, recorder)
    try:
        run()
    finally:
        setattr(module, name, orig)
    return calls


def main_path_warps(fipm, warp_kernel, W, scene, pattern, cfg, dev, plan,
                    smi):
    """Every warp launch of one flagship match, recorded with its own
    inputs, held against the plain version (ops/warp.py::warp_affine_batch)
    under phase 3's contract, then timed alone: one line per pyramid level
    with the launches per match, the shapes, the kernel's device time and
    host-loop time, F.grid_sample's device time and the bound, and the
    level's share of launches x (device time - bound). Returns the largest
    |d| from the plain version."""
    import torch
    from fastest_image_pattern_matching_tpu_torch.utils import geometry
    calls = record_calls(warp_kernel, "warp_affine_cuda",
                         lambda: fipm.match(scene, pattern, cfg, device=dev))
    sizes = geometry.pyramid_sizes(scene.shape, plan.top)
    rows, max_err = {}, 0.0
    for src, maps, hw, border, quantize in calls:
        lv = sizes.index(tuple(src.shape))
        tag = "sweep" if lv == plan.top else f"L{lv}"
        got = warp_kernel.warp_affine_cuda(src, maps, hw, border, quantize)
        ref_u = W.warp_affine_batch(src, maps, hw, border, quantize=False)
        if quantize:
            ref = W.warp_affine_batch(src, maps, hw, border, quantize=True)
            _, d = check_quantized(got, ref, ref_u, f"main path {tag}")
        else:
            d = float((got - ref_u).abs().max())
            if d > 5e-3:
                raise AssertionError(f"main path {tag}: unquantized max |d| "
                                     f"{d}")
        max_err = max(max_err, d)
        kern = lambda: warp_kernel.warp_affine_cuda(src, maps, hw, border,
                                                    quantize)
        kdm, km = device_ms(kern), cuda_ms(kern, 20)
        ldm = device_ms(grid_sample_call(src, maps, hw, border))
        bms, _ = warp_bound(src, maps, hw)
        rows.setdefault(tag, []).append(
            (tuple(maps.shape[:1]) + tuple(hw), tuple(src.shape), kdm, km,
             ldm, bms))
    loss = {t: sum(r[2] - r[5] for r in rs) for t, rs in rows.items()}
    total = sum(loss.values()) or 1.0
    for tag, rs in rows.items():
        log(f"[3 warp] main path {tag}: {len(rs)} launches per match; "
            + "; ".join(f"{'x'.join(map(str, o))} from "
                        f"{'x'.join(map(str, i))}: device {d:.4f} ms, loop "
                        f"{k:.4f} ms, F.grid_sample device {g:.4f} ms, bound "
                        f"{b:.4f} ms" for o, i, d, k, g, b in rs)
            + f"; launches x (device - bound) {loss[tag]:.4f} ms "
            f"({100 * loss[tag] / total:.0f}%) ({smi})")
    log(f"[3 warp] main path: {len(calls)} launches held against the plain "
        f"version, max |d| {max_err}")
    return max_err, rows


def native_phase(fipm, dev, smi, gxx_s):
    """Phase 18: the native host library (built in phase 2, in gxx_s
    seconds of g++): the BMP codec against its numpy twin, threaded
    against sequential decode through FileSource, inspect_corpus over a
    FolderSource of BMPs."""
    import torch
    from fastest_image_pattern_matching_tpu_torch import native
    from fastest_image_pattern_matching_tpu_torch.native import bmp
    from fastest_image_pattern_matching_tpu_torch.utils import imageio
    from fastest_image_pattern_matching_tpu_torch.utils.sources import (
        FolderSource)

    if not os.path.exists(native.library_path()) or native._LIB is None:
        raise AssertionError("[18 native] the library was not built and "
                             "loaded in phase 2")
    log(f"[18 native] {os.path.relpath(native.library_path())} loaded, "
        f"built by g++ from this checkout's source in {gxx_s:.2f} s "
        f"(phase 2)")
    with tempfile.TemporaryDirectory() as tmp:
        img = np.random.default_rng(18).integers(0, 256, (37, 53), np.uint8)
        p = os.path.join(tmp, "codec.bmp")
        bmp.save_gray(p, img)
        with open(p, "rb") as f:
            if f.read() != imageio._bmp_gray_bytes(img):
                raise AssertionError("[18 native] the native writer's bytes "
                                     "differ from the numpy twin's")
        for got in (bmp.load_gray(p), imageio._bmp_gray(p),
                    imageio.load_gray(p)):
            if not np.array_equal(got, img):
                raise AssertionError("[18 native] a BMP read differs")
        log("[18 native] codec: native write byte-equal to the numpy twin, "
            "native and numpy reads pixel-equal")

        stpl = stream_template()
        sframes, centres = stream_frames(stpl, 24)
        fframes = flagship_batch()[0]
        folders = {}
        for name, frames in (("480x640", sframes), ("4024x3036", fframes)):
            d = os.path.join(tmp, name)
            os.makedirs(d)
            for i, f in enumerate(frames):
                bmp.save_gray(os.path.join(d, f"{i:03d}.bmp"), f)
            folders[name] = d
            ms = {}
            for n_threads in (1, 4, 1, 4):
                t0 = time.perf_counter()
                got = list(FolderSource(d, n_threads=n_threads))
                ms.setdefault(n_threads, []).append(
                    (time.perf_counter() - t0) * 1e3 / len(frames))
                if len(got) != len(frames) or not all(
                        np.array_equal(a, b) for a, b in zip(got, frames)):
                    raise AssertionError(f"[18 native] {name}: frames "
                                         f"decoded on {n_threads} threads "
                                         "differ")
            log(f"[18 native] FileSource over {len(frames)} {name} BMPs, ms "
                f"per frame (two runs each, in turns): 1 thread "
                f"{ms[1]}, 4 threads {ms[4]}; frames equal")
        del fframes

        scfg = fipm.MatchConfig(max_pos=1, score=0.6, tolerance_angle=15.0)
        spat = fipm.learn_pattern(stpl, 256, device=dev)
        reports, ms = {}, {}
        for n_threads in (4, 1, 4, 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reports[n_threads] = list(fipm.inspect_corpus(
                FolderSource(folders["480x640"], n_threads=n_threads), spat,
                scfg, batch_size=8, device=dev))
            ms.setdefault(n_threads, []).append(
                (time.perf_counter() - t0) * 1e3 / len(sframes))
        a, b = reports[1], reports[4]
        if [r.index for r in a] != [r.index for r in b] or any(
                [(m.score, m.pos_x, m.pos_y, m.angle) for m in x.results]
                != [(m.score, m.pos_x, m.pos_y, m.angle) for m in y.results]
                for x, y in zip(a, b)):
            raise AssertionError("[18 native] inspect_corpus reports differ "
                                 "between 1 and 4 decode threads")
        worst = max(check_found(f"[18 native] frame {r.index}", r.results,
                                [c], 1.0, 1.0, 0.6)
                    for r, c in zip(a, centres))
        log(f"[18 native] inspect_corpus over FolderSource of the 24 "
            f"480x640 BMPs, wall ms per frame (decode included, first run a "
            f"warm-up): 4 threads {ms[4]}, 1 thread {ms[1]}; reports equal, "
            f"target in every frame, at most {worst:.3f} px off ({smi})")
    if bmp.FALLBACKS:
        raise AssertionError(f"[18 native] {bmp.FALLBACKS} fallbacks to the "
                             "numpy codec")
    log("[18 native] no fallback to the numpy codec")


def profiling_phase(fipm, dev, smi, single):
    """Phase 19: the port's span table against device_trace's Chrome
    trace of the same flagship match: every stage span in both, on one
    clock (each table span within 5 ms of the trace's range of the same
    name and order), the children of fipm.match covering at least 95% of
    its host time, and the warp kernel named."""
    import torch
    from fastest_image_pattern_matching_tpu_torch.utils import profiling
    from fastest_image_pattern_matching_tpu_torch.utils.profiling import (
        device_trace)

    scene, templ, _ = flagship_scene()
    cfg = flagship_config(fipm)
    pattern = fipm.learn_pattern(templ, 256, device=dev)
    fipm.match(scene, pattern, cfg, device=dev)
    splits = [stage_times(fipm, scene, pattern, cfg, dev) for _ in range(3)]
    log("[19 profiling] stage host ms from the span table (medians of 3; "
        "phase 4's): " + ", ".join(
            f"{k} {statistics.median(s[k] for s in splits):.3f}/"
            f"{single['stage_ms'].get(k, float('nan')):.3f}"
            for k in splits[0]) + f" ({smi})")
    profiling.reset_spans()
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp):
            fipm.match(scene, pattern, cfg, device=dev)
            torch.cuda.synchronize()
        rows = profiling.spans()
        profiling.reset_spans()
        with open(os.path.join(tmp, "trace.json")) as f:
            trace = json.load(f)
    events = trace["traceEvents"]
    names = [e.get("name", "") for e in events]
    n_warp = sum("warp_affine_kernel" in n for n in names)
    # Chrome trace times: us after baseTimeNanoseconds; the table's: ns
    # on the same clock.
    base = trace.get("baseTimeNanoseconds", 0)
    ranges = sorted((base + e["ts"] * 1e3, base + (e["ts"] + e["dur"]) * 1e3,
                     e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith("fipm."))
    entry = next(i for i, r in enumerate(rows) if r.name == "fipm.match")
    whole = rows[entry].end_ns - rows[entry].start_ns
    kids = sum(r.end_ns - r.start_ns for r in rows if r.parent == entry)
    far = [(r.name, n) for r, (a, b, n) in zip(rows, ranges)
           if r.name != n or abs(r.start_ns - a) > 5e6
           or abs(r.end_ns - b) > 5e6]
    log(f"[19 profiling] device_trace: {len(names)} trace events, "
        f"{n_warp} of the warp kernel (warp_affine_kernel); span table "
        f"{len(rows)} rows, trace {len(ranges)} fipm ranges, fipm.match "
        f"{whole / 1e6:.3f} ms, its children cover {kids / whole:.4f}")
    if not n_warp:
        raise AssertionError("[19 profiling] the trace does not name the "
                             "warp kernel")
    if len(ranges) != len(rows) or far:
        raise AssertionError(f"[19 profiling] the table and the trace "
                             f"disagree: {len(rows)} rows, {len(ranges)} "
                             f"ranges, off: {far[:5]}")
    if kids < 0.95 * whole:
        raise AssertionError("[19 profiling] fipm.match's children cover "
                             f"{kids / whole:.4f} of it")


def distributed_phase(fipm, warp_kernel, corr_kernel, dev, smi):
    """Phase 20: the sharded entry points under NCCL at world size 1,
    each against its unsharded twin, with the kernels launched on the
    sharded path. Returns the warp kernel's launches of the sharded
    flagship batch and the correlation kernel's of the sharded Test7
    batch."""
    import torch
    import torch.distributed as dist
    from fastest_image_pattern_matching_tpu_torch.models.batch import (
        _results_from_arrays)
    from fastest_image_pattern_matching_tpu_torch.models.multi_template \
        import LabeledMatch, read_string

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    fipm.init_distributed("nccl", f"tcp://127.0.0.1:{port}", 1, 0)
    try:
        mesh = fipm.make_mesh((1, 1))
        dmesh = fipm.make_data_mesh()
        log(f"[20 distributed] NCCL world 1 at tcp://127.0.0.1:{port}: mesh "
            f"{mesh.shape} on {mesh.device}, data mesh {dmesh.shape}, backend "
            f"{dist.get_backend()}")
        walls = {}

        def twin(tag, sharded, unsharded, n=5):
            """Walls of n runs each after a warm-up, in turns (sharded,
            unsharded, unsharded, sharded, ...)."""
            runs = {sharded: [], unsharded: []}
            sharded()
            unsharded()
            for i in range(n):
                for run in ((sharded, unsharded) if i % 2 == 0
                            else (unsharded, sharded)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    runs[run].append((time.perf_counter() - t0) * 1e3)
            s, u = (statistics.median(runs[r]) for r in (sharded, unsharded))
            walls[tag] = (s, u)
            log(f"{tag} wall ms in turns ({n} runs each after warm-up): "
                f"sharded median {s:.2f}, all "
                f"{[round(w, 2) for w in runs[sharded]]}; unsharded median "
                f"{u:.2f}, all {[round(w, 2) for w in runs[unsharded]]} "
                f"({smi})")
            # The host time inside the mesh's gathers of one sharded call
            # (NCCL at world 1: the collectives' own cost).
            spent = []
            gather = type(mesh).all_gather

            def timed(self, *a, **k):
                t0 = time.perf_counter()
                try:
                    return gather(self, *a, **k)
                finally:
                    spent.append(time.perf_counter() - t0)

            type(mesh).all_gather = timed
            try:
                torch.cuda.synchronize()
                sharded()
                torch.cuda.synchronize()
            finally:
                type(mesh).all_gather = gather
            log(f"{tag} one sharded call: {len(spent)} gathers, "
                f"{1e3 * sum(spent):.3f} ms of host time in them ({smi})")

        # The flagship batch (phase 10).
        frames, templ, _ = flagship_batch()
        cfg = flagship_config(fipm)
        pattern = fipm.learn_pattern(templ, 256, device=dev)
        want = fipm.match_many_arrays(frames, pattern, cfg, device=dev)
        k0 = kernel_launches()
        got = fipm.match_batch_sharded(frames, pattern, cfg, mesh)
        torch.cuda.synchronize()
        warp_launches = kernel_launches(k0)[0]
        for i in range(frames.shape[0]):
            same_results(f"[20 distributed] flagship frame {i}",
                         {k: v[i] for k, v in got.items()},
                         {k: v[i] for k, v in want.items()}, 1e-6, 1e-5)
        log(f"[20 distributed] match_batch_sharded on the 4-frame flagship "
            f"batch equal to match_many_arrays (valid masks; score 1e-6, "
            f"centre and angle 1e-5), {int(got['valid'].sum())} matches; "
            f"warp kernel launches {warp_launches}")
        if warp_launches <= 0:
            raise AssertionError("[20 distributed] the sharded flagship "
                                 "batch never launched the warp kernel")
        twin("[20 distributed] flagship batch", lambda: fipm.
             match_batch_sharded(frames, pattern, cfg, mesh), lambda: fipm.
             match_many_arrays(frames, pattern, cfg, device=dev))
        del frames
        torch.cuda.empty_cache()

        # Test7 as a batch of two (phase 11).
        s7, t7, truth7 = many_target_scene(3648, 100)
        s8, _, truth8 = many_target_scene(3648, 100, seed=8, templ=t7)
        mframes = np.stack([s7, s8])
        mcfg = many_target_config(fipm, 100)
        mpat = fipm.learn_pattern(t7, mcfg.min_reduce_area, device=dev)
        want = fipm.match_many_arrays(mframes, mpat, mcfg, device=dev)
        k0 = kernel_launches()
        got = fipm.match_batch_sharded(mframes, mpat, mcfg, mesh)
        torch.cuda.synchronize()
        corr_launches = kernel_launches(k0)[1]
        for i in range(2):
            same_results(f"[20 distributed] Test7 frame {i}",
                         {k: v[i] for k, v in got.items()},
                         {k: v[i] for k, v in want.items()}, 1e-6, 1e-5)
        log(f"[20 distributed] match_batch_sharded on Test7's batch of two "
            f"equal to match_many_arrays, {got['valid'].sum(1).tolist()} "
            f"washers; correlation kernel launches {corr_launches}")
        if got["valid"].sum() != len(truth7) + len(truth8) \
                or corr_launches <= 0:
            raise AssertionError("[20 distributed] the sharded Test7 batch "
                                 "lost washers or launched no correlation")
        twin("[20 distributed] Test7 batch", lambda: fipm.
             match_batch_sharded(mframes, mpat, mcfg, mesh), lambda: fipm.
             match_many_arrays(mframes, mpat, mcfg, device=dev))
        del mframes, s7, s8
        torch.cuda.empty_cache()

        # ORB over phase 16's frames.
        ocfg = fipm.ORBConfig()
        otempl = orb_template((200, 200), 51)  # phase 15's small pair's
        oframes, _ = orb_frames(otempl)
        want = fipm.orb_match_many(oframes, otempl, ocfg, device=dev)
        got = fipm.orb_match_many_sharded(oframes, otempl, ocfg, mesh=dmesh)
        for i, (g, w) in enumerate(zip(got, want)):
            orb_same(f"[20 distributed] orb frame {i}", g, w)
        log(f"[20 distributed] orb_match_many_sharded equal to "
            f"orb_match_many field by field on {len(want)} frames "
            f"(inliers {[r.num_inliers for r in got]})")
        twin("[20 distributed] orb batch", lambda: fipm.
             orb_match_many_sharded(oframes, otempl, ocfg, mesh=dmesh),
             lambda: fipm.orb_match_many(oframes, otempl, ocfg, device=dev))

        # The OCR plate (phase 13).
        plate, _ = ocr_plate()
        gcfg = ocr_config(fipm)
        labels = list(FONT_5X7)
        pats = [fipm.learn_pattern(glyph(ch), gcfg.min_reduce_area,
                                   device=dev) for ch in labels]
        want = fipm.match_patterns(plate, pats, gcfg, device=dev)
        got = fipm.match_patterns_sharded(plate, pats, gcfg, mesh=dmesh)
        found = []
        for ch, p, g, w in zip(labels, pats, got, want):
            same_results(f"[20 distributed] glyph {ch}", g, w, 1e-6, 1e-5)
            found += [LabeledMatch(ch, r) for r in _results_from_arrays(
                {k: v[None] for k, v in g.items()}, 0, p)]
        text = read_string(found, gcfg.score)
        log(f"[20 distributed] match_patterns_sharded equal to "
            f"match_patterns on {len(pats)} glyphs; read {text!r}")
        if text != "M12X05":
            raise AssertionError(f"[20 distributed] read {text!r}")
        twin("[20 distributed] ocr plate", lambda: fipm.
             match_patterns_sharded(plate, pats, gcfg, mesh=dmesh),
             lambda: fipm.match_patterns(plate, pats, gcfg, device=dev))

        # The corpus stream (phase 14).
        stpl = stream_template()
        sframes, _ = stream_frames(stpl, 24)
        straggler, _ = stream_frames(stpl, 1, hw=(400, 600), seed=6)
        corpus = list(sframes) + [straggler[0]]
        scfg = fipm.MatchConfig(max_pos=1, score=0.6, tolerance_angle=15.0)
        spat = fipm.learn_pattern(stpl, 256, device=dev)
        sharded = lambda: list(fipm.inspect_corpus(
            corpus, spat, scfg, mesh=mesh, batch_size=8))
        unsharded = lambda: list(fipm.inspect_corpus(
            corpus, spat, scfg, batch_size=8, device=dev))
        a, b = sharded(), unsharded()
        if [r.index for r in a] != [r.index for r in b] or any(
                len(x.results) != len(y.results) or any(
                    abs(m.score - n.score) > 1e-6
                    or abs(m.pos_x - n.pos_x) > 1e-5
                    or abs(m.pos_y - n.pos_y) > 1e-5
                    or abs(m.angle - n.angle) > 1e-5
                    for m, n in zip(x.results, y.results))
                for x, y in zip(a, b)):
            raise AssertionError("[20 distributed] inspect_corpus(mesh=...) "
                                 "differs from phase 14's")
        log(f"[20 distributed] inspect_corpus(mesh=...) equal to the "
            f"unsharded reports on {len(corpus)} frames")
        twin("[20 distributed] corpus stream", sharded, unsharded)
        log("[20 distributed] wall ms, sharded at world 1 / unsharded "
            "(medians of 5, in turns): " + ", ".join(
                f"{k.split('] ')[1]} {s:.2f}/{u:.2f} ({s / u:.3f}x)"
                for k, (s, u) in walls.items()) + f" ({smi})")
    finally:
        dist.destroy_process_group()
    log("[20 distributed] process group destroyed")
    return warp_launches, corr_launches


# A fresh process: the start-up split and the build counters. argv: pack,
# frame BMP, then "pack" (serve from the pack) or "source" with a template
# BMP and a config's JSON (learn and match as without a pack).
STARTUP_SCRIPT = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
torch.cuda.init()
t2a = time.perf_counter()
torch.zeros(1, device="cuda")
t2 = time.perf_counter()
import fastest_image_pattern_matching_tpu_torch as fipm
from fastest_image_pattern_matching_tpu_torch import aot, native
from fastest_image_pattern_matching_tpu_torch.ops.cuda import build
from fastest_image_pattern_matching_tpu_torch.utils.imageio import load_gray
t3 = time.perf_counter()
if sys.argv[3] == "pack":
    step = "AotMatcher.load"
    m = fipm.AotMatcher.load(sys.argv[1], device="cuda")
    run, installed = m.match, list(m.installed)
else:
    step = "learn_pattern (template decode included)"
    cfg = aot._cfg_from_json(sys.argv[5])
    pattern = fipm.learn_pattern(load_gray(sys.argv[4]),
                                 cfg.min_reduce_area, device="cuda")
    run = lambda src: fipm.match(src, pattern, cfg, device="cuda")
    installed = []
t4 = time.perf_counter()
src = load_gray(sys.argv[2])
t5 = time.perf_counter()
first = run(src)
torch.cuda.synchronize()
t6 = time.perf_counter()
second = run(src)
torch.cuda.synchronize()
t7 = time.perf_counter()
print(json.dumps({
    "import torch": t1 - t0, "torch.cuda.init()": t2a - t1,
    "CUDA context (first allocation)": t2 - t2a,
    "package import": t3 - t2, step: t4 - t3,
    "load_gray": t5 - t4, "first match": t6 - t5, "second match": t7 - t6,
    "nvcc_runs": build.NVCC_RUNS, "gxx_runs": native.GXX_RUNS,
    "bundle_rejects": aot.BUNDLE_REJECTS, "installed": installed,
    "count": len(first),
    "same": [(r.score, r.center) for r in first]
            == [(r.score, r.center) for r in second]}))
"""


def aot_phase(fipm, warp_kernel, corr_kernel, dev, smi, warp, corr,
              cli_matches):
    """Phase 21: deployment packs. Exports, with the libraries bundled,
    the flagship pack (one frame and bucket 4), Test7's and an ORB pack at
    phase 16's shape (bucket 8); loads each in process and holds it equal
    to the unpacked path with the kernel launches of phases 4, 10, 7 and
    16; then copies the package without its _build/ into a temporary
    directory and runs two fresh processes there: `cli aot-match --json`
    on the flagship frame as a BMP (matches equal to phase 17's `match
    --json`) and STARTUP_SCRIPT (the start-up split; nvcc and g++ runs and
    bundle rejects must be 0). The copy's _build/ must hold the pack's
    libraries, byte for byte, and nothing else. Last, STARTUP_SCRIPT
    without the pack on the same copy (learn and match, the libraries
    built from source), for the split a fresh host pays without it. Returns the warp kernel's
    launches of the flagship pack's match and the correlation kernel's of
    Test7's."""
    import shutil
    import torch
    from fastest_image_pattern_matching_tpu_torch import aot
    from fastest_image_pattern_matching_tpu_torch.models import (
        template_matcher as tm)
    from fastest_image_pattern_matching_tpu_torch.utils.imageio import (
        save_gray)

    def export(tag, fn, path, *args, **kw):
        t0 = time.perf_counter()
        timings = fn(path, *args, include_executables=True, device=dev, **kw)
        secs = time.perf_counter() - t0
        data = np.load(path)
        libs = sorted(k for k in data.files
                      if k.startswith("lib_") and not k.endswith("_id"))
        log(f"[21 aot] {tag} pack: export {secs:.3f} s ("
            + ", ".join(f"{k} {v:.4f}" for k, v in timings.items())
            + f"), {os.path.getsize(path) / 1e6:.3f} MB, libraries "
            f"{libs}")
        return data

    def load(tag, cls, path):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = cls.load(path, device=dev)
        torch.cuda.synchronize()
        log(f"[21 aot] {tag} pack: load {(time.perf_counter() - t0) * 1e3:.2f}"
            f" ms, installed {list(getattr(m, 'installed', ()))}")
        return m

    def counted(run):
        """run() with both kernels' counts set to 0 just before; returns
        (result, ms, warp launches, correlation launches)."""
        torch.cuda.synchronize()
        k0 = kernel_launches()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return (out, (time.perf_counter() - t0) * 1e3, kernel_launches(k0)[0],
                kernel_launches(k0)[1])

    def same_lists(tag, got, want):
        if len(got) != len(want):
            raise AssertionError(f"{tag}: {len(got)} matches, unpacked "
                                 f"{len(want)}")
        if not got:
            return {}
        arrs = [{"valid": np.ones(len(x), bool),
                 "score": np.array([r.score for r in x]),
                 "angle": np.array([r.angle for r in x]),
                 "center": np.array([r.center for r in x]).reshape(-1, 2)}
                for x in (got, want)]
        return same_results(tag, *arrs, 1e-6, 1e-5)

    rejects0 = aot.BUNDLE_REJECTS
    pkg = os.path.dirname(os.path.abspath(fipm.__file__))
    with tempfile.TemporaryDirectory() as tmp:
        # The flagship pack: one frame (phase 4) and a bucket of 4 (phase
        # 10).
        scene, templ, truth = flagship_scene()
        cfg = flagship_config(fipm)
        pattern = fipm.learn_pattern(templ, 256, device=dev)
        flag_p = os.path.join(tmp, "flagship.npz")
        data = export("flagship", fipm.export_match_pack, flag_p, pattern,
                      cfg, scene.shape, batch_sizes=(4,))
        m = load("flagship", fipm.AotMatcher, flag_p)
        got, first_ms, w_first, _ = counted(lambda: m.match_arrays(scene))
        want = tm.match_arrays(scene, pattern, cfg, device=dev)
        d = same_results("[21 aot] flagship pack vs match_arrays", got, want,
                         1e-6, 1e-5)
        _, second_ms, w_launches, c_launches = counted(
            lambda: m.match_arrays(scene))
        log(f"[21 aot] flagship pack: {int(got['valid'].sum())} targets, "
            f"equal to match_arrays (max |d| {d}); first match after load "
            f"{first_ms:.2f} ms, second {second_ms:.2f} ms; warp launches "
            f"{w_launches} (phase 4: {warp['launches']}), correlation "
            f"{c_launches} ({smi})")
        if not (w_launches == w_first == warp["launches"] > 0
                and c_launches == 0 and got["valid"].sum() == len(truth)):
            raise AssertionError("[21 aot] the flagship pack's launches or "
                                 "targets differ from phase 4's")
        frames, _, _ = flagship_batch()
        many, many_ms, w_batch, _ = counted(lambda: m.match_many(frames))
        want_many = fipm.match_many(frames, pattern, cfg, device=dev)
        for i, (g, w) in enumerate(zip(many, want_many, strict=True)):
            same_lists(f"[21 aot] flagship pack match_many frame {i}", g, w)
        log(f"[21 aot] flagship pack match_many: {[len(r) for r in many]} "
            f"targets, each frame equal to match_many; {many_ms:.2f} ms, "
            f"warp launches {w_batch} (phase 10: {warp['batch_launches']})")
        if w_batch != warp["batch_launches"] or m.batch_sizes != [4]:
            raise AssertionError("[21 aot] the batch pack's launches differ "
                                 "from phase 10's")
        flag_libs = {k[4:]: bytes(data[k]) for k in data.files
                     if k.startswith("lib_") and not k.endswith("_id")}
        if sorted(flag_libs) != (["ccorr_valid", "descent_score",
                                  "fipm_native", "peaks", "warp_affine"]
                                 if dev.type == "cuda"
                                 else ["fipm_native"]):
            raise AssertionError(f"[21 aot] bundled {sorted(flag_libs)}")
        del frames, many, want_many
        torch.cuda.empty_cache()

        # Test7's pack (phase 7).
        t7, t7_templ, t7_truth = many_target_scene(3648, 100)
        t7_cfg = many_target_config(fipm, 100)
        t7_pat = fipm.learn_pattern(t7_templ, t7_cfg.min_reduce_area,
                                    device=dev)
        t7_p = os.path.join(tmp, "test7.npz")
        export("Test7", fipm.export_match_pack, t7_p, t7_pat, t7_cfg,
               t7.shape)
        m7 = load("Test7", fipm.AotMatcher, t7_p)
        got, t7_first, _, _ = counted(lambda: m7.match_arrays(t7))
        _, t7_second, t7_w, t7_c = counted(lambda: m7.match_arrays(t7))
        d = same_results("[21 aot] Test7 pack vs match_arrays", got,
                         tm.match_arrays(t7, t7_pat, t7_cfg, device=dev),
                         1e-6, 1e-5)
        log(f"[21 aot] Test7 pack: {int(got['valid'].sum())} targets, equal "
            f"to match_arrays (max |d| {d}); first match after load "
            f"{t7_first:.2f} ms, second {t7_second:.2f} ms; correlation "
            f"launches {t7_c} (phase 7: {corr['launches']}), warp {t7_w} "
            f"({smi})")
        if t7_c != corr["launches"] or got["valid"].sum() != len(t7_truth):
            raise AssertionError("[21 aot] the Test7 pack's launches or "
                                 "targets differ from phase 7's")
        del t7
        torch.cuda.empty_cache()

        # The ORB pack at phase 16's shape, bucket 8.
        otempl = orb_pairs()[0][2]
        oframes, _ = orb_frames(otempl)
        ocfg = fipm.ORBConfig()
        orb_p = os.path.join(tmp, "orb.npz")
        export("ORB", fipm.export_orb_pack, orb_p, ocfg, oframes.shape[1:],
               otempl.shape, batch_sizes=(8,))
        mo = load("ORB", fipm.AotOrb, orb_p)
        omany, omany_ms, ow, oc = counted(lambda: mo.match_many(oframes,
                                                                otempl))
        want = fipm.orb_match_many(oframes, otempl, ocfg, device=dev)
        for i, (g, w) in enumerate(zip(omany, want, strict=True)):
            orb_same(f"[21 aot] ORB pack frame {i}", g, w)
        orb_same("[21 aot] ORB pack match", mo.match(oframes[0], otempl),
                 fipm.orb_match(oframes[0], otempl, ocfg, device=dev))
        log(f"[21 aot] ORB pack: match_many of {len(oframes)} equal to "
            f"orb_match_many field by field, match to orb_match; "
            f"{omany_ms:.2f} ms; kernel launches warp {ow}, correlation {oc} "
            f"(phase 16: none) ({smi})")
        if ow or oc or aot.BUNDLE_REJECTS != rejects0:
            raise AssertionError("[21 aot] ORB launched a kernel, or a "
                                 "bundle was refused in process")

        # Fresh processes against a copy of the package with no _build/.
        copy = os.path.join(tmp, "fresh")
        shutil.copytree(pkg, os.path.join(copy, os.path.basename(pkg)),
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        build_dir = os.path.join(copy, os.path.basename(pkg), "_build")
        bmp = os.path.join(tmp, "flagship.bmp")
        save_gray(bmp, scene)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

        def fresh(tag, argv, from_pack=True):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable] + argv, cwd=copy, env=env,
                                  capture_output=True, text=True,
                                  timeout=300)
            wall = time.perf_counter() - t0
            if proc.returncode != 0 or "refused" in proc.stderr:
                raise AssertionError(f"[21 aot] {tag} exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            files = sorted(os.listdir(build_dir))
            want_files = sorted(
                json.loads(bytes(data[f"lib_{s}_id"]).decode())["file"]
                for s in flag_libs)
            if (files != want_files if from_pack
                    else not set(files) <= set(want_files)):
                raise AssertionError(f"[21 aot] {tag}: _build/ holds {files}"
                                     f", the pack {want_files}")
            for s, raw in flag_libs.items() if from_pack else ():
                name = json.loads(bytes(data[f"lib_{s}_id"]).decode())["file"]
                with open(os.path.join(build_dir, name), "rb") as fh:
                    if fh.read() != raw:
                        raise AssertionError(f"[21 aot] {tag}: {name} is "
                                             "not the pack's library")
            shutil.rmtree(build_dir)
            return json.loads(proc.stdout.strip().splitlines()[-1]), wall

        out, wall = fresh("aot-match", [
            "-m", "fastest_image_pattern_matching_tpu_torch.cli", "--device",
            dev.type, "aot-match", "-p", flag_p, "-s", bmp, "--json"])
        keys = ("index", "score", "angle", "pos_x", "pos_y")
        if [{k: x[k] for k in keys} for x in out["matches"]] != \
                [{k: x[k] for k in keys} for x in cli_matches]:
            raise AssertionError("[21 aot] the fresh aot-match's matches "
                                 "differ from phase 17's match --json")
        log(f"[21 aot] fresh process aot-match --json on a copy without "
            f"_build/: {out['count']} targets, equal to phase 17's match "
            f"--json; first match execution_ms {out['execution_ms']}; "
            f"process wall {wall:.2f} s; _build/ afterwards: the pack's "
            f"{len(flag_libs)} libraries, byte for byte ({smi})")
        split, wall = fresh("start-up script", [
            "-c", STARTUP_SCRIPT, flag_p, bmp, "pack"])
        log("[21 aot] fresh process start-up split s: " + ", ".join(
            f"{k} {v:.4f}" for k, v in split.items()
            if isinstance(v, float)) + f"; process wall {wall:.2f} s; nvcc "
            f"runs {split['nvcc_runs']}, g++ runs {split['gxx_runs']}, "
            f"bundle rejects {split['bundle_rejects']}, installed "
            f"{split['installed']} ({smi})")
        if (split["nvcc_runs"], split["gxx_runs"], split["bundle_rejects"]) \
                != (0, 0, 0) or split["count"] != len(truth) \
                or not split["same"] \
                or sorted(split["installed"]) != sorted(flag_libs):
            raise AssertionError("[21 aot] the fresh process built a "
                                 "library, refused the bundle or missed")
        tpl_bmp = os.path.join(tmp, "template.bmp")
        save_gray(tpl_bmp, templ)
        cold, cold_wall = fresh("start-up script without the pack", [
            "-c", STARTUP_SCRIPT, flag_p, bmp, "source", tpl_bmp,
            aot._cfg_to_json(cfg)], from_pack=False)
        log("[21 aot] fresh process without the pack, same copy: " + ", ".join(
            f"{k} {v:.4f}" for k, v in cold.items()
            if isinstance(v, float)) + f"; process wall {cold_wall:.2f} s "
            f"against {wall:.2f} s from the pack; nvcc runs "
            f"{cold['nvcc_runs']}, g++ runs {cold['gxx_runs']} ({smi})")
        # The flagship runs the warp, the peak and the descent-score
        # kernels: three nvcc, and one g++ for the BMP codec.
        if cold["count"] != len(truth) or cold["gxx_runs"] != 1 \
                or cold["nvcc_runs"] != (3 if dev.type == "cuda" else 0):
            raise AssertionError("[21 aot] the fresh process without the "
                                 "pack did not build from source")
    return w_launches, t7_c


def png_file(samples, depth=8, palette=None):
    """A PNG of 2-D grey samples (8 or 16 bits), or of 8-bit palette
    indices with `palette` (n x 3 u8), every row Paeth-filtered as
    libpng's encoders mostly filter photographs, deflated at level 1."""
    import struct
    import zlib
    h, w = samples.shape
    raw = (samples.astype(">u2").view(np.uint8).reshape(h, -1)
           if depth == 16 else samples.astype(np.uint8))
    bpp = depth // 8
    x = raw.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.empty((h, raw.shape[1] + 1), np.uint8)
    rows[:, 0] = 4
    rows[:, 1:] = (x - pred) & 0xFF

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    ctype = 0 if palette is None else 3
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return (out + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + chunk(b"IEND", b""))


def lzw_literal(data: bytes) -> bytes:
    """A TIFF LZW stream of `data` in literal codes only: Clear, at most
    250 9-bit literals, Clear, ..., EOI. Valid LZW (a Clear may come at
    any point), and the decoder's worst case in codes a byte."""
    v = np.frombuffer(data, np.uint8).astype(np.uint16)
    k = 250
    pad = (-v.size) % k
    blocks = np.concatenate([v, np.full(pad, 0xFFFF, np.uint16)]).reshape(
        -1, k)
    codes = np.concatenate([np.full((blocks.shape[0], 1), 256, np.uint16),
                            blocks], 1).reshape(-1)
    codes = np.append(codes[codes != 0xFFFF], np.uint16(257))
    bits = np.unpackbits(codes.astype(">u2").view(np.uint8).reshape(-1, 2),
                         axis=1)[:, 7:]
    return np.packbits(bits.reshape(-1)).tobytes()


def tiff16_lzw_file(samples, rows_per_strip=64):
    """A little-endian grey TIFF of 2-D 16-bit samples: LZW
    (lzw_literal), Predictor 2, one strip per `rows_per_strip` rows."""
    import struct
    h, w = samples.shape
    d = samples.astype(np.int64)
    d[:, 1:] -= d[:, :-1].copy()
    d &= 0xFFFF
    strips = [lzw_literal(d[y:y + rows_per_strip].astype("<u2").tobytes())
              for y in range(0, h, rows_per_strip)]
    body = b"".join(strips)
    offsets = 8 + np.cumsum([0] + [len(x) for x in strips[:-1]])
    ifd_at = 8 + len(body) + (len(body) & 1)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [16]), (259, 3, [5]),
               (262, 3, [1]), (273, 4, list(offsets)), (277, 3, [1]),
               (278, 4, [rows_per_strip]),
               (279, 4, [len(x) for x in strips]), (284, 3, [1]),
               (317, 3, [2])]
    tail_at = ifd_at + 2 + 12 * len(entries) + 4
    ifd, tail = b"", b""
    for tag, typ, vals in entries:
        raw = struct.pack(f"<{len(vals)}{'H' if typ == 3 else 'I'}",
                          *map(int, vals))
        field = raw.ljust(4, b"\0") if len(raw) <= 4 else struct.pack(
            "<I", tail_at + len(tail))
        if len(raw) > 4:
            tail += raw
        ifd += struct.pack("<HHI", tag, typ, len(vals)) + field
    return (b"II*\x00" + struct.pack("<I", ifd_at) + body
            + b"\0" * (len(body) & 1) + struct.pack("<H", len(entries))
            + ifd + b"\0\0\0\0" + tail)


def decode_phase(fipm, warp_kernel, corr_kernel, dev, smi):
    """Phase 22: frames decoded by the port's own readers on this
    machine, which has neither PIL nor cv2 (each import is tried and
    printed). Returns the warp and correlation kernel launches of the
    matches on the decoded frames."""
    import contextlib
    import importlib
    import io
    import torch
    from fastest_image_pattern_matching_tpu_torch import cli
    from fastest_image_pattern_matching_tpu_torch.models import (
        template_matcher as tm)
    from fastest_image_pattern_matching_tpu_torch.native import bmp
    from fastest_image_pattern_matching_tpu_torch.native import (
        decode as ndec)
    from fastest_image_pattern_matching_tpu_torch.utils import imageio
    from fastest_image_pattern_matching_tpu_torch.utils.codecs import (
        pnm, tiff)
    from fastest_image_pattern_matching_tpu_torch.utils.sources import (
        FolderSource)

    found = {}
    for name in ("PIL", "cv2"):
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    log(f"[22 decode] PIL imports here: {found['PIL']}; cv2 imports here: "
        f"{found['cv2']}")

    def counters():
        return {"native/bmp.py FALLBACKS": bmp.FALLBACKS,
                "native/decode.py FALLBACKS": ndec.FALLBACKS,
                "codecs/tiff.py PIL_ROUTES": tiff.PIL_ROUTES}

    def write(path, data):
        with open(path, "wb") as f:
            f.write(data)
        return path

    def decoded(tag, got, want):
        if len(got) != len(want) or not all(
                a.dtype == np.uint8 and np.array_equal(a, b)
                for a, b in zip(got, want)):
            raise AssertionError(f"[22 decode] {tag}: a decoded frame "
                                 "differs from its u8 array")

    rng = np.random.default_rng(22)

    def wide(u8):  # 16-bit samples whose high byte is the u8 frame
        return (u8.astype(np.uint16) << 8) | rng.integers(
            0, 256, u8.shape, dtype=np.uint16)

    grey_ramp = np.repeat(np.arange(256, dtype=np.uint8), 3).reshape(256, 3)
    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        frames, templ, _ = flagship_batch()
        t7, t7_templ, _ = many_target_scene(3648, 100)
        stpl = stream_template()
        sframes, _ = stream_frames(stpl, 24)
        dirs = {k: os.path.join(tmp, k) for k in ("png16", "tif16", "pgm")}
        for d in dirs.values():
            os.makedirs(d)
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            write(os.path.join(dirs["png16"], f"{i:03d}.png"),
                  png_file(wide(f), 16))
        pal_p = write(os.path.join(tmp, "palette.png"),
                      png_file(frames[0], 8, grey_ramp))
        write(os.path.join(dirs["tif16"], "test7.tif"),
              tiff16_lzw_file(wide(t7)))
        for i, f in enumerate(sframes):
            imageio.save_gray(os.path.join(dirs["pgm"], f"{i:03d}.pgm"), f)
        tpl_p = os.path.join(tmp, "template.png")
        imageio.save_gray(tpl_p, templ)
        log(f"[22 decode] wrote 4 flagship frames as 16-bit PNGs, frame 0 "
            f"as an 8-bit palette PNG, Test7 as a 16-bit LZW TIFF with "
            f"predictor 2, 24 corpus frames as PGMs, the template as a PNG "
            f"in {time.perf_counter() - t0:.2f} s")

        walls = {}

        def through(tag, src, n):
            t0 = time.perf_counter()
            got = list(src)
            walls[tag] = (time.perf_counter() - t0) * 1e3 / n
            return got

        d_flag = through("flagship 16-bit PNG", FolderSource(
            dirs["png16"], patterns=("*.png",)), len(frames))
        decoded("flagship 16-bit PNGs", d_flag, frames)
        t0 = time.perf_counter()
        d_pal = imageio.load_gray(pal_p)
        walls["flagship palette PNG"] = (time.perf_counter() - t0) * 1e3
        decoded("flagship palette PNG", [d_pal], frames[:1])
        d_t7 = through("Test7 16-bit LZW TIFF", FolderSource(
            dirs["tif16"], patterns=("*.tif",)), 1)
        decoded("Test7 16-bit LZW TIFF", d_t7, [t7])
        d_pgm = through("corpus PGM", FolderSource(
            dirs["pgm"], patterns=("*.pgm",)), len(sframes))
        decoded("corpus PGMs", d_pgm, list(sframes))
        log("[22 decode] every decoded frame bit-equal to its u8 array; "
            "decode ms a frame through FolderSource / load_gray: " + ", ".join(
                f"{k} {v:.2f}" for k, v in walls.items()) + f" ({smi})")

        cfg = flagship_config(fipm)
        pattern = fipm.learn_pattern(templ, cfg.min_reduce_area, device=dev)
        t7_cfg = many_target_config(fipm, 100)
        t7_pat = fipm.learn_pattern(t7_templ, t7_cfg.min_reduce_area,
                                    device=dev)
        scfg = fipm.MatchConfig(max_pos=1, score=0.6, tolerance_angle=15.0)
        spat = fipm.learn_pattern(stpl, 256, device=dev)
        wants = [tm.match_arrays(f, pattern, cfg, device=dev)
                 for f in frames]
        want_t7 = tm.match_arrays(t7, t7_pat, t7_cfg, device=dev)
        want_corpus = list(fipm.inspect_corpus(list(sframes), spat, scfg,
                                               batch_size=8, device=dev))
        torch.cuda.synchronize()
        k0 = kernel_launches()
        worst = {}
        pairs = list(zip(d_flag, wants)) + [(d_pal, wants[0])]
        for i, (f, want) in enumerate(pairs):
            d = same_results(f"[22 decode] flagship frame {i}",
                             tm.match_arrays(f, pattern, cfg, device=dev),
                             want, 1e-6, 1e-5)
            worst = {k: max(worst.get(k, 0.0), v) for k, v in d.items()}
        d = same_results("[22 decode] Test7", tm.match_arrays(
            d_t7[0], t7_pat, t7_cfg, device=dev), want_t7, 1e-6, 1e-5)
        worst = {k: max(worst.get(k, 0.0), v) for k, v in d.items()}
        got_corpus = list(fipm.inspect_corpus(FolderSource(
            dirs["pgm"], patterns=("*.pgm",)), spat, scfg, batch_size=8,
            device=dev))
        fields = [[(m.score, m.pos_x, m.pos_y, m.angle) for m in r.results]
                  for r in got_corpus]
        if fields != [[(m.score, m.pos_x, m.pos_y, m.angle)
                       for m in r.results] for r in want_corpus]:
            raise AssertionError("[22 decode] inspect_corpus over the PGMs "
                                 "differs from the u8 frames'")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["match", "-s", os.path.join(dirs["png16"],
                                                      "000.png"),
                           "-t", tpl_p, "--json", "--max-pos", "3",
                           "--score", "0.7", "--tolerance-angle", "180",
                           "--max-overlap", "0.1"])
        torch.cuda.synchronize()
        launches = kernel_launches(k0)
        got = json.loads(out.getvalue()) if rc == 0 else {"count": -1}
        want = fipm.match(frames[0], pattern, cfg, device=dev)
        same = got["count"] == len(want) == 3 and all(
            m["score"] == r.score and m["angle"] == r.angle
            and m["pos_x"] == r.pos_x and m["pos_y"] == r.pos_y
            for m, r in zip(got["matches"], want))
        log(f"[22 decode] match lists on the decoded frames equal to the u8 "
            f"arrays' (5 flagship, Test7; valid masks, score 1e-6, centre "
            f"and angle 1e-5): max |d| {worst}; inspect_corpus over the "
            f"PGMs equal; cli match --json on the 16-bit PNG: "
            f"{got['count']} targets, equal to match(): {same}; warp "
            f"kernel launches {launches[0]}, correlation {launches[1]}")
        if not same or min(launches) <= 0:
            raise AssertionError("[22 decode] the CLI's match on the PNG "
                                 "differs, or a kernel was not launched")
        bad = {k: v for k, v in counters().items() if v}
        if bad:
            raise AssertionError(f"[22 decode] decode routes gave way: {bad}")
        log(f"[22 decode] no decode route gave way: {counters()}")

        # Decode ms a frame per format and bit depth, native loops and
        # (480x640) their Python twins, the twins reached by stubbing
        # native/decode.py::available to False (no fallback is counted).
        sizes = {"480x640": sframes[0], "4024x3036": frames[0]}
        writers = {
            "PNG 8-bit": (".png", lambda u8: png_file(u8, 8)),
            "PNG 16-bit": (".png", lambda u8: png_file(wide(u8), 16)),
            "PNG 8-bit palette": (".png",
                                  lambda u8: png_file(u8, 8, grey_ramp)),
            "TIFF 16-bit LZW pred2": (".tif",
                                      lambda u8: tiff16_lzw_file(wide(u8))),
            "PGM 8-bit": (".pgm", pnm.encode_pgm),
        }
        for size, u8 in sizes.items():
            for k, (fmt, (suffix, make)) in enumerate(writers.items()):
                path = write(os.path.join(tmp, f"{size}_{k}{suffix}"),
                             make(u8))
                times = {}
                for route in ("native", "twin") if size == "480x640" else (
                        "native",):
                    real = ndec.available
                    if route == "twin":
                        ndec.available = lambda: False
                    try:
                        ms = []
                        for _ in range(3):
                            t0 = time.perf_counter()
                            img = imageio.load_gray(path)
                            ms.append((time.perf_counter() - t0) * 1e3)
                    finally:
                        ndec.available = real
                    if not np.array_equal(img, u8):
                        raise AssertionError(f"[22 decode] {size} {fmt} "
                                             f"({route}) differs")
                    times[route] = statistics.median(ms)
                log(f"[22 decode] {size} {fmt}: " + ", ".join(
                    f"{r} {v:.3f} ms" for r, v in times.items())
                    + f" a frame (median of 3, host; {smi})")
        bad = {k: v for k, v in counters().items() if v}
        if bad:
            raise AssertionError(f"[22 decode] decode routes gave way: {bad}")
    log(f"[22 decode] phase wall {time.perf_counter() - phase_t0:.1f} s")
    return launches


def peaks_phase(fipm, peaks_kernel, dev, smi):
    """Phase 23: the peak kernel against the plain loop, at the main path's
    own inputs: the score maps that one Test7 match (one 1798x1798 map, K
    105: the tile form), one flagship match (41 maps of 60x59, K 8: the
    small form) and a flagship batch of 8 frames (328 maps) hand to
    extract_peaks, recorded from the matches; every output bit-equal to
    the plain loop on the CPU. Launches and tile-form calls per match.
    Times of the kernel (host loop, and device alone in a CUDA graph) and
    of the plain loop on the card, in turns, beside the bound (one read of
    the maps); both forms timed on the same maps at sizes around
    SMALL_MAX, where the wrapper switches. Returns the kernels-line
    entry."""
    import torch
    from fastest_image_pattern_matching_tpu_torch.models import (
        template_matcher as tm)
    from fastest_image_pattern_matching_tpu_torch.ops import peaks as P
    from fastest_image_pattern_matching_tpu_torch.ops.rounding import f32
    from fastest_image_pattern_matching_tpu_torch.utils.profiling import (
        counter)

    scene, templ, _ = many_target_scene(3648, 100)
    cfg = many_target_config(fipm, 100)
    pattern = fipm.learn_pattern(templ, cfg.min_reduce_area, device=dev)
    f_scene, f_templ, _ = flagship_scene()
    f_cfg = flagship_config(fipm)
    f_pat = fipm.learn_pattern(f_templ, 256, device=dev)
    frames = flagship_batch()[0]
    batch8 = np.concatenate([frames, frames])
    runs = {
        "Test7": lambda: fipm.match(scene, pattern, cfg, device=dev),
        "flagship": lambda: fipm.match(f_scene, f_pat, f_cfg, device=dev),
        "flagship batch of 8": lambda: fipm.match_many(batch8, f_pat, f_cfg,
                                                       device=dev)}
    entry = {"name": "peaks", "route": "cuda",
             "source": "fastest_image_pattern_matching_tpu_torch/csrc/"
                       "peaks.cu",
             "replaces": "none: the JAX package's rounds are XLA operations "
                         "in a fori_loop (ops/peaks.py::extract_peaks)",
             "launches": {}, "shapes": {}}
    for tag, run in runs.items():
        run()
        torch.cuda.synchronize()
        before = (counter("peaks.launches"), counter("peaks.tiled"))
        calls = record_calls(tm, "extract_peaks", run)
        torch.cuda.synchronize()
        launches = (counter("peaks.launches") - before[0],
                    counter("peaks.tiled") - before[1])
        entry["launches"][tag] = launches
        for scores, k, templ_wh, overlap in calls:
            got = P.extract_peaks(scores, k, templ_wh, overlap)
            want = P.extract_peaks(scores.cpu(), k, templ_wh, overlap)
            if not (torch.equal(got[1].cpu(), want[1]) and torch.equal(
                    got[0].cpu().view(torch.int32),
                    want[0].view(torch.int32))):
                raise AssertionError(f"[23 peaks] {tag}: the kernel differs "
                                     "from the plain loop")
        scores, k, templ_wh, overlap = calls[0]
        tw, th = templ_wh
        sw, sh = int(2 * tw * (1 - overlap)), int(2 * th * (1 - overlap))
        ox, oy = f32(tw * (1.0 - overlap)), f32(th * (1.0 - overlap))
        kernel = lambda: P.extract_peaks(scores, k, templ_wh, overlap)
        plain = lambda: P.extract_peaks_ref(scores, k, sw, sh, ox, oy)
        km, pm = turns_ms(kernel, plain, 50, 3 if k > 50 else 10)
        kdm = device_ms(kernel)
        bms, by = bound_ms(4 * scores.numel(), 0, F32_OPS_PER_S)
        form = "small" if peaks_kernel.plan(*scores.shape[1:], sw,
                                            sh) is None else "tile"
        entry["shapes"][tag] = dict(
            shape=list(scores.shape), k=k, rect=[sw, sh], form=form,
            ms=kdm, loop_ms=km, plain_ms=pm, bound_ms=bms)
        log(f"[23 peaks] {tag}: {len(calls)} call(s), each bit-equal to "
            f"the plain loop; first {tuple(scores.shape)} K {k} rect "
            f"{sw}x{sh}, {form} form; kernel loop {km:.4f} ms, device "
            f"{kdm:.4f} ms ({100 * bms / kdm:.2f}% of bound); plain loop "
            f"on the card {pm:.3f} ms; bound {bms:.4f} ms by {by}; "
            f"launches per match {launches[0]}, tile-form calls "
            f"{launches[1]} ({smi})")
    if entry["launches"]["Test7"] != (2, 1) or \
            entry["launches"]["flagship"][1] != 0:
        raise AssertionError(f"[23 peaks] launches {entry['launches']}: "
                             "Test7 must take the tile form once, the "
                             "flagship the small form")
    # Both forms on the same maps around the switch (K 30, 27x27 rect).
    rng = np.random.default_rng(23)
    small_max = peaks_kernel.SMALL_MAX
    rows = []
    try:
        for side in (64, 100, 128, 160, 200):
            for A in (1, 41):
                maps = torch.as_tensor(rng.uniform(-1, 1, (A, side, side))
                                       .astype(np.float32), device=dev)
                out, ms = {}, {}
                for form, limit in (("small", 10**9), ("tile", 0)):
                    peaks_kernel.SMALL_MAX = limit
                    out[form] = P.extract_peaks(maps, 30, (27, 27), 0.5)
                    ms[form] = device_ms(
                        lambda: P.extract_peaks(maps, 30, (27, 27), 0.5))
                if not (torch.equal(out["small"][0], out["tile"][0])
                        and torch.equal(out["small"][1], out["tile"][1])):
                    raise AssertionError(f"[23 peaks] the forms differ at "
                                         f"{A}x{side}x{side}")
                rows.append((A, side, ms["small"], ms["tile"]))
    finally:
        peaks_kernel.SMALL_MAX = small_max
    entry["forms"] = rows
    log("[23 peaks] forms, device ms (K 30, 27x27 rect), small / tile: "
        + "; ".join(f"{A}x{n}x{n} {a:.4f} / {b:.4f}" for A, n, a, b in rows)
        + f"; the wrapper switches above {small_max} values ({smi})")
    t7 = entry["shapes"]["Test7"]
    entry.update(ms=t7["ms"], plain_ms=t7["plain_ms"],
                 bound_ms=t7["bound_ms"], bound_by="bytes",
                 loop_ms=t7["loop_ms"])
    return entry


def benchmark_plate(fipm, dev, seed=7):
    """ocr.plate's read (fipm_bench/configs/ocr.json): a 360x640 plate,
    its 36 glyph patterns of 52x34 learned on `dev` and its MatchConfig."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fipm_bench", "configs", "ocr.json")) as f:
        config = json.load(f)
    glyphs, plates, _ = make_pool(config["scene_params"], 1, 0,
                                  np.random.default_rng(seed))
    cfg = fipm.MatchConfig(**config["match"])
    pats = [fipm.learn_pattern(g, cfg.min_reduce_area, device=dev)
            for g in glyphs.values()]
    return plates[0], pats, cfg


def descent_phase(fipm, dev, smi):
    """Phase 24: the descent-score kernel against its plain version on the
    card, at the main path's own inputs: every chunk that one flagship
    match (levels 5-0, chunks of 64, 32 and 8 candidates at k_ang 3), one
    Test7 match (60x60 ROIs, k_ang 1) and a flagship batch of 8 frames
    hand to descent_best, and every chunk that ocr.plate's read (36 glyphs
    as one stack, match_patterns) hands to descent_best_stack, recorded
    from the calls; every output bit-equal to the plain version on the
    card (descent_best_ref, descent_best_stack_ref), and the read equal
    to match_arrays of each glyph on the card. Launches a call equal to
    the recorded chunks and, in a second call under the profiler, to its
    fipm.descent.chunk spans. Times of the kernel (host loop, and device
    alone in a CUDA graph) and of the plain version on the card, in
    turns, beside the bound (the ROIs, the templates they index and the
    index read once, at the memory rate, against the multiply-adds at the
    int8 rate), at the flagship's level-0 chunk, Test7's first chunk and
    the plate's level-1 and level-0 chunks. Returns the kernels-line
    entry."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fastest_image_pattern_matching_tpu_torch.models import (
        template_matcher as tm)
    from fastest_image_pattern_matching_tpu_torch.ops import ncc
    from fastest_image_pattern_matching_tpu_torch.utils import profiling

    f_scene, f_templ, _ = flagship_scene()
    f_cfg = flagship_config(fipm)
    f_pat = fipm.learn_pattern(f_templ, 256, device=dev)
    scene, templ, _ = many_target_scene(3648, 100)
    cfg = many_target_config(fipm, 100)
    pattern = fipm.learn_pattern(templ, cfg.min_reduce_area, device=dev)
    frames = flagship_batch()[0]
    batch8 = np.concatenate([frames, frames])
    plate, o_pats, o_cfg = benchmark_plate(fipm, dev)
    # The entry each run's chunks go through, and its kernel and plain
    # version (the plain one takes the arguments less `integer`).
    single = ("descent_best", ncc.descent_best, ncc.descent_best_ref)
    stack = ("descent_best_stack", ncc.descent_best_stack,
             ncc.descent_best_stack_ref)
    runs = {
        "flagship": (lambda: fipm.match(f_scene, f_pat, f_cfg, device=dev),
                     single),
        "Test7": (lambda: fipm.match(scene, pattern, cfg, device=dev),
                  single),
        "flagship batch of 8": (lambda: fipm.match_many(
            batch8, f_pat, f_cfg, device=dev), single),
        "ocr plate": (lambda: fipm.match_patterns(plate, o_pats, o_cfg,
                                                  device=dev), stack)}
    entry = {"name": "descent_score", "route": "cuda",
             "source": "fastest_image_pattern_matching_tpu_torch/csrc/"
                       "descent_score.cu",
             "replaces": "none: the JAX package's descent maps are XLA "
                         "operations (models/template_matcher.py:374-378)",
             "launches": {}, "shapes": {}}
    recorded = {}
    for tag, (run, (name, kernel_fn, plain_fn)) in runs.items():
        run()
        torch.cuda.synchronize()
        before = profiling.counter("descent_score.launches")
        calls = record_calls(tm, name, run)
        torch.cuda.synchronize()
        launches = profiling.counter("descent_score.launches") - before
        profiling.reset_spans()
        before = profiling.counter("descent_score.launches")
        with profile(activities=[ProfilerActivity.CPU]):
            run()
            torch.cuda.synchronize()
        traced = profiling.counter("descent_score.launches") - before
        chunks = sum(r.name == "fipm.descent.chunk"
                     for r in profiling.spans())
        profiling.reset_spans()
        if not (launches == len(calls) == traced == chunks > 0) or not all(
                c[-1] for c in calls):
            raise AssertionError(
                f"[24 descent] {tag}: {launches} launches for {len(calls)} "
                f"chunks ({traced} launches and {chunks} chunk spans under "
                "the profiler); every chunk must launch the kernel once")
        for args in calls:
            got = kernel_fn(*args)
            want = plain_fn(*args[:-1])
            for g, w in zip(got, want):
                if g.dtype == torch.float32:
                    g, w = g.view(torch.int32), w.view(torch.int32)
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"[24 descent] {tag}: the kernel differs from the "
                        f"plain version on ROIs {tuple(args[0].shape)}")
        shapes = sorted({(tuple(a[1].shape), a[-3], a[-2]) for a in calls},
                        key=lambda x: -x[0][-2])
        entry["launches"][tag] = launches
        recorded[tag] = calls
        log(f"[24 descent] {tag}: {launches} launches, one a chunk "
            f"({chunks} fipm.descent.chunk spans under the profiler), each "
            f"bit-equal to the plain version on the card; templates, cc and "
            f"k_ang: {shapes} ({smi})")
    read = fipm.match_patterns(plate, o_pats, o_cfg, device=dev)
    for k, (got, p) in enumerate(zip(read, o_pats)):
        want = tm.match_arrays(plate, p, o_cfg, device=dev)
        for key in want:
            g, w = np.asarray(got[key]), np.asarray(want[key])
            if g.shape != w.shape or not np.array_equal(
                    g.view(np.uint8), w.view(np.uint8)):
                raise AssertionError(
                    f"[24 descent] ocr plate: glyph {k}'s {key} differs "
                    "from its own match_arrays on the card")
    log(f"[24 descent] ocr plate: match_patterns equal to match_arrays of "
        f"each of the {len(o_pats)} glyphs on the card, bit for bit; "
        f"{sum(bool(r['valid'].any()) for r in read)} glyphs found")
    o_shapes = [tuple(lv.templ.shape) for lv in o_pats[0].levels]
    timed = {
        "flagship L0 chunk": (next(a for a in recorded["flagship"]
                                   if tuple(a[1].shape) == (521, 762)),
                              single),
        "Test7 chunk": (recorded["Test7"][0], single),
        "ocr L1 chunk": (next(a for a in recorded["ocr plate"]
                              if tuple(a[1].shape[1:]) == o_shapes[1]),
                         stack),
        "ocr L0 chunk": (next(a for a in recorded["ocr plate"]
                              if tuple(a[1].shape[1:]) == o_shapes[0]),
                         stack)}
    for tag, (args, (name, kernel_fn, plain_fn)) in timed.items():
        rois, templ_l = args[0], args[1]
        kernel = lambda: kernel_fn(*args)
        plain = lambda: plain_fn(*args[:-1])
        km, pm = turns_ms(kernel, plain, 50, 5)
        kdm = device_ms(kernel)
        B, H, W = rois.shape
        h, w = templ_l.shape[-2:]
        if templ_l.ndim == 3:  # the templates indexed, the index, the table
            G = int(torch.unique(args[2]).numel())
            in_bytes = 4 * (G * h * w + B + 6 * G)
        else:
            G = 1
            in_bytes = 4 * h * w
        n_bytes = 4 * B * H * W + in_bytes + B * (4 + 8 + 1 + 36)
        bms, by = bound_ms(n_bytes, 2 * B * 49 * h * w, INT8_OPS_PER_S)
        entry["shapes"][tag] = dict(shape=[B, H, W], templ=[h, w],
                                    templates=G, ms=kdm, loop_ms=km,
                                    plain_ms=pm, bound_ms=bms, bound_by=by)
        log(f"[24 descent] {tag}: {B} ROIs of {H}x{W}, {G} {h}x{w} "
            f"template(s); kernel loop {km:.4f} ms, device {kdm:.4f} ms "
            f"({100 * bms / kdm:.2f}% of bound); plain version on the card "
            f"{pm:.3f} ms; bound {bms:.4f} ms by {by} ({smi})")
    l0 = entry["shapes"]["flagship L0 chunk"]
    entry.update(ms=l0["ms"], plain_ms=l0["plain_ms"],
                 bound_ms=l0["bound_ms"], bound_by=l0["bound_by"],
                 loop_ms=l0["loop_ms"])
    return entry


def profile_match(tag, run, smi, runs=3, frames=1):
    """torch.profiler over `runs` calls of one end-to-end path after its
    warm-up: the device's busy share of the wall time (union of the device
    intervals of kernels, copies and fills), device events and host copies
    or syncs per frame (a call matches `frames` frames), and the largest
    device consumers. Returns (busy share %, device events per frame, host
    copies or syncs per frame)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in events if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    syncs = sum(1 for e in events
                if e.device_type == DeviceType.CPU
                and e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                               "cudaMemcpyAsync"))
    per = runs * frames
    share = 100.0 * busy / wall_us
    log(f"{tag} profile of {runs} calls of {frames} frame(s): wall "
        f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
        f"({share:.1f}% of the wall, idle {100.0 - share:.1f}%), "
        f"{len(spans) / per:.0f} device events and {syncs / per:.0f} host "
        f"copies or syncs per frame ({smi})")
    total = sum(by_name.values()) or 1.0
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"{tag}   {100.0 * v / total:5.1f}% {v / per / 1e3:.3f} "
            f"ms/frame  {k[:80]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    log(f"{tag} host time by op (self, ms/frame, calls/frame): " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / per / 1e3:.3f} "
        f"{e.count / per:.0f}" for e in host[:8]))
    return share, len(spans) / per, syncs / per


def log_walls(tag, run, smi, n=5):
    """Median wall time of n runs after warm-up, host array in."""
    import torch
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(walls)
    log(f"{tag} wall ms (host array in, {n} runs after warm-up): median "
        f"{med:.2f}, all {[round(w, 2) for w in walls]} ({smi})")
    return med


def card_vs_cpu(tag, tm, scene, pattern, cfg, dev, n_targets, score_atol):
    """match_arrays on the card against the CPU: valid masks equal with
    n_targets valid, scores within score_atol, centre and angle 1e-3."""
    on_card = tm.match_arrays(scene, pattern, cfg, device=dev)
    on_cpu = tm.match_arrays(scene, pattern, cfg, device="cpu")
    nv = int(on_cpu["valid"].sum())
    if not np.array_equal(on_card["valid"], on_cpu["valid"]) \
            or nv != n_targets:
        raise AssertionError(f"{tag}: valid masks differ or != {n_targets} "
                             f"targets: {on_card['valid']} vs "
                             f"{on_cpu['valid']}")
    diffs = {k: float(np.abs(on_card[k][:nv] - on_cpu[k][:nv]).max())
             for k in ("score", "center", "angle")}
    log(f"{tag} {nv} targets; max |d| {diffs}")
    if diffs["score"] > score_atol or diffs["center"] > 1e-3 \
            or diffs["angle"] > 1e-3:
        raise AssertionError(f"{tag}: the port on the card disagrees with "
                             "the CPU")


def stage_times(fipm, scene, pattern, cfg, dev):
    """Per-stage host ms of one call of match() (`scene` one image) or
    match_many_arrays() (a stack of frames [N, H, W]), from the port's
    span table (utils/profiling.py::spans()) under torch.profiler: the
    inclusive ms of fipm.prepare, fipm.pyramid, fipm.sweep, fipm.select,
    each fipm.descent.L<l> (as descend_L<l>), fipm.finalize and
    fipm.readback. Nothing synchronises between the stages."""
    import torch
    from fastest_image_pattern_matching_tpu_torch.utils import profiling
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        if scene.ndim == 3:
            fipm.match_many_arrays(scene, pattern, cfg, device=dev)
        else:
            fipm.match(scene, pattern, cfg, device=dev)
    rows = profiling.spans()
    profiling.reset_spans()
    out = {}
    for r in rows:
        name = r.name[len("fipm."):]
        if name.startswith("descent.L"):
            name = "descend_" + name[len("descent."):]
        elif name not in ("prepare", "pyramid", "sweep", "select",
                          "finalize", "readback"):
            continue
        out[name] = out.get(name, 0.0) + (r.end_ns - r.start_ns) / 1e6
    return out


if __name__ == "__main__":
    sys.exit(main())
