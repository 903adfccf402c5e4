#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. device: the card's name and power limit; CUDA is required.
  2. build: compiles the hand-written CUDA warp kernel from the sources in
     this checkout (nvcc, sm_90a).
  3. kernel against its plain PyTorch version on the card, at the shapes of
     the flagship's main path, plus the pyramid on the card against the CPU.
  4. the flagship (4024x3036 source, 762x521 template, tolerance 180 deg,
     three planted targets) through learn_pattern + match on the card,
     which must find the three targets and launch the kernel; wall time and
     per-stage times.
  5. the port on the card against the port on the CPU on a 500x600
     three-target scene.
The last two lines of output are the kernels' JSON summary and
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

FLAGSHIP_POSES = [(1725.9, 1045.4, 0.05), (2662.9, 1537.4, -119.98),
                  (1768.9, 2098.5, 120.15)]
SMALL_POSES = [(150.0, 130.0, 0.0), (430.0, 160.0, 120.0),
               (280.0, 380.0, -120.0)]


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


# ---------------------------------------------------------------- phases

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import fastest_image_pattern_matching_tpu_torch as fipm
    from fastest_image_pattern_matching_tpu_torch.models import (
        template_matcher as tm)
    from fastest_image_pattern_matching_tpu_torch.ops import warp as W
    from fastest_image_pattern_matching_tpu_torch.ops.rounding import f32
    from fastest_image_pattern_matching_tpu_torch.ops.cuda import (
        build, warp_kernel)
    from fastest_image_pattern_matching_tpu_torch.ops.pyramid import (
        build_pyramid)
    from fastest_image_pattern_matching_tpu_torch.utils import geometry

    dev = torch.device("cuda", 0)
    # Phase 1: device.
    smi = nvidia_smi_line()
    log(f"[1 device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    # Phase 2: build.
    t0 = time.perf_counter()
    path, nvcc_s, report = build.build(warp_kernel.SOURCE)
    warp_kernel._lib()
    log(f"[2 build] {os.path.relpath(path)} nvcc {nvcc_s:.2f} s, load "
        f"{time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[2 build] ptxas: {line.strip()}")

    # Phase 3: kernel against plain version at the main path's shapes.
    scene, templ, truth = flagship_scene()
    cfg = fipm.MatchConfig(max_pos=3, score=0.7, tolerance_angle=180.0,
                           max_overlap=0.1, use_subpixel=True)
    pattern = fipm.learn_pattern(templ, 256, device=dev)
    plan = tm._make_plan(scene.shape, pattern, cfg)
    scene_d = torch.as_tensor(scene.astype(np.float32), device=dev)
    pyr = build_pyramid(scene_d, plan.top)
    pyr_cpu = build_pyramid(scene_d.cpu(), plan.top)
    for lv, (a, b) in enumerate(zip(pyr, pyr_cpu)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"pyramid level {lv} differs card vs CPU")
    log(f"[3 kernel] pyramid card == CPU bit-equal, {plan.top + 1} levels")
    inv_sweep = torch.as_tensor(tm._top_sweep_arrays(plan)[0], device=dev)
    rng = np.random.default_rng(3)

    def roi_maps(l, n, near_border=False):
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
        ang = torch.as_tensor(rng.uniform(-180, 180, n).astype(np.float32),
                              device=dev)
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
    shapes["identity"] = (pyr[0], torch.tensor(
        [[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]], device=dev), scene.shape, 0.0)

    max_err = 0.0
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
        log(f"[3 kernel] {name}: {tuple(maps.shape)} -> {tuple(got.shape)} "
            f"from {tuple(src.shape)}; quantized mismatches {n_bad}, max "
            f"|d| {d} (allowed: |d| <= 1 on < 1e-3 of pixels, at .5 "
            f"boundaries only); unquantized max |d| {du} (atol 5e-3)")
    src0, maps0, hw0, _ = shapes["identity"]
    if not torch.equal(warp_kernel.warp_affine_cuda(src0, maps0, hw0, 0.0,
                                                    True)[0], src0):
        raise AssertionError("identity warp does not reproduce the source")

    times = {}
    for name, iters in (("sweep", 200), ("L0", 20)):
        src, maps, hw, border = shapes[name]
        k = lambda: warp_kernel.warp_affine_cuda(src, maps, hw, border, True)
        p = lambda: W.warp_affine_batch(src, maps, hw, border, quantize=True)
        # plain, kernel, kernel, plain — within one call, on one card.
        pm = [cuda_ms(p, iters)]
        km = [cuda_ms(k, iters), cuda_ms(k, iters)]
        pm.append(cuda_ms(p, iters))
        times[name] = (statistics.mean(km), statistics.mean(pm))
        log(f"[3 kernel] time {name}: kernel {times[name][0]:.4f} ms, plain "
            f"{times[name][1]:.4f} ms ({smi})")

    # Phase 4: the flagship end to end, through the user entry points.
    warp_kernel.LAUNCHES = 0
    res = fipm.match(scene, pattern, cfg, device=dev)
    torch.cuda.synchronize()
    launches = warp_kernel.LAUNCHES
    log(f"[4 flagship] {len(res)} matches, warp kernel launches {launches}")
    for r in res:
        log(f"[4 flagship]   score {r.score:.4f} angle {r.angle:.3f} "
            f"centre ({r.center[0]:.2f}, {r.center[1]:.2f})")
    if launches <= 0:
        raise AssertionError("the main path never launched the warp kernel")
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

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fipm.match(scene, pattern, cfg, device=dev)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"[4 flagship] wall ms (host array in, 5 runs after warm-up): "
        f"median {statistics.median(walls):.2f}, all "
        f"{[round(w, 2) for w in walls]} ({smi})")

    stage_ms = stage_times(tm, build_pyramid, scene, pattern, cfg, dev)
    log("[4 flagship] stages ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_ms.items()) + f" ({smi})")

    # Phase 5: the port on the card against the port on the CPU.
    s_scene, s_templ, _ = small_scene()
    s_cfg = fipm.MatchConfig(max_pos=3, score=0.5, tolerance_angle=180.0,
                             min_reduce_area=256, max_overlap=0.1)
    s_pat = fipm.learn_pattern(s_templ, 256, device="cpu")
    on_card = tm.match_arrays(s_scene, s_pat, s_cfg, device=dev)
    on_cpu = tm.match_arrays(s_scene, s_pat, s_cfg, device="cpu")
    nv = int(on_cpu["valid"].sum())
    if not np.array_equal(on_card["valid"], on_cpu["valid"]) or nv != 3:
        raise AssertionError(f"valid masks differ or != 3 targets: "
                             f"{on_card['valid']} vs {on_cpu['valid']}")
    diffs = {k: float(np.abs(on_card[k][:nv] - on_cpu[k][:nv]).max())
             for k in ("score", "center", "angle")}
    log(f"[5 card vs cpu] {nv} targets; max |d| {diffs}")
    if diffs["score"] > 1e-4 or diffs["center"] > 1e-3 \
            or diffs["angle"] > 1e-3:
        raise AssertionError("port on the card disagrees with the CPU")

    kernels = {"kernels": [{
        "name": "warp_affine",
        "route": "cuda",
        "source": "fastest_image_pattern_matching_tpu_torch/csrc/"
                  "warp_affine.cu",
        "replaces": "fastest_image_pattern_matching_tpu/ops/pallas/"
                    "warp_kernel.py:86",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["L0"][0],
        "plain_ms": times["L0"][1],
    }]}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def stage_times(tm, build_pyramid, scene, pattern, cfg, dev):
    """Per-stage CUDA-event times of one flagship match, composed from the
    same stage functions match() runs."""
    import torch
    plan, stats, args = tm._prepare(scene, pattern, cfg, dev)
    st = tm.build_stages(plan, stats, dev)
    src, templs, inv_mats, trans, valid_wh, angles = args
    marks = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))

    torch.cuda.synchronize()
    mark("start")
    pyr = build_pyramid(st.prep_src(src), plan.top)
    mark("pyramid")
    vals, locs = st.sweep_maps(pyr[plan.top], templs[plan.top], inv_mats,
                               valid_wh)
    mark("sweep")
    pt, ang, score, alive = st.select_candidates(vals, locs, trans, angles)
    ptLT = st.unrotate(pt, ang)
    mark("select")
    for l in range(plan.top - 1, plan.stop - 1, -1):
        ptLT, ang, score, alive = st.descend_range(
            pyr, templs, ptLT, ang, score, alive, l, l)
        mark(f"descend_L{l}")
    scale = 1.0 if plan.stop == 0 else 2.0
    st.finalize(ptLT * scale, ang, score, alive)
    mark("finalize")
    torch.cuda.synchronize()
    return {name: prev.elapsed_time(e)
            for (_, prev), (name, e) in zip(marks, marks[1:])}


if __name__ == "__main__":
    sys.exit(main())
