#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. device: the card's name and power limit; CUDA is required.
  2. build: compiles both hand-written CUDA kernels (warp, correlation)
     from the sources in this checkout (nvcc, sm_90a), one nvcc each, in
     parallel.
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
The last three lines of output are the kernels' JSON summary, the card's
name and power limit, and {"ok": true, "device": {...}}. Imports nothing
of JAX.
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


def many_target_scene(size, n, seed=7):
    """The tol=0 many-target scene of tools/suite_bench.py::
    _synthetic_src10 at any size: a size x size source of 235 minus noise
    in [0, 12) and n non-overlapping washer copies at least 6 px apart.
    Returns (scene, template, planted centres [(cx, cy)]) in the matcher's
    centre convention (top-left + (w/2, h/2))."""
    rng = np.random.default_rng(seed)
    t = washer_template(rng)
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


def grid_sample_call(src, maps, out_hw, border):
    """The library yardstick of the warp: one F.grid_sample call computing
    the same bilinear BORDER_CONSTANT sample (zero padding of src - border,
    plus border). Its sampling grid is made here, outside the timed call."""
    import torch
    import torch.nn.functional as F
    B = maps.shape[0]
    H, W = src.shape
    Ho, Wo = out_hw
    dev = src.device
    y = torch.arange(Ho, device=dev, dtype=torch.float32)[:, None]
    x = torch.arange(Wo, device=dev, dtype=torch.float32)[None, :]
    m = maps[:, :, :, None, None]
    fx = m[:, 0, 0] * x + m[:, 0, 1] * y + m[:, 0, 2]
    fy = m[:, 1, 0] * x + m[:, 1, 1] * y + m[:, 1, 2]
    grid = torch.stack([fx * (2.0 / (W - 1)) - 1.0,
                        fy * (2.0 / (H - 1)) - 1.0], dim=-1)
    inp = (src - border)[None, None].expand(B, 1, H, W)
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
    from fastest_image_pattern_matching_tpu_torch.ops.cuda import (
        build, corr_kernel, warp_kernel)

    dev = torch.device("cuda", 0)
    # Phase 1: device.
    smi = nvidia_smi_line()
    log(f"[1 device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    # Phase 2: build every kernel, one nvcc each, all started together.
    t0 = time.perf_counter()
    built = build.build_all([warp_kernel.SOURCE, corr_kernel.SOURCE])
    warp_kernel._lib()
    corr_kernel._lib()
    log(f"[2 build] both kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for path, nvcc_s, report in built:
        log(f"[2 build] {os.path.relpath(path)} nvcc {nvcc_s:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[2 build] ptxas: {line.strip()}")

    warp = flagship_phases(fipm, warp_kernel, dev, smi)
    corr = many_target_phases(fipm, corr_kernel, warp_kernel, dev, smi)
    print(json.dumps({"kernels": [warp, corr]}))
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
    max_err = max(max_err, main_path_warps(fipm, warp_kernel, W, scene,
                                           pattern, cfg, dev, plan, smi))

    # Phase 4: the flagship end to end, through the user entry points.
    warp_kernel.LAUNCHES = 0
    warp_kernel.global_tap_blocks(reset=True)
    res = fipm.match(scene, pattern, cfg, device=dev)
    torch.cuda.synchronize()
    launches = warp_kernel.LAUNCHES
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
    log_walls("[4 flagship]", run, smi)
    profile_match("[4 flagship]", run, smi)
    stage_ms = stage_times(tm, build_pyramid, scene, pattern, cfg, dev)
    log("[4 flagship] stages ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_ms.items()) + f" ({smi})")

    # Phase 5: the port on the card against the port on the CPU.
    s_scene, s_templ, _ = small_scene()
    s_cfg = fipm.MatchConfig(max_pos=3, score=0.5, tolerance_angle=180.0,
                             min_reduce_area=256, max_overlap=0.1)
    s_pat = fipm.learn_pattern(s_templ, 256, device="cpu")
    card_vs_cpu("[5 card vs cpu]", tm, s_scene, s_pat, s_cfg, dev, 3, 1e-4)

    km, pm, lm, bms, by, kdm, ldm = times["L0"]
    return {
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
    corr_kernel.LAUNCHES = 0
    warp_kernel.LAUNCHES = 0
    corr_kernel.path_blocks(reset=True)
    res = fipm.match(scene, pattern, cfg, device=dev)
    torch.cuda.synchronize()
    launches = corr_kernel.LAUNCHES
    n_int8, n_f32 = corr_kernel.path_blocks(reset=True)
    log(f"[7 many-target] {len(res)} matches, correlation kernel launches "
        f"{launches} (blocks on the int8 path {n_int8}, on the f32 path "
        f"{n_f32}), warp kernel launches {warp_kernel.LAUNCHES}")
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
    log_walls("[7 many-target]", run, smi)
    profile_match("[7 many-target]", run, smi)
    stage_ms = stage_times(tm, build_pyramid, scene, pattern, cfg, dev)
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
        f"(masked, K {plan.k_peaks}) {peaks_ms:.3f} ms ({smi})")

    # Phase 8: match_template on the card against the port on the CPU.
    src = np.random.default_rng(12).integers(0, 256, (1000, 1100),
                                             dtype=np.uint8)
    mt_templ = src[300:320, 400:424].copy()
    corr_kernel.LAUNCHES = 0
    on_card = fipm.match_template(src, mt_templ, device=dev)
    mt_launches = corr_kernel.LAUNCHES
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
        corr_kernel.LAUNCHES = 0
        card_vs_cpu(f"[9 card vs cpu, tol {tol:g}]", tm, s_scene, s_pat,
                    s_cfg, dev, 20, 1e-5)
        if corr_kernel.LAUNCHES <= 0:
            raise AssertionError("no correlation kernel launch")

    return {
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
    return max_err


def profile_match(tag, run, smi, runs=3):
    """torch.profiler over `runs` calls of one end-to-end path after its
    warm-up: the device's busy share of the wall time (union of the device
    intervals of kernels, copies and fills), device events and host copies
    or syncs per match, and the largest device consumers."""
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
    log(f"{tag} profile of {runs} matches: wall {wall_us / 1e3:.2f} ms, "
        f"device busy {busy / 1e3:.2f} ms ({100.0 * busy / wall_us:.1f}% of "
        f"the wall, idle {100.0 - 100.0 * busy / wall_us:.1f}%), "
        f"{len(spans) / runs:.0f} device events and {syncs / runs:.0f} host "
        f"copies or syncs per match ({smi})")
    total = sum(by_name.values()) or 1.0
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"{tag}   {100.0 * v / total:5.1f}% {v / runs / 1e3:.3f} "
            f"ms/match  {k[:80]}")


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
    log(f"{tag} wall ms (host array in, {n} runs after warm-up): median "
        f"{statistics.median(walls):.2f}, all "
        f"{[round(w, 2) for w in walls]} ({smi})")


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


def stage_times(tm, build_pyramid, scene, pattern, cfg, dev):
    """Per-stage CUDA-event times of one match, composed from the same
    stage functions match() runs."""
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
