#!/usr/bin/env python3
"""Hold this checkout's CUDA kernels against another checkout's, and time
the two designs in turns, on one card.

    mkdir -p scratch_unpack/parent
    git archive HEAD~1 | tar -x -C scratch_unpack/parent
    python3 compare_designs.py scratch_unpack/parent

The argument is the root of another tree of this repo (scratch_unpack/ is
listed in .gitignore). Its ops/cuda package is imported under another
name, so each design builds from its own csrc/ into its own _build/ and is
called through its own wrappers (warp_affine_cuda, ccorr_valid_cuda),
whatever its C interface. The inputs are the main path's own:
  - every warp launch of one flagship match, recorded as chip_smoke.py
    phase 3 records them (sweep, then the descent levels down to L0);
  - the correlation's launch of one Test7 match (one 1824x1824 canvas,
    27x27 template: the int8 path), the same canvas plus 0.25 (the f32
    path), and one chunk of the canvases that Test7's scene gives at
    tolerance 30 deg with quantize_warp=False (fractional: the f32 path).
Each pair of outputs must be bit-equal. Times are device times
(chip_smoke.device_ms: a CUDA graph of 20 launches) in turns: other, this,
this, other. Exits non-zero on a difference. Imports nothing of JAX.
"""

import dataclasses
import importlib
import importlib.util
import os
import sys

import numpy as np

import chip_smoke as cs

OTHER = "other_design_cuda"


def load_other(root):
    """(warp_kernel, corr_kernel) of the checkout at `root`."""
    pkg_dir = os.path.join(os.path.abspath(root),
                           "fastest_image_pattern_matching_tpu_torch", "ops",
                           "cuda")
    spec = importlib.util.spec_from_file_location(
        OTHER, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = pkg
    spec.loader.exec_module(pkg)
    return (importlib.import_module(f"{OTHER}.warp_kernel"),
            importlib.import_module(f"{OTHER}.corr_kernel"))


def compare(tag, this, other, smi):
    """Bit-equality of the two designs' outputs, then their device times
    in turns."""
    import torch
    a, b = this(), other()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{tag}: the designs differ, max |d| "
                             f"{float((a - b).abs().max())}")
    t_this, t_other = cs.turns_ms(this, other, 20, 20, timer=cs.device_ms)
    cs.log(f"{tag}: bit-equal; device this {t_this:.4f} ms, other "
           f"{t_other:.4f} ms (other / this {t_other / t_this:.3f}) ({smi})")


def main(argv) -> int:
    import torch
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_designs: this run needs an NVIDIA card",
              file=sys.stderr)
        return 2
    import fastest_image_pattern_matching_tpu_torch as fipm
    from fastest_image_pattern_matching_tpu_torch.models import (
        template_matcher as tm)
    from fastest_image_pattern_matching_tpu_torch.ops import warp as W
    from fastest_image_pattern_matching_tpu_torch.ops.cuda import (
        corr_kernel, warp_kernel)
    from fastest_image_pattern_matching_tpu_torch.ops.pyramid import (
        build_pyramid)

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    o_warp, o_corr = load_other(argv[0])
    cs.log(f"this: {os.path.dirname(os.path.abspath(__file__))}; other: "
           f"{os.path.abspath(argv[0])}; {smi}")

    scene, templ, _ = cs.flagship_scene()
    cfg = cs.flagship_config(fipm)
    pattern = fipm.learn_pattern(templ, 256, device=dev)
    calls = cs.record_calls(warp_kernel, "warp_affine_cuda",
                            lambda: fipm.match(scene, pattern, cfg,
                                               device=dev))
    for src, maps, hw, border, quantize in calls:
        compare(f"warp {maps.shape[0]}x{hw[0]}x{hw[1]} from "
                f"{src.shape[0]}x{src.shape[1]}",
                lambda: warp_kernel.warp_affine_cuda(src, maps, hw, border,
                                                     quantize),
                lambda: o_warp.warp_affine_cuda(src, maps, hw, border,
                                                quantize), smi)

    scene, templ, _ = cs.many_target_scene(3648, 100)
    cfg = cs.many_target_config(fipm, 100)
    pattern = fipm.learn_pattern(templ, cfg.min_reduce_area, device=dev)
    (canv, tc), = cs.record_calls(corr_kernel, "ccorr_valid_cuda",
                                  lambda: fipm.match(scene, pattern, cfg,
                                                     device=dev))
    cfg30 = dataclasses.replace(cs.many_target_config(fipm, 100, 30.0),
                                quantize_warp=False)
    plan = tm._make_plan(scene.shape, pattern, cfg30)
    Hc, Wc = plan.canvas_hw
    chunk = max(1, tm._CHUNK_BUDGET_ELEMS // (Hc * Wc * 4))
    pyr = build_pyramid(torch.as_tensor(scene.astype(np.float32),
                                        device=dev), plan.top)
    maps = torch.as_tensor(tm._top_sweep_arrays(plan)[0][:chunk], device=dev)
    rotated = (W.warp_affine_batch(pyr[plan.top], maps, plan.canvas_hw,
                                   float(plan.border_color), quantize=False)
               - 128.0)
    t30 = torch.as_tensor(pattern.levels[plan.top].templ, device=dev) - 128.0
    for tag, c, t in (("int8 path", canv, tc),
                      ("f32 path, canvas + 0.25", canv + 0.25, tc),
                      (f"f32 path, tol 30 unquantized, {maps.shape[0]} of "
                       f"{len(plan.angles)} angles", rotated, t30)):
        compare(f"corr {tag}: {tuple(c.shape)} x {tuple(t.shape)}",
                lambda: corr_kernel.ccorr_valid_cuda(c, t),
                lambda: o_corr.ccorr_valid_cuda(c, t), smi)
    cs.log("every pair bit-equal")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
