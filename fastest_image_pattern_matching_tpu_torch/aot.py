"""Deployment packs — the port of fastest_image_pattern_matching_tpu/aot.py.

A deployment serves one (pattern, config, frame shape, batch buckets). A
fresh process should reach its steady latency on the first frame, without
re-learning the template and without building anything:

  * `export_match_pack` writes the learned pattern, the config and the
    static plan of every program (one frame, and each match_many bucket)
    into one .npz pack; with include_executables=True it also bundles the
    shared libraries the path loads (the four CUDA kernels and the native
    host library on a card, the native library on the CPU), built first
    if this host has not built them yet.
  * `AotMatcher.load` checks the pack, installs the bundled libraries
    under the names this package's build would give them (when their
    identity is this package's and the card is sm_90; otherwise the
    bundle is refused, logged and counted in BUNDLE_REJECTS, and the
    kernels build from the package's sources exactly as without a pack),
    and puts the pattern's and the plan's tensors on the device once.
  * `export_orb_pack` / `AotOrb` do the same for ORB: config, seed and
    shapes; the per-shape ORB constants are built once at load. ORB runs
    no hand-written kernel, so its packs bundle no library.

The entries both packages write keep the JAX package's names and
encodings (format_version, kind, cfg_json, src_shape, pattern_npz, seed,
templ_shape, platforms), so the metadata of either package's pack reads
in the other. The port adds torch_version, cuda_version and
device_capability, plan_<program> (JSON of the static plan) and, with
executables, lib_<stem> (the library's bytes) and lib_<stem>_id (JSON of
its identity). A pack written by the JAX package holds serialised XLA
programs (exp_* entries) and is refused with a message naming this
package's aot-export.

SECURITY — packs are code. A pack exported with include_executables=True
bundles shared libraries, which `load` installs into the package's build
directory and the kernels' wrappers then dlopen (arbitrary code execution
for a malicious file). Only load packs from trusted sources — treat a pack
file exactly like a shared library you would dlopen. Loaders verify
format and the libraries' identity, not provenance; the trust decision is
the caller's.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import native
from .config import MatchConfig
from .models import orb as _orb
from .models import template_matcher as _tm
from .ops.cuda import build as _build
from .ops.cuda import (corr_kernel, descent_score_kernel, peaks_kernel,
                       warp_kernel)
from .types import LearnedPattern, MatchResult
from .utils.device import resolve_device
from .utils.imageio import ensure_gray

_FORMAT_VERSION = 1

# Bundled libraries refused at load in this process (identity or card not
# this package's); the kernels then build from source as without a pack.
BUNDLE_REJECTS = 0

_CUDA_SOURCES = (warp_kernel.SOURCE, corr_kernel.SOURCE,
                 peaks_kernel.SOURCE, descent_score_kernel.SOURCE)
_NATIVE_STEM = "fipm_native"


def _cfg_to_json(cfg: MatchConfig) -> str:
    return json.dumps(dataclasses.asdict(cfg))


def _cfg_from_json(s: str) -> MatchConfig:
    d = json.loads(s)
    # Packs written before MatchConfig lost its two-phase option.
    d.pop("two_phase", None)
    if d.get("tolerance_ranges") is not None:
        d["tolerance_ranges"] = tuple(d["tolerance_ranges"])
    return MatchConfig(**d)


def _plan_to_json(plan: _tm._Plan) -> str:
    d = dataclasses.asdict(plan)
    d["cfg"] = json.loads(_cfg_to_json(plan.cfg))
    return json.dumps(d)


def _plan_from_json(s: str) -> _tm._Plan:
    d = json.loads(s)
    return _tm._Plan(
        src_hw=tuple(d["src_hw"]),
        templ_shapes=tuple(tuple(t) for t in d["templ_shapes"]),
        top=d["top"], stop=d["stop"], angles=tuple(d["angles"]),
        canvas_hw=tuple(d["canvas_hw"]), k_peaks=d["k_peaks"],
        c_max=d["c_max"], nms_cap=d["nms_cap"], k_ang=d["k_ang"],
        layer_scores=tuple(d["layer_scores"]),
        border_color=d["border_color"],
        cfg=_cfg_from_json(json.dumps(d["cfg"])))


def _text(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), np.uint8)


def _read_text(data, key: str) -> str:
    return bytes(data[key]).decode()


def _stem(source: str) -> str:
    return source.rsplit(".", 1)[0]


def _bundle_libraries(dev: torch.device, timings: Dict[str, float]):
    """The pack entries of the libraries the path on `dev` loads, each
    built first when this host has not built it yet (its build seconds in
    timings, 0 when it was built already)."""
    arrs = {}
    if dev.type == "cuda":
        for source, (path, secs, _) in zip(
                _CUDA_SOURCES, _build.build_all(list(_CUDA_SOURCES))):
            stem = _stem(source)
            timings[f"build_{stem}"] = secs
            with open(path, "rb") as f:
                arrs[f"lib_{stem}"] = np.frombuffer(f.read(), np.uint8)
            arrs[f"lib_{stem}_id"] = _text(json.dumps(
                _build.library_identity(source)))
    path, secs = native.build()
    timings[f"build_{_NATIVE_STEM}"] = secs
    with open(path, "rb") as f:
        arrs[f"lib_{_NATIVE_STEM}"] = np.frombuffer(f.read(), np.uint8)
    arrs[f"lib_{_NATIVE_STEM}_id"] = _text(json.dumps(
        native.library_identity()))
    return arrs


def _install_bundle(data, path: str, dev: torch.device) -> List[str]:
    """Install the pack's bundled libraries whose identity is this
    package's (and, for the CUDA ones, whose card is sm_90) and load them;
    refuse the others with a logged warning, counted in BUNDLE_REJECTS.
    Returns the stems installed."""
    global BUNDLE_REJECTS
    installed = []
    for key in data.files:
        if not key.startswith("lib_") or key.endswith("_id"):
            continue
        stem = key[4:]
        ident = json.loads(_read_text(data, f"{key}_id"))
        source = next((s for s in _CUDA_SOURCES if _stem(s) == stem), None)
        if source is not None:
            want = _build.library_identity(source)
            card_ok = (dev.type == "cuda"
                       and torch.cuda.get_device_capability(dev) == (9, 0))
        else:
            want = native.library_identity()
            card_ok = True
        if ident != want or not card_ok:
            BUNDLE_REJECTS += 1
            logging.getLogger(__name__).warning(
                "%s: bundled library %s refused (built as %s; this package "
                "builds %s%s); building it from the package's sources",
                path, stem, ident, want,
                "" if card_ok else ", and it needs an sm_90 card")
            continue
        raw = bytes(data[key])
        if source is not None:
            _build.install(source, raw, ident)
        else:
            native.install(raw, ident)
        installed.append(stem)
    loaders = {_stem(warp_kernel.SOURCE): warp_kernel._lib,
               _stem(corr_kernel.SOURCE): corr_kernel._lib,
               _stem(peaks_kernel.SOURCE): peaks_kernel._lib,
               _stem(descent_score_kernel.SOURCE): descent_score_kernel._lib,
               _NATIVE_STEM: native.get_lib}
    for stem in installed:
        loaders[stem]()
    return installed


def _finish_pack(path, arrs, n_programs, label, log):
    """Shared tail of both exporters: write the compressed npz, log the
    uncompressed size."""
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrs)
    if log:
        log(f"{label} {path}: "
            f"{sum(np.asarray(v).nbytes for v in arrs.values())/1e6:.2f} MB "
            f"uncompressed, programs={n_programs}")


def _common_entries(dev: torch.device) -> Dict[str, np.ndarray]:
    cap = (list(torch.cuda.get_device_capability(dev))
           if dev.type == "cuda" else [])
    return {
        "format_version": np.int64(_FORMAT_VERSION),
        "platforms": _text(json.dumps([dev.type])),
        "torch_version": _text(torch.__version__),
        "cuda_version": _text(torch.version.cuda or ""),
        "device_capability": np.asarray(cap, np.int64),
    }


def _open_pack(path: str, kind: str, device):
    """np.load the pack and check what both loaders check, in the JAX
    loader's order and with its messages: the format version, the kind,
    then (port only) a pack written by the JAX package, then the platform
    against the device's type. Returns (data, resolved device)."""
    data = np.load(path)
    ver = int(data["format_version"])
    if ver != _FORMAT_VERSION:
        raise ValueError(f"unsupported pack version {ver}")
    got = _read_text(data, "kind") if "kind" in data.files else "match"
    if kind == "match" and got != "match":
        raise ValueError(
            f"{path} is a {got!r} pack, not a match pack (use AotOrb.load "
            "for ORB packs)")
    if kind == "orb" and got != "orb":
        raise ValueError(f"{path} is not an ORB pack")
    if ("torch_version" not in data.files
            and any(k.startswith("exp_") for k in data.files)):
        raise ValueError(
            f"{path} was written by the JAX package (serialised XLA "
            "programs); export it again with this package's "
            "export_match_pack / export_orb_pack, or `python -m "
            "fastest_image_pattern_matching_tpu_torch.cli aot-export`")
    platforms = json.loads(_read_text(data, "platforms"))
    dtype = torch.device("cuda" if device is None else device).type
    if dtype not in platforms:
        raise ValueError(
            f"pack was exported for {platforms}, current device is "
            f"{dtype!r} — re-export on this platform")
    return data, resolve_device(device)


def _programs(data) -> Dict[str, str]:
    return {k[len("plan_"):]: _read_text(data, k) for k in data.files
            if k.startswith("plan_")}


def _bucket_for(batch_sizes: List[int], B: int) -> int:
    buckets = [b for b in batch_sizes if b >= B]
    if not buckets:
        raise ValueError(f"no exported batch program fits B={B} "
                         f"(exported buckets: {batch_sizes})")
    return buckets[0]


def export_match_pack(path: str, pattern: LearnedPattern, cfg: MatchConfig,
                      src_shape: Tuple[int, int],
                      batch_sizes: Sequence[int] = (),
                      include_executables: bool = False,
                      log=None, device=None) -> Dict[str, float]:
    """Export the match program(s) for one deployment config.

    src_shape: (H, W) of the inspection frames this pack serves.
    batch_sizes: match_many bucket sizes to export too (a server typically
    wants its steady batch, e.g. 8).
    include_executables: also bundle the shared libraries the path loads
    on `device` (built first when this host has not built them), so a
    fresh host with the same package runs neither nvcc nor g++.
    device: the device the pack serves (CUDA unless "cpu" is asked for).

    Returns per-program seconds (plan and checks; build_<stem> for each
    bundled library's build, 0 when it was built already).
    """
    dev = resolve_device(device)
    src_shape = (int(src_shape[0]), int(src_shape[1]))
    _tm._check_sizes(pattern, src_shape)
    timings: Dict[str, float] = {}
    arrs = _common_entries(dev)
    names = ["single"] + [f"batch_{b}"
                          for b in sorted(set(int(b) for b in batch_sizes))]
    for name in names:
        t = time.perf_counter()
        arrs[f"plan_{name}"] = _text(_plan_to_json(
            _tm._make_plan(src_shape, pattern, cfg)))
        timings[name] = time.perf_counter() - t
    if include_executables:
        arrs.update(_bundle_libraries(dev, timings))
    pat_buf = io.BytesIO()
    pattern.save(pat_buf)
    arrs.update({
        "kind": _text("match"),
        "cfg_json": _text(_cfg_to_json(cfg)),
        "src_shape": np.asarray(src_shape, np.int64),
        "pattern_npz": np.frombuffer(pat_buf.getvalue(), np.uint8),
    })
    _finish_pack(path, arrs, len(names), "pack", log)
    return timings


class AotMatcher:
    """A match pipeline loaded from an exported pack — no learning, and no
    kernel build when the pack bundles this package's libraries.

    Usage:
        m = AotMatcher.load("line3.fipm-aot.npz")
        results = m.match(frame)              # [H, W] u8/f32
        batches = m.match_many(frames)        # [B, H, W], exported buckets
    """

    def __init__(self, pattern: LearnedPattern, cfg: MatchConfig,
                 src_shape: Tuple[int, int], plans: Dict[str, _tm._Plan],
                 platforms: List[str], device: torch.device,
                 installed: Sequence[str] = ()):
        self.pattern = pattern
        self.config = cfg
        self.src_shape = src_shape
        self.platforms = platforms
        self.device = device
        self.installed = tuple(installed)
        self._plans = plans
        # The counterpart of the JAX loader's _tail: the pattern's and the
        # plan's tensors on the device and the stage functions, once.
        plan = plans["single"]
        stats, templs = _tm._pattern_inputs(pattern, device)
        self._args = (templs,) + tuple(
            torch.as_tensor(a, device=device)
            for a in _tm._top_sweep_arrays(plan))
        self._stages = _tm.build_stages(plan, stats, device)

    @classmethod
    def load(cls, path: str, device=None) -> "AotMatcher":
        data, dev = _open_pack(path, "match", device)
        cfg = _cfg_from_json(_read_text(data, "cfg_json"))
        src_shape = tuple(int(v) for v in data["src_shape"])
        pattern = LearnedPattern.load(io.BytesIO(bytes(data["pattern_npz"])))
        platforms = json.loads(_read_text(data, "platforms"))
        plans = {k: _plan_from_json(v) for k, v in _programs(data).items()}
        installed = _install_bundle(data, path, dev)
        return cls(pattern, cfg, src_shape, plans, platforms, dev, installed)

    @property
    def batch_sizes(self) -> List[int]:
        return sorted(int(k.split("_")[1]) for k in self._plans
                      if k.startswith("batch_"))

    def _run(self, frames) -> List[Dict[str, np.ndarray]]:
        """Frames [N, H, W] from the input step through the loaded stages
        (template_matcher.py::_run), uploaded in one copy."""
        return _tm._run(self._plans["single"], self._stages,
                        (_tm.upload_frames(frames, self.device),)
                        + self._args)

    def match_arrays(self, src) -> Dict[str, np.ndarray]:
        frames = _tm._frames(src, one=True)
        if tuple(frames.shape[1:]) != self.src_shape:
            raise ValueError(f"pack serves frames of shape {self.src_shape},"
                             f" got {tuple(frames.shape[1:])}")
        return self._run(frames)[0]

    def match(self, src) -> List[MatchResult]:
        return _tm._results(self.match_arrays(src), self.pattern)

    def match_many(self, srcs) -> List[List[MatchResult]]:
        """B frames through the smallest exported bucket >= B; the padded
        frames of the bucket are not computed."""
        frames = _tm._frames(srcs)
        if tuple(frames.shape[1:]) != self.src_shape:
            raise ValueError(
                f"srcs must be [B, {self.src_shape[0]}, "
                f"{self.src_shape[1]}], got {tuple(frames.shape)}")
        _bucket_for(self.batch_sizes, frames.shape[0])
        return [_tm._results(o, self.pattern) for o in self._run(frames)]


# ---------------------------------------------------------------------------
# ORB packs.


def _orb_level_shapes(cfg, hw) -> List[Tuple[int, int]]:
    """The pyramid level shapes _detect_and_describe resizes hw to."""
    H, W = hw
    return [(max(8, int(round(H / cfg.scale_factor ** lvl))),
             max(8, int(round(W / cfg.scale_factor ** lvl))))
            for lvl, budget in enumerate(_orb._level_budgets(cfg))
            if budget and lvl > 0]


def _orb_constants(cfg, seed: int, shapes, dev) -> None:
    """Build the per-device and per-shape ORB constants (FAST tables,
    orientation grids, descriptor pattern and blur, resize bands, the
    RANSAC draws) into their caches."""
    on = _orb._on(dev)
    _orb._fast_consts(on)
    _orb._orientation_grids(15, on)
    _orb._descriptor_consts(on)
    _orb._ransac_samples(seed, cfg.ransac_iters, on)
    for hw in shapes:
        for h, w in _orb_level_shapes(cfg, hw):
            if h != hw[0]:
                _orb._resize_band(hw[0], h, on)
            if w != hw[1]:
                _orb._resize_band(hw[1], w, on)


def export_orb_pack(path: str, cfg, src_shape: Tuple[int, int],
                    templ_shape: Tuple[int, int],
                    batch_sizes: Sequence[int] = (), seed: int = 0,
                    include_executables: bool = False,
                    log=None, device=None) -> Dict[str, float]:
    """Export the ORB pipeline for fixed source/template shapes.

    batch_sizes: orb_match_many bucket sizes to export too (template
    described once, B sources matched in one pass). include_executables
    is accepted for the JAX package's signature; ORB runs no hand-written
    kernel, so nothing is bundled. Returns per-program seconds."""
    del include_executables
    dev = resolve_device(device)
    cfg = cfg or _orb.ORBConfig()
    src_shape = (int(src_shape[0]), int(src_shape[1]))
    templ_shape = (int(templ_shape[0]), int(templ_shape[1]))
    timings: Dict[str, float] = {}
    arrs = _common_entries(dev)
    names = ["single"] + [f"batch_{b}"
                          for b in sorted(set(int(b) for b in batch_sizes))]
    for name in names:
        t = time.perf_counter()
        arrs[f"plan_{name}"] = _text(json.dumps({
            "batch": 1 if name == "single" else int(name.split("_")[1]),
            "src_levels": _orb_level_shapes(cfg, src_shape),
            "templ_levels": _orb_level_shapes(cfg, templ_shape)}))
        timings[name] = time.perf_counter() - t
    arrs.update({
        "kind": _text("orb"),
        "cfg_json": _text(json.dumps(dataclasses.asdict(cfg))),
        "seed": np.int64(seed),
        "src_shape": np.asarray(src_shape, np.int64),
        "templ_shape": np.asarray(templ_shape, np.int64),
    })
    _finish_pack(path, arrs, len(names), "orb pack", log)
    return timings


class AotOrb:
    """ORB pipeline loaded from an exported pack, its constants built at
    load.

    Usage:
        m = AotOrb.load("orb.fipm-aot.npz")
        res = m.match(source, template)         # ORBResult
        res_list = m.match_many(sources, template)
    """

    def __init__(self, cfg, seed: int, src_shape, templ_shape,
                 batch_sizes: List[int], platforms, device: torch.device):
        self.config = cfg
        self.seed = seed
        self.src_shape = src_shape
        self.templ_shape = templ_shape
        self.platforms = platforms
        self.device = device
        self._batch_sizes = batch_sizes
        _orb_constants(cfg, seed, (src_shape, templ_shape), device)

    @classmethod
    def load(cls, path: str, device=None) -> "AotOrb":
        data, dev = _open_pack(path, "orb", device)
        cfg = _orb.ORBConfig(**json.loads(_read_text(data, "cfg_json")))
        src_shape = tuple(int(v) for v in data["src_shape"])
        templ_shape = tuple(int(v) for v in data["templ_shape"])
        platforms = json.loads(_read_text(data, "platforms"))
        batch_sizes = sorted(int(k.split("_")[1]) for k in _programs(data)
                             if k.startswith("batch_"))
        return cls(cfg, int(data["seed"]), src_shape, templ_shape,
                   batch_sizes, platforms, dev)

    @property
    def batch_sizes(self) -> List[int]:
        return list(self._batch_sizes)

    def _check(self, source, templ):
        source = np.asarray(source)
        templ = np.asarray(templ)
        if source.ndim == len(self.src_shape) + 1:
            source = ensure_gray(source)
        if templ.ndim == 3:
            templ = ensure_gray(templ)
        if tuple(templ.shape) != self.templ_shape:
            raise ValueError(f"pack serves templates of shape "
                             f"{self.templ_shape}, got {templ.shape}")
        return source, templ

    def match(self, source, template, physics_shift_mm: float = 8.0):
        source, template = self._check(source, template)
        if tuple(source.shape) != self.src_shape:
            raise ValueError(f"pack serves frames of shape {self.src_shape},"
                             f" got {source.shape}")
        packed = _orb._orb_packed(source[None], template, self.config,
                                  self.seed, self.device)
        return _orb._result_from_packed(packed[0], template.shape,
                                        physics_shift_mm)

    def match_many(self, sources, template, physics_shift_mm: float = 8.0):
        """B sources through the smallest exported bucket >= B; the padded
        sources of the bucket are not computed."""
        sources = np.asarray(sources)
        if sources.ndim == 4:
            sources = ensure_gray(sources)
        _, template = self._check(np.zeros(self.src_shape, np.uint8),
                                  template)
        if sources.ndim != 3 or tuple(sources.shape[1:]) != self.src_shape:
            raise ValueError(
                f"sources must be [B, {self.src_shape[0]}, "
                f"{self.src_shape[1]}], got {tuple(sources.shape)}")
        _bucket_for(self.batch_sizes, sources.shape[0])
        packed = _orb._orb_packed(sources, template, self.config, self.seed,
                                  self.device)
        return [_orb._result_from_packed(p, template.shape, physics_shift_mm)
                for p in packed]
