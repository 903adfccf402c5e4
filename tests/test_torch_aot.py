"""The port's deployment packs (fastest_image_pattern_matching_tpu_torch/
aot.py) on the CPU (`device="cpu"`), against the port's unpacked path and
against the JAX package's packs on the same inputs.

Tolerances:
- a port pack against the port's own match_arrays / match_many / orb_match
  / orb_match_many: exactly equal (the same stages on the same plan);
- a port pack against a JAX pack (JAX on the CPU, as tests/test_aot.py
  runs it): valid masks equal, score within 1e-5, centre and angle within
  1e-3 (the port's end-to-end tolerances against JAX, ROADMAP);
- AotOrb against JAX's AotOrb on JAX's RANSAC draw table: is_matched
  equal, corners within 1 px, inliers within 2 (tests/test_torch_orb.py's
  orb_match tolerances);
- pack metadata (pattern_npz, cfg_json) read by the other package: equal.
The JAX exports are shared through module-scoped fixtures: one match pack
(one frame and bucket 2, as tests/test_aot.py) and one ORB pack.
"""

import dataclasses
import io
import json
import logging

import numpy as np
import pytest
import torch

import fastest_image_pattern_matching_tpu as jfipm
from fastest_image_pattern_matching_tpu import aot as jaot
from fastest_image_pattern_matching_tpu import cli as jcli
from fastest_image_pattern_matching_tpu.types import (
    LearnedPattern as JPattern)

import fastest_image_pattern_matching_tpu_torch as tfipm
from fastest_image_pattern_matching_tpu_torch import aot as taot
from fastest_image_pattern_matching_tpu_torch import cli as tcli
from fastest_image_pattern_matching_tpu_torch import native
from fastest_image_pattern_matching_tpu_torch.models import orb as torb
from fastest_image_pattern_matching_tpu_torch.models import (
    template_matcher as ttm)
from fastest_image_pattern_matching_tpu_torch.ops.cuda import (
    build, corr_kernel, peaks_kernel, warp_kernel)
from fastest_image_pattern_matching_tpu_torch.types import (
    LearnedPattern as TPattern)
from fastest_image_pattern_matching_tpu_torch.utils.imageio import save_gray
from tests.test_aot import _scene
from tests.test_orb import _textured
from tests.test_orb_serving import CFG as JAX_ORB_CFG
from tests.test_torch_batch import _rotated_problem, counted_run
from tests.test_torch_orb import jax_draws  # noqa: F401 (a fixture)

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)

CPU = "cpu"
MATCH_CFG = dict(max_pos=5, score=0.6, tolerance_angle=10.0)
KEYS = ("score", "angle", "center", "corners", "valid")
ORB_CFG = tfipm.ORBConfig(**dataclasses.asdict(JAX_ORB_CFG))


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def jax_pack(scene, tmp_path_factory):
    """The JAX package's pack (one frame and bucket 2), loaded."""
    src, tpl = scene
    cfg = jfipm.MatchConfig(**MATCH_CFG)
    pat = jfipm.learn_pattern(tpl, cfg.min_reduce_area)
    path = str(tmp_path_factory.mktemp("jaot") / "jax.npz")
    jfipm.export_match_pack(path, pat, cfg, src.shape, batch_sizes=(2,))
    return path, pat, jfipm.AotMatcher.load(path)


@pytest.fixture(scope="module")
def port_pack(scene, tmp_path_factory):
    """The port's pack of the same deployment, on the CPU."""
    src, tpl = scene
    cfg = tfipm.MatchConfig(**MATCH_CFG)
    pat = tfipm.learn_pattern(tpl, cfg.min_reduce_area, device=CPU)
    path = str(tmp_path_factory.mktemp("taot") / "port.npz")
    timings = tfipm.export_match_pack(path, pat, cfg, src.shape,
                                      batch_sizes=(2,), device=CPU)
    assert set(timings) == {"single", "batch_2"}
    return path, pat, cfg, tfipm.AotMatcher.load(path, device=CPU)


def _frames(src):
    return np.stack([src, np.roll(src, 8, axis=0)])


def _arrays(results):
    """MatchResult list -> score, angle, centre arrays."""
    return (np.array([r.score for r in results]),
            np.array([r.angle for r in results]),
            np.array([r.center for r in results]).reshape(-1, 2))


def _close_to_jax(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(_arrays(got), _arrays(want)):
        assert a.shape == b.shape
    gs, ga, gc = _arrays(got)
    ws, wa, wc = _arrays(want)
    assert np.abs(gs - ws).max() <= 1e-5
    assert np.abs(ga - wa).max() <= 1e-3
    assert np.abs(gc - wc).max() <= 1e-3


def _rewrite(path, out, **changes):
    data = dict(np.load(path))
    data.update(changes)
    np.savez_compressed(out, **data)
    return out


# ------------------------------------------------------- port pack, exact


def test_port_pack_equals_port_match_arrays(scene, port_pack):
    src, _ = scene
    _, pat, cfg, m = port_pack
    got = m.match_arrays(src)
    want = ttm.match_arrays(src, pat, cfg, device=CPU)
    assert want["valid"].sum() == 3
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_pack_match_many_equals_port_match_many(scene, port_pack):
    src, _ = scene
    _, pat, cfg, m = port_pack
    assert m.batch_sizes == [2]
    frames = _frames(src)
    got = m.match_many(frames)
    want = tfipm.match_many(frames, pat, cfg, device=CPU)
    assert [len(g) for g in got] == [len(w) for w in want] == [3, 3]
    for gs, ws in zip(got, want):
        assert [(a.score, a.angle, a.center) for a in gs] == \
            [(b.score, b.angle, b.center) for b in ws]
    # B=1 goes through the bucket-2 program.
    one = m.match_many(frames[:1])
    assert [(a.score, a.center) for a in one[0]] == \
        [(b.score, b.center) for b in want[0]]


def test_loaded_config_pattern_and_plan(scene, port_pack):
    src, _ = scene
    path, pat, cfg, m = port_pack
    assert m.config == cfg and m.src_shape == src.shape
    assert m.platforms == ["cpu"] and m.installed == ()
    for a, b in zip(m.pattern.levels, pat.levels):
        np.testing.assert_array_equal(a.templ, b.templ)
        assert (a.mean, a.norm, a.inv_area, a.result_equal1) == \
            (b.mean, b.norm, b.inv_area, b.result_equal1)
    data = np.load(path)
    for name in ("single", "batch_2"):
        plan = taot._plan_from_json(bytes(data[f"plan_{name}"]).decode())
        assert plan == ttm._make_plan(src.shape, pat, cfg)
    assert bytes(data["torch_version"]).decode() == torch.__version__


# ------------------------------------------------------ against JAX's pack


@pytest.mark.parametrize("entry", ["match_arrays", "match", "match_many"])
def test_port_pack_vs_jax_pack(scene, port_pack, jax_pack, entry):
    src, _ = scene
    m = port_pack[3]
    jm = jax_pack[2]
    if entry == "match_arrays":
        got, want = m.match_arrays(src), jm.match_arrays(src)
        np.testing.assert_array_equal(got["valid"], want["valid"])
        v = want["valid"]
        assert np.abs(got["score"] - want["score"]).max() <= 1e-5
        assert np.abs(got["center"][v] - want["center"][v]).max() <= 1e-3
        assert np.abs(got["angle"][v] - want["angle"][v]).max() <= 1e-3
    elif entry == "match":
        _close_to_jax(m.match(src), jm.match(src))
    else:
        frames = _frames(src)
        for g, w in zip(m.match_many(frames), jm.match_many(frames)):
            _close_to_jax(g, w)


def test_port_pattern_npz_loads_in_jax(port_pack, jax_pack):
    data = np.load(port_pack[0])
    got = JPattern.load(io.BytesIO(bytes(data["pattern_npz"])))
    want = jax_pack[1]
    assert (got.border_color, got.min_reduce_area, got.roi) == \
        (want.border_color, want.min_reduce_area, want.roi)
    for a, b in zip(got.levels, want.levels, strict=True):
        np.testing.assert_array_equal(a.templ, np.asarray(b.templ))
        np.testing.assert_allclose([a.mean, a.norm, a.inv_area],
                                   [b.mean, b.norm, b.inv_area], rtol=1e-12)
        assert a.result_equal1 == b.result_equal1


def test_jax_pattern_npz_loads_in_port(port_pack, jax_pack):
    data = np.load(jax_pack[0])
    got = TPattern.load(io.BytesIO(bytes(data["pattern_npz"])))
    want = port_pack[1]
    assert (got.border_color, got.min_reduce_area, got.roi) == \
        (want.border_color, want.min_reduce_area, want.roi)
    for a, b in zip(got.levels, want.levels, strict=True):
        np.testing.assert_array_equal(a.templ, b.templ)
        np.testing.assert_allclose([a.mean, a.norm, a.inv_area],
                                   [b.mean, b.norm, b.inv_area], rtol=1e-12)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_cfg_json_round_trips(port_pack, jax_pack, direction):
    if direction == "port_to_jax":
        s = bytes(np.load(port_pack[0])["cfg_json"]).decode()
        assert jaot._cfg_from_json(s) == jfipm.MatchConfig(**MATCH_CFG)
    else:
        s = bytes(np.load(jax_pack[0])["cfg_json"]).decode()
        assert taot._cfg_from_json(s) == tfipm.MatchConfig(**MATCH_CFG)
    cfg = tfipm.MatchConfig(tolerance_ranges=(-8.0, 8.0, 172.0, 188.0),
                            fast_mode=True, max_candidates=64)
    other = (jaot if direction == "port_to_jax" else taot)
    back = other._cfg_from_json(taot._cfg_to_json(cfg))
    got = json.loads(jaot._cfg_to_json(back))
    # The JAX package's config still has the two-phase option the port's
    # lost; it writes its default there.
    assert got.pop("two_phase", False) is False
    assert got == json.loads(taot._cfg_to_json(cfg))


# ------------------------------------------------------------------ guards


def test_frame_shape_and_bucket_guards(scene, port_pack):
    src, _ = scene
    m = port_pack[3]
    with pytest.raises(ValueError, match="shape"):
        m.match(src[:-8])
    with pytest.raises(ValueError, match="batch"):
        m.match_many(np.stack([src] * 3))
    with pytest.raises(ValueError, match=r"\[B, 240, 320\]"):
        m.match_many(src[:, :-1][None])


@pytest.mark.parametrize("src_shape,msg", [((40, 30), "larger than source"),
                                           ((30, 400), "size relation")])
def test_export_size_guards(port_pack, tmp_path, src_shape, msg):
    """The template-against-frame guards of match() at export time."""
    _, pat, cfg, _ = port_pack
    with pytest.raises(ValueError, match=msg):
        tfipm.export_match_pack(str(tmp_path / "p.npz"), pat, cfg,
                                src_shape, device=CPU)
    assert not (tmp_path / "p.npz").exists()


def test_format_version_guard(port_pack, tmp_path):
    bad = _rewrite(port_pack[0], str(tmp_path / "v2.npz"),
                   format_version=np.int64(2))
    with pytest.raises(ValueError, match="unsupported pack version 2"):
        tfipm.AotMatcher.load(bad, device=CPU)


def test_pack_with_two_phase_key_loads(scene, port_pack, tmp_path):
    """A pack written while MatchConfig had its two-phase option carries
    "two_phase": false in its cfg_json and in its plans' configs: it loads
    with the port's config and matches as the port does."""
    src, _ = scene
    path, pat, cfg, _ = port_pack
    data = np.load(path)
    old = {}
    for key in ["cfg_json"] + [k for k in data.files
                               if k.startswith("plan_")]:
        d = json.loads(taot._read_text(data, key))
        (d if key == "cfg_json" else d["cfg"])["two_phase"] = False
        old[key] = taot._text(json.dumps(d))
    m = tfipm.AotMatcher.load(_rewrite(path, str(tmp_path / "old.npz"),
                                       **old), device=CPU)
    assert m.config == cfg
    got = m.match_arrays(src)
    want = ttm.match_arrays(src, pat, cfg, device=CPU)
    assert want["valid"].sum() == 3
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def orb_pair():
    """tests/test_orb_serving.py's pair: a textured template turned 8 deg
    and shifted into a 240x280 source."""
    import cv2
    rng = np.random.default_rng(42)
    template = _textured(rng, 160, 200)
    M = cv2.getRotationMatrix2D((100, 80), 8.0, 1.0)
    M[:, 2] += (30, 22)
    source = cv2.warpAffine(template, M, (280, 240),
                            borderValue=90).astype(np.uint8)
    return source, template


@pytest.fixture(scope="module")
def port_orb_pack(orb_pair, tmp_path_factory):
    source, template = orb_pair
    path = str(tmp_path_factory.mktemp("torb") / "orb.npz")
    timings = tfipm.export_orb_pack(path, ORB_CFG, source.shape,
                                    template.shape, batch_sizes=(2,),
                                    device=CPU)
    assert set(timings) == {"single", "batch_2"}
    return path, tfipm.AotOrb.load(path, device=CPU)


@pytest.fixture(scope="module")
def jax_orb_pack(orb_pair, tmp_path_factory):
    source, template = orb_pair
    path = str(tmp_path_factory.mktemp("jorb") / "orb.npz")
    jaot.export_orb_pack(path, JAX_ORB_CFG, source.shape, template.shape)
    return path, jaot.AotOrb.load(path)


def test_match_loader_refuses_orb_pack(port_orb_pack):
    with pytest.raises(ValueError, match="not a match pack"):
        tfipm.AotMatcher.load(port_orb_pack[0], device=CPU)


def test_orb_loader_refuses_match_pack(port_pack):
    with pytest.raises(ValueError, match="not an ORB pack"):
        tfipm.AotOrb.load(port_pack[0], device=CPU)


@pytest.mark.parametrize("kind", ["match", "orb"])
def test_jax_written_pack_refused(jax_pack, jax_orb_pack, kind):
    if kind == "match":
        with pytest.raises(ValueError, match="aot-export"):
            tfipm.AotMatcher.load(jax_pack[0], device=CPU)
    else:
        with pytest.raises(ValueError, match="aot-export"):
            tfipm.AotOrb.load(jax_orb_pack[0], device=CPU)


@pytest.mark.parametrize("loader", ["match", "orb"])
def test_cpu_pack_refused_by_a_cuda_load(port_pack, port_orb_pack, loader):
    """The platform check comes before the device is resolved, so it is
    tested here without a card."""
    if loader == "match":
        with pytest.raises(ValueError, match="re-export on this platform"):
            tfipm.AotMatcher.load(port_pack[0], device="cuda")
    else:
        with pytest.raises(ValueError, match="re-export on this platform"):
            tfipm.AotOrb.load(port_orb_pack[0])


# ----------------------------------------------- NMS overflow, dual range


def test_overflow_pack_equals_port(tmp_path, monkeypatch):
    """More above-threshold candidates than the NMS cap in two of three
    frames (tests/test_torch_batch.py's tol30_overflow problem): the pack
    sweeps and descends once a call and finalizes again uncapped, as
    match_arrays and match_many do, with the same results."""
    frames, tpl = _rotated_problem()
    cfg = tfipm.MatchConfig(max_pos=16, score=0.02, tolerance_angle=30.0,
                            max_overlap=0.7, use_subpixel=False)
    pat = tfipm.learn_pattern(tpl, cfg.min_reduce_area, device=CPU)
    path = str(tmp_path / "p.npz")
    tfipm.export_match_pack(path, pat, cfg, frames.shape[1:],
                            batch_sizes=(4,), device=CPU)
    m = tfipm.AotMatcher.load(path, device=CPU)
    c_max = m._plans["single"].c_max
    assert m._plans["single"].nms_cap < c_max
    one = [(None, [True]), (c_max, [False])]
    got, sweeps, descents, finalizes = counted_run(
        monkeypatch, lambda: m.match_arrays(frames[0]))
    assert (sweeps, descents, finalizes) == (1, 1, one)
    want, *counts = counted_run(
        monkeypatch, lambda: ttm.match_arrays(frames[0], pat, cfg,
                                              device=CPU))
    assert counts == [1, 1, one]
    assert want["valid"].all()
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    many, *counts = counted_run(monkeypatch, lambda: m.match_many(frames))
    assert counts == [1, 1, [(None, [True, True, False]),
                             (c_max, [False, False, False])]]
    want = tfipm.match_many(frames, pat, cfg, device=CPU)
    assert [len(g) for g in many] == [len(w) for w in want] == [16, 16, 0]
    for gs, ws in zip(many, want):
        assert [(a.score, a.angle, a.center) for a in gs] == \
            [(b.score, b.angle, b.center) for b in ws]


def test_pack_dual_range_and_regions(tmp_path):
    """tests/test_aot.py::test_pack_dual_range_and_regions for the port:
    the dual tolerance ranges, a learn-time roi and marked regions."""
    rng = np.random.default_rng(9)
    full = rng.integers(0, 255, (70, 90), dtype=np.uint8)
    roi = (20, 10, 40, 48)
    tpl = full[roi[1]:roi[1] + roi[3], roi[0]:roi[0] + roi[2]]
    src = rng.integers(90, 140, (220, 300), dtype=np.uint8)
    src[60:60 + roi[3], 110:110 + roi[2]] = tpl
    cfg = tfipm.MatchConfig(max_pos=3, score=0.6,
                            tolerance_ranges=(-8.0, 8.0, 172.0, 188.0))
    pat = tfipm.learn_pattern(full, cfg.min_reduce_area, roi=roi,
                              regions=[[(2, 2), (30, 2), (16, 40)]],
                              device=CPU)
    path = str(tmp_path / "pack.npz")
    tfipm.export_match_pack(path, pat, cfg, src.shape, device=CPU)
    m = tfipm.AotMatcher.load(path, device=CPU)
    assert m.config.tolerance_ranges == (-8.0, 8.0, 172.0, 188.0)
    assert m.pattern.roi == roi and len(m.pattern.regions) == 1
    got = m.match_arrays(src)
    want = ttm.match_arrays(src, pat, cfg, device=CPU)
    assert want["valid"].sum() >= 1
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ref = tfipm.match(src, pat, cfg, device=CPU)
    res = m.match(src)
    assert len(res) == len(ref) >= 1
    for a, b in zip(res, ref):
        assert len(a.regions) == 1
        np.testing.assert_array_equal(a.regions[0], b.regions[0])


# ------------------------------------------------------- bundle install


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """Both build directories in tmp_path; the wrappers' loaders record
    their calls instead of dlopening; the card reads as sm_90."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    loaded = []
    for mod, name in ((warp_kernel, "_lib"), (corr_kernel, "_lib"),
                      (peaks_kernel, "_lib"), (native, "get_lib")):
        monkeypatch.setattr(mod, name, lambda m=mod: loaded.append(m))
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda dev=None: (9, 0))
    return tmp_path, loaded


def _bundle(tmp_path, ids, payload=b"stand-in library"):
    arrs = {}
    for stem, ident in ids.items():
        arrs[f"lib_{stem}"] = np.frombuffer(payload + stem.encode(),
                                            np.uint8)
        arrs[f"lib_{stem}_id"] = taot._text(json.dumps(ident))
    path = str(tmp_path / "bundle.npz")
    np.savez_compressed(path, **arrs)
    return np.load(path), path


def _cuda_ids():
    return {"warp_affine": build.library_identity(warp_kernel.SOURCE),
            "ccorr_valid": build.library_identity(corr_kernel.SOURCE),
            "peaks": build.library_identity(peaks_kernel.SOURCE),
            "fipm_native": native.library_identity()}


def test_bundle_with_this_packages_identity_is_installed(build_dir):
    tmp, loaded = build_dir
    data, path = _bundle(tmp, _cuda_ids())
    rejects, runs = taot.BUNDLE_REJECTS, build.NVCC_RUNS
    installed = taot._install_bundle(data, path, torch.device("cuda"))
    assert sorted(installed) == ["ccorr_valid", "fipm_native", "peaks",
                                 "warp_affine"]
    for src in (warp_kernel.SOURCE, corr_kernel.SOURCE, peaks_kernel.SOURCE):
        stem = src.rsplit(".", 1)[0]
        with open(build._library_path(src), "rb") as f:
            assert f.read() == b"stand-in library" + stem.encode()
    with open(native.library_path(), "rb") as f:
        assert f.read() == b"stand-in libraryfipm_native"
    assert sorted(tmp.iterdir()) == sorted(
        [tmp / "bundle.npz", tmp / build._library_path(
            warp_kernel.SOURCE).rsplit("/", 1)[1],
         tmp / build._library_path(corr_kernel.SOURCE).rsplit("/", 1)[1],
         tmp / build._library_path(peaks_kernel.SOURCE).rsplit("/", 1)[1],
         tmp / native.library_path().rsplit("/", 1)[1]])
    assert len(loaded) == 4
    assert (taot.BUNDLE_REJECTS, build.NVCC_RUNS) == (rejects, runs)
    # An installed file is left as it is.
    data2, path2 = _bundle(tmp, {"warp_affine": _cuda_ids()["warp_affine"]},
                           b"other bytes")
    taot._install_bundle(data2, path2, torch.device("cuda"))
    with open(build._library_path(warp_kernel.SOURCE), "rb") as f:
        assert f.read() == b"stand-in librarywarp_affine"


@pytest.mark.parametrize("fault", ["cuda_version", "source_hash", "arch",
                                   "card", "native_machine"])
def test_bundle_with_another_identity_is_refused(build_dir, caplog, fault,
                                                 monkeypatch):
    tmp, loaded = build_dir
    ids = _cuda_ids()
    stem = "fipm_native" if fault == "native_machine" else "warp_affine"
    if fault == "cuda_version":
        ids[stem] = dict(ids[stem], cuda="11.8")
    elif fault == "source_hash":
        ids[stem] = dict(ids[stem], sha256="0" * 64)
    elif fault == "arch":
        ids[stem] = dict(ids[stem], arch="sm_80")
    elif fault == "native_machine":
        ids[stem] = dict(ids[stem], machine="riscv64")
    else:
        monkeypatch.setattr(torch.cuda, "get_device_capability",
                            lambda dev=None: (8, 0))
    data, path = _bundle(tmp, {stem: ids[stem]})
    rejects = taot.BUNDLE_REJECTS
    with caplog.at_level(logging.WARNING, logger=taot.__name__):
        installed = taot._install_bundle(data, path, torch.device("cuda"))
    assert installed == [] and loaded == []
    assert taot.BUNDLE_REJECTS == rejects + 1
    assert f"bundled library {stem} refused" in caplog.text
    assert sorted(p.name for p in tmp.iterdir()) == ["bundle.npz"]


def test_install_functions_check_identity(build_dir):
    tmp, _ = build_dir
    bad = dict(build.library_identity(warp_kernel.SOURCE), cuda="0.0")
    with pytest.raises(ValueError, match="this package builds"):
        build.install(warp_kernel.SOURCE, b"x", bad)
    with pytest.raises(ValueError, match="this package builds"):
        native.install(b"x", dict(native.library_identity(), sha256=""))
    assert list(tmp.iterdir()) == []


def test_cpu_pack_bundles_the_native_library(scene, tmp_path):
    """include_executables on the CPU bundles the one library the CPU path
    loads (the native BMP codec), with this package's identity."""
    src, tpl = scene
    cfg = tfipm.MatchConfig(**MATCH_CFG)
    pat = tfipm.learn_pattern(tpl, cfg.min_reduce_area, device=CPU)
    path = str(tmp_path / "exe.npz")
    timings = tfipm.export_match_pack(path, pat, cfg, src.shape, device=CPU,
                                      include_executables=True)
    assert "build_fipm_native" in timings
    data = np.load(path)
    assert sorted(k for k in data.files if k.startswith("lib_")) == [
        "lib_fipm_native", "lib_fipm_native_id"]
    assert json.loads(bytes(data["lib_fipm_native_id"]).decode()) == \
        native.library_identity()
    with open(native.library_path(), "rb") as f:
        assert bytes(data["lib_fipm_native"]) == f.read()
    rejects = taot.BUNDLE_REJECTS
    m = tfipm.AotMatcher.load(path, device=CPU)
    assert m.installed == ("fipm_native",)
    assert taot.BUNDLE_REJECTS == rejects


# ------------------------------------------------------------------ AotOrb


def _orb_same(a, b):
    assert (a.is_matched, a.num_inliers, a.num_good_matches) == \
        (b.is_matched, b.num_inliers, b.num_good_matches)
    for k in ("homography", "corners", "src_pts", "dst_pts", "inlier_mask"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)
    assert (a.avg_pixel_shift, a.rotation_angle, a.scale_mm_per_pix) == \
        (b.avg_pixel_shift, b.rotation_angle, b.scale_mm_per_pix)


def test_aot_orb_equals_port_orb(orb_pair, port_orb_pack):
    source, template = orb_pair
    m = port_orb_pack[1]
    assert m.batch_sizes == [2] and m.config == ORB_CFG
    ref = tfipm.orb_match(source, template, ORB_CFG, device=CPU)
    assert ref.is_matched
    _orb_same(m.match(source, template), ref)
    srcs = np.stack([source, np.roll(source, 5, axis=1)])
    for a, b in zip(m.match_many(srcs, template),
                    tfipm.orb_match_many(srcs, template, ORB_CFG,
                                         device=CPU), strict=True):
        _orb_same(a, b)
    with pytest.raises(ValueError, match="shape"):
        m.match(source[:-2], template)
    with pytest.raises(ValueError, match="templates of shape"):
        m.match(source, template[:-2])
    with pytest.raises(ValueError, match="batch"):
        m.match_many(np.stack([source] * 3), template)


def test_aot_orb_vs_jax_aot_orb(orb_pair, port_orb_pack, jax_orb_pack,
                                jax_draws):  # noqa: F811
    source, template = orb_pair
    got = port_orb_pack[1].match(source, template)
    want = jax_orb_pack[1].match(source, template)
    assert got.is_matched and want.is_matched
    assert np.abs(got.corners - want.corners).max() <= 1.0
    assert abs(got.num_inliers - want.num_inliers) <= 2


def test_orb_pack_builds_its_constants_at_load(orb_pair, port_orb_pack):
    """Load builds every per-device and per-shape constant; a match after
    it builds none."""
    caches = (torb._fast_consts, torb._orientation_grids,
              torb._descriptor_consts, torb._ransac_samples,
              torb._resize_band)
    for c in caches:
        c.cache_clear()
    m = tfipm.AotOrb.load(port_orb_pack[0], device=CPU)
    n_bands = len({band for hw in (m.src_shape, m.templ_shape)
                   for h, w in taot._orb_level_shapes(m.config, hw)
                   for band in ((hw[0], h), (hw[1], w)) if band[0] != band[1]})
    assert n_bands > 0
    assert [c.cache_info().currsize for c in caches] == [1, 1, 1, 1,
                                                         n_bands]
    misses = [c.cache_info().misses for c in caches]
    m.match(*orb_pair)
    m.match_many(orb_pair[0][None], orb_pair[1])
    assert [c.cache_info().misses for c in caches] == misses


# --------------------------------------------------------------------- CLI


def test_cli_aot_export_and_match(tmp_path, capsys, monkeypatch):
    """aot-export then aot-match --json --device cpu in process, against
    the port's match and the JAX CLI's aot-match (tests/test_cli_aot.py's
    scene)."""
    import cv2
    rng = np.random.default_rng(9)
    t = np.full((40, 56), 30, np.uint8)
    cv2.rectangle(t, (4, 4), (51, 35), 200, 2)
    cv2.line(t, (8, 8), (48, 30), 255, 3)
    src = rng.integers(0, 30, (200, 240), np.uint8)
    src[40:80, 60:116] = t
    sp, tp = str(tmp_path / "scene.bmp"), str(tmp_path / "tpl.bmp")
    save_gray(sp, src)
    save_gray(tp, t)
    flags = ["--source-shape", "200", "240", "--max-pos", "3", "--score",
             "0.8", "--tolerance-angle", "0", "--include-executables"]
    pp, jp = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert tcli.main(["--device", CPU, "aot-export", "-t", tp, "-o", pp]
                     + flags) == 0
    assert capsys.readouterr().out.startswith(f"exported {pp}")
    assert tcli.main(["--device", CPU, "aot-match", "-p", pp, "-s", sp,
                      "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert tcli.main(["--device", CPU, "aot-match", "-p", pp, "-s", sp]) == 0
    assert "no learning" in capsys.readouterr().out

    cfg = tfipm.MatchConfig(max_pos=3, score=0.8, tolerance_angle=0.0)
    want = tfipm.match(src, tfipm.learn_pattern(t, 256, device=CPU), cfg,
                       device=CPU)
    assert got["count"] == len(want) == 1
    assert got["matches"] == [{
        "index": i, "score": r.score, "angle": r.angle, "pos_x": r.pos_x,
        "pos_y": r.pos_y} for i, r in enumerate(want)]

    monkeypatch.setenv("FIPM_CACHE_DIR", "")
    assert jcli.main(["aot-export", "-t", tp, "-o", jp] + flags) == 0
    capsys.readouterr()
    assert jcli.main(["aot-match", "-p", jp, "-s", sp, "--json"]) == 0
    jgot = json.loads(capsys.readouterr().out)
    assert jgot["count"] == got["count"]
    for g, w in zip(got["matches"], jgot["matches"]):
        assert abs(g["score"] - w["score"]) <= 1e-5
        for k in ("angle", "pos_x", "pos_y"):
            assert abs(g[k] - w[k]) <= 1e-3
    # The JAX CLI's pack is refused by the port's aot-match.
    with pytest.raises(ValueError, match="aot-export"):
        tcli.main(["--device", CPU, "aot-match", "-p", jp, "-s", sp])
