"""The port's sharded paths (parallel/) over torch.distributed with gloo, in
CPU processes: one spawn of a world of 2 ranks and one of 4, side by
side, run every case, and the pytest process holds what they return
against the port's
unsharded paths and against the JAX package's sharded matcher on the 8
virtual CPU devices of tests/conftest.py.

match_batch_sharded over meshes (1, 2), (2, 1), (1, 4), (2, 2), (4, 1) on
the configs of __graft_entry__.py::dryrun_multichip (base, dual-range,
fast-mode, nms-overflow with max_pos=16 and score=0.05, narrow) with
B = 3 frames, not a multiple of the data axis, and one more case,
narrow-large, whose 72x80 template is large enough (> 4096 px) for the
narrowing to run and whose score (0.15) leaves more alive candidates than
it keeps, so that build_stages' narrow_hook masks candidates across ranks.
Every rank returns every frame; each is held to the port's own
match_many_arrays (valid masks equal, score 1e-6, centre and angle 1e-5),
and each case on one mesh shape (every shape and every case once; a JAX
sharded compile takes 4-10 s on a CPU) to JAX's match_batch_sharded on
the same mesh shape (score 1e-5, pose 1e-3). nms-overflow's pose is held
to 3e-2: its noise-level candidates (score 0.05) make the 3x3x3 subpixel
fit ill-conditioned, and the port's f64 fit and JAX's f32 one part by up
to 1.45e-2 px and 2.57e-2 deg on frame 0 (a score-0.20 candidate),
sharded or not: each side's sharded result equals its own unsharded one
exactly (ROADMAP queue 3 item 3). orb_match_many_sharded,
match_patterns_sharded and inspect_corpus(mesh=...) are held to their
unsharded twins.

The workers import this module (pickle finds the worker function by
name), so JAX is imported only inside the tests and fixtures: the
workers must not import it. Each worker's init_process_group has a
timeout, and the spawning fixture kills the workers that outlive its
deadline. The workers run on one thread each at the lowest CPU priority:
the test processes that run beside them (pytest-xdist) keep JAX's
multi-threaded pools, which stall badly when extra runnable threads take
their cores (torch's, too, until every test file set it to one thread),
so under a full test run the worlds took up to 25x their time alone
(about 35 s), and the deadline allows for that.
"""

import dataclasses
import datetime
import multiprocessing
import os
import pickle
import socket
import time
import traceback

import numpy as np
import pytest
import torch

import chip_smoke
import fastest_image_pattern_matching_tpu_torch as tfipm
from fastest_image_pattern_matching_tpu_torch.parallel import mesh as tmesh

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)

MESHES = {2: [(1, 2), (2, 1)], 4: [(1, 4), (2, 2), (4, 1)]}
CASES = ["base", "dual-range", "fast-mode", "nms-overflow", "narrow",
         "narrow-large"]
JAX_PAIRS = [((1, 2), "base"), ((2, 1), "dual-range"), ((1, 4), "fast-mode"),
             ((2, 2), "nms-overflow"), ((4, 1), "narrow"),
             ((2, 2), "narrow-large")]
GLYPHS = "01A7B9"
DEADLINE_S = 1300


def _configs(cfg):
    r = dataclasses.replace
    return {
        "base": ("graft", cfg),
        "dual-range": ("graft", r(cfg, tolerance_ranges=(-15.0, 15.0, 165.0,
                                                         195.0))),
        "fast-mode": ("graft", r(cfg, fast_mode=True)),
        "nms-overflow": ("graft", r(cfg, max_pos=16, score=0.05)),
        "narrow": ("graft", r(cfg, narrow_candidates=True)),
        "narrow-large": ("large", r(cfg, narrow_candidates=True,
                                    score=0.15)),
    }


def _orb_case():
    """__graft_entry__.py's ORB scenes drawn without cv2: an 80x100 part
    pasted at a walk into three 200x260 noise scenes."""
    rng = np.random.default_rng(5)
    otpl = chip_smoke.orb_template((80, 100), 7)
    scenes = []
    for i in range(3):
        sc = rng.integers(0, 50, (200, 260)).astype(np.uint8)
        sc[30 + 10 * i:110 + 10 * i, 40 + 15 * i:140 + 15 * i] = otpl
        scenes.append(sc)
    return np.stack(scenes), otpl, tfipm.ORBConfig(max_features=150,
                                                   max_good_matches=60)


def _orb_fields(r):
    return (r.is_matched, r.num_inliers, r.num_good_matches,
            None if r.homography is None else np.asarray(r.homography),
            None if r.corners is None else np.asarray(r.corners))


def _reports(reports):
    return [(r.index, [(m.score, m.angle, m.pos_x, m.pos_y)
                       for m in r.results]) for r in reports]


def _worker(rank, world, addr, payload, outdir):
    """One rank: every sharded call of its world, results pickled to
    outdir/r{rank}.pkl (a traceback to outdir/r{rank}.err on failure)."""
    try:
        os.nice(19)
        torch.set_num_threads(1)
        tfipm.init_distributed("gloo", addr, world, rank,
                               timeout=datetime.timedelta(seconds=120))
        out = {}
        for shape in MESHES[world]:
            mesh = tfipm.make_mesh(shape, device="cpu")
            out[("mesh", shape)] = (mesh.coords, mesh.members("data"),
                                    mesh.members("angle"))
            for case, (prob, cfg) in payload["cases"].items():
                srcs, pat = payload["problems"][prob]
                out[(shape, case)] = tfipm.match_batch_sharded(srcs, pat, cfg,
                                                               mesh)
            frames, cpat, ccfg = payload["corpus"]
            out[("corpus", shape)] = _reports(tfipm.inspect_corpus(
                iter(frames), cpat, ccfg, mesh=mesh, batch_size=2))
        dmesh = tfipm.make_data_mesh(device="cpu")
        out["data_mesh"] = dmesh.shape
        out["orb"] = [_orb_fields(r) for r in tfipm.orb_match_many_sharded(
            *payload["orb"], mesh=dmesh)]
        scene, pats, gcfg = payload["glyphs"]
        out["glyphs"] = tfipm.match_patterns_sharded(scene, pats, gcfg,
                                                     mesh=dmesh)
        torch.distributed.destroy_process_group()
        with open(os.path.join(outdir, f"r{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(outdir, f"r{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(world, payload, outdir):
    """Start a world of `world` gloo ranks; returns their processes."""
    os.makedirs(outdir)
    ctx = multiprocessing.get_context("spawn")
    addr = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_worker, args=(r, world, addr, payload,
                                               outdir))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _collect(world, procs, outdir, deadline):
    """Wait for a world's ranks until the deadline; returns each rank's
    results."""
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    errs = {r: open(os.path.join(outdir, f"r{r}.err")).read()
            for r in range(world)
            if os.path.exists(os.path.join(outdir, f"r{r}.err"))}
    assert not hung, f"ranks {hung} of world {world} hung"
    assert not errs, f"ranks failed: {errs}"
    assert [p.exitcode for p in procs] == [0] * world
    outs = []
    for r in range(world):
        with open(os.path.join(outdir, f"r{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The problems (built with the JAX package, as
    __graft_entry__.py::dryrun_multichip builds them), the port's patterns
    of them, and both worlds' results."""
    from __graft_entry__ import _example_problem
    problems, jax_problems = {}, {}
    for name, kw in (("graft", dict(src_hw=(160, 192), templ_hw=(32, 48))),
                     ("large", dict(src_hw=(200, 240), templ_hw=(72, 80)))):
        _, _, jpat, cfg, src, _ = _example_problem(**kw)
        srcs = np.stack([src, src[::-1].copy(), src])
        problems[name] = (srcs, tfipm.pattern_from_reference(jpat))
        jax_problems[name] = (srcs, jpat)
    cases = _configs(cfg)
    templ = chip_smoke.stream_template()
    frames, _ = chip_smoke.stream_frames(templ, 4, hw=(180, 240))
    straggler, _ = chip_smoke.stream_frames(templ, 1, hw=(160, 220), seed=6)
    ccfg = tfipm.MatchConfig(max_pos=2, score=0.6, tolerance_angle=15.0)
    corpus = (list(frames) + [straggler[0]],
              tfipm.learn_pattern(templ, 256, device="cpu"), ccfg)
    scene, _ = chip_smoke.ocr_plate("B1A07", hw=(120, 320), x0=16, y0=34)
    glyphs = (scene, [tfipm.learn_pattern(chip_smoke.glyph(c), 256,
                                          device="cpu") for c in GLYPHS],
              chip_smoke.ocr_config(tfipm))
    payload = dict(problems=problems, cases=cases, corpus=corpus,
                   orb=_orb_case(), glyphs=glyphs)
    base = tmp_path_factory.mktemp("gloo")
    dirs = {w: str(base / f"world{w}") for w in MESHES}
    procs = {}
    try:
        for w in MESHES:
            procs[w] = _start(w, payload, dirs[w])
        deadline = time.monotonic() + DEADLINE_S
        runs = {w: _collect(w, procs[w], dirs[w], deadline) for w in MESHES}
    finally:
        for p in (p for ps in procs.values() for p in ps):
            if p.is_alive():
                p.kill()
                p.join(10)
    return dict(payload=payload, jax_problems=jax_problems, runs=runs)


def _ranks(setup, shape):
    world = shape[0] * shape[1]
    return setup["runs"][world]


def _same(got, want, atol_score, atol_pose, tag):
    np.testing.assert_array_equal(got["valid"], want["valid"], err_msg=tag)
    v = want["valid"]
    np.testing.assert_allclose(got["score"][v], want["score"][v],
                               atol=atol_score, rtol=0, err_msg=tag)
    for k in ("center", "angle"):
        np.testing.assert_allclose(got[k][v], want[k][v], atol=atol_pose,
                                   rtol=0, err_msg=f"{tag} {k}")


@pytest.fixture(scope="module")
def unsharded(setup):
    out = {}
    for case, (prob, cfg) in setup["payload"]["cases"].items():
        srcs, pat = setup["payload"]["problems"][prob]
        out[case] = tfipm.match_many_arrays(srcs, pat, cfg, device="cpu")
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", MESHES[2] + MESHES[4])
def test_match_batch_sharded_equals_port(setup, unsharded, shape, case):
    want = unsharded[case]
    assert want["valid"].shape[0] == 3
    for r, out in enumerate(_ranks(setup, shape)):
        got = out[(shape, case)]
        assert got["valid"].shape == want["valid"].shape
        np.testing.assert_array_equal(got["score"][~want["valid"]], -1.0)
        _same(got, want, 1e-6, 1e-5, f"{shape} {case} rank {r}")
    assert want["valid"][0].any(), "the case finds nothing"


@pytest.mark.parametrize("shape,case", JAX_PAIRS)
def test_match_batch_sharded_equals_jax_sharded(setup, shape, case):
    import jax
    from fastest_image_pattern_matching_tpu.parallel.matcher import (
        match_batch_sharded)
    from fastest_image_pattern_matching_tpu.parallel.mesh import make_mesh
    prob, cfg = setup["payload"]["cases"][case]
    srcs, jpat = setup["jax_problems"][prob]
    jmesh = make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])
    want = match_batch_sharded(srcs, jpat, cfg, jmesh)
    pose = 3e-2 if case == "nms-overflow" else 1e-3
    for r, out in enumerate(_ranks(setup, shape)):
        _same(out[(shape, case)], want, 1e-5, pose,
              f"{shape} {case} rank {r}")


@pytest.mark.parametrize("shape", MESHES[2] + MESHES[4])
def test_mesh_layout(setup, shape):
    """Rank r sits at (r // na, r % na); its data group is its column and
    its angle group its row."""
    na = shape[1]
    for r, out in enumerate(_ranks(setup, shape)):
        coords, data, angle = out[("mesh", shape)]
        assert coords == (r // na, r % na)
        assert data == [coords[1] + na * i for i in range(shape[0])]
        assert angle == [coords[0] * na + j for j in range(na)]


@pytest.mark.parametrize("shape", MESHES[2] + MESHES[4])
def test_inspect_corpus_mesh_equals_unsharded(setup, shape):
    frames, cpat, ccfg = setup["payload"]["corpus"]
    want = _reports(tfipm.inspect_corpus(iter(frames), cpat, ccfg,
                                         batch_size=2, device="cpu"))
    assert [i for i, _ in want] == list(range(5))
    assert all(len(m) == 1 for _, m in want)
    for out in _ranks(setup, shape):
        got = out[("corpus", shape)]
        assert [i for i, _ in got] == [i for i, _ in want]
        for (_, g), (_, w) in zip(got, want):
            assert len(g) == len(w)
            np.testing.assert_allclose(np.array(g), np.array(w), atol=1e-5,
                                       rtol=0)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_orb_match_many_sharded_equals_unsharded(setup, world):
    sources, templ, ocfg = setup["payload"]["orb"]
    want = [_orb_fields(r) for r in tfipm.orb_match_many(
        sources, templ, ocfg, device="cpu")]
    assert all(w[0] for w in want)
    for out in setup["runs"][world]:
        assert out["data_mesh"] == (world, 1)
        assert len(out["orb"]) == len(want)
        for g, w in zip(out["orb"], want):
            assert g[:3] == w[:3]
            np.testing.assert_array_equal(g[3], w[3])
            np.testing.assert_array_equal(g[4], w[4])


@pytest.mark.parametrize("world", sorted(MESHES))
def test_match_patterns_sharded_equals_unsharded(setup, world):
    scene, pats, gcfg = setup["payload"]["glyphs"]
    want = tfipm.match_patterns(scene, pats, gcfg, device="cpu")
    assert [bool(w["valid"].any()) for w in want] == [c in "B1A07"
                                                      for c in GLYPHS]
    for out in setup["runs"][world]:
        assert len(out["glyphs"]) == len(GLYPHS)
        for ch, g, w in zip(GLYPHS, out["glyphs"], want):
            _same(g, w, 1e-6, 1e-5, ch)


@pytest.mark.parametrize("n", range(1, 9))
def test_default_mesh_shape_as_jax(n):
    import jax
    from fastest_image_pattern_matching_tpu.parallel.mesh import make_mesh
    want = make_mesh(devices=jax.devices()[:n]).devices.shape
    assert tmesh._default_shape(n) == want


def test_world_one_mesh_without_process_group():
    """No process group: init_distributed is a no-op, the mesh is (1, 1)
    with no groups, its gathers are identities, and the sharded calls
    equal the unsharded ones."""
    assert tfipm.init_distributed() is None
    assert not torch.distributed.is_initialized()
    mesh = tfipm.make_mesh(device="cpu")
    assert mesh.shape == (1, 1) and mesh.coords == (0, 0)
    assert mesh.groups == (None, None) and mesh.device.type == "cpu"
    x = torch.arange(6).reshape(2, 3)
    assert mesh.all_gather(x, tmesh.DATA_AXIS) is x
    assert tfipm.make_data_mesh(device="cpu").shape == (1, 1)
    with pytest.raises(ValueError, match="mesh shape"):
        tfipm.make_mesh((2, 1), device="cpu")
    with pytest.raises(ValueError, match="distinct ranks"):
        tfipm.make_mesh(ranks=[0, 1], device="cpu")
    templ = chip_smoke.stream_template()
    frames, _ = chip_smoke.stream_frames(templ, 3, hw=(160, 200))
    pat = tfipm.learn_pattern(templ, 256, device="cpu")
    cfg = tfipm.MatchConfig(max_pos=2, score=0.6, tolerance_angle=30.0)
    _same(tfipm.match_batch_sharded(frames, pat, cfg, mesh),
          tfipm.match_many_arrays(frames, pat, cfg, device="cpu"), 1e-6,
          1e-5, "world 1")


def test_sharded_guards():
    mesh = tfipm.make_mesh(device="cpu")
    pat = tfipm.learn_pattern(chip_smoke.stream_template(), 256,
                              device="cpu")
    with pytest.raises(ValueError, match="larger"):
        tfipm.match_batch_sharded(np.zeros((2, 50, 60), np.uint8), pat,
                                  mesh=mesh)
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        tfipm.match_batch_sharded(np.zeros((50, 60), np.uint8), pat,
                                  mesh=mesh)
    with pytest.raises(ValueError, match="8-bit"):
        tfipm.match_batch_sharded(np.full((1, 90, 100), 300.0), pat,
                                  mesh=mesh)
