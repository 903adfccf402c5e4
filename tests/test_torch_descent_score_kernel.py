"""The descent-score kernel (csrc/descent_score.cu,
ops/cuda/descent_score_kernel.py) and its plain version
(ops/ncc.py::descent_best_ref).

On the CPU: the wrapper module imports without nvcc, CPU tensors take the
plain version and launch nothing, the wrapper raises on what the kernel
does not take, the descent routes by what it can observe, and a numpy
model of the kernel's arithmetic (int8 words, funnel shifts, row bands,
int32 partials, int64 totals, the epilogue's roundings) equals the plain
version bit for bit. Tests marked `cuda` hold the kernel against the plain
version bit for bit on the card, and a full flagship and washers match on
the card against the CPU's, and skip without one. Imports nothing of JAX,
so that it runs on the card's machine:

    python3 -m pytest --noconftest tests/test_torch_descent_score_kernel.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fastest_image_pattern_matching_tpu_torch as tfipm
from fastest_image_pattern_matching_tpu_torch import aot
from fastest_image_pattern_matching_tpu_torch.models import (
    template_matcher as tm)
from fastest_image_pattern_matching_tpu_torch.ops import ncc
from fastest_image_pattern_matching_tpu_torch.ops.cuda import (
    build, descent_score_kernel as dsk)
from fastest_image_pattern_matching_tpu_torch.utils import profiling

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The flagship's descent levels 0-5 (a 521x762 template, top layer 6) and
# their chunk sizes at k_ang 3; the washers' level 0 (54x54, k_ang 1).
FLAGSHIP_LEVELS = ((521, 762), (261, 381), (131, 191), (66, 96), (33, 48),
                   (17, 24))
FLAGSHIP_CHUNKS = (8, 8, 8, 8, 32, 64)
WASHER = (54, 54)


def _template(h, w, seed):
    """A u8-valued template: bars and a disc over noise."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 60, (h, w)).astype(np.float32)
    t[h // 4:h // 4 + max(1, h // 6), :] += 150
    yy, xx = np.mgrid[:h, :w]
    t[(yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (min(h, w) / 4) ** 2] += 90
    return np.clip(t, 0, 255)


def _rois(templ, B, seed, offsets=None):
    """B ROIs [B, h + 6, w + 6], integers in [0, 255]: every other one the
    template pasted at an offset in [0, 6]^2 (offsets[i], or drawn) with
    noise, the rest noise alone."""
    rng = np.random.default_rng(seed)
    h, w = templ.shape
    out = rng.integers(0, 256, (B, h + 6, w + 6)).astype(np.float32)
    for i in range(0, B, 2):
        dy, dx = (offsets[i // 2 % len(offsets)] if offsets
                  else rng.integers(0, 7, 2))
        out[i, dy:dy + h, dx:dx + w] = np.clip(
            templ + rng.integers(-12, 13, templ.shape), 0, 255)
    return out


def _stats(templ):
    """(mean, norm, inv_area) as learn_pattern computes them."""
    t = templ.astype(np.float64)
    mean = float(t.mean())
    var = float(((t - mean) ** 2).mean())
    return mean, float(np.sqrt(var) * np.sqrt(t.size)), 1.0 / t.size


def _ref(rois, templ, stats, cc, k_ang):
    mean, norm, inv_area = stats
    return ncc.descent_best_ref(torch.as_tensor(rois),
                                torch.as_tensor(templ), mean, norm,
                                inv_area, False, cc, k_ang)


def _same(got, want):
    """Each output bit for bit (the values as their bits)."""
    gv, gxy, gb, gp = (x.cpu() for x in got)
    wv, wxy, wb, wp = (x.cpu() for x in want)
    assert gv.dtype == torch.float32 and gxy.dtype == torch.int32
    assert gb.dtype == torch.bool and gp.dtype == torch.float32
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))
    assert torch.equal(gxy, wxy) and torch.equal(gb, wb)
    assert torch.equal(gp.view(torch.int32), wp.view(torch.int32))


# ------------------------------------------------- a numpy model of the kernel

def _words(rows, n_words):
    """Rows [R, n] of u8-valued floats as uint32 words [R, n_words] of four
    int8 bytes v - 128, little-endian, zero beyond n (the source's
    pack4)."""
    R, n = rows.shape
    b = np.zeros((R, 4 * n_words), np.int8)
    b[:, :n] = (np.rint(rows).astype(np.int64) - 128).astype(np.int8)
    return b.view("<u4")


def _dp4a(a, b):
    """The four int8 products of each word pair, summed, as int64."""
    pa = a.astype("<u4").view(np.int8).reshape(*a.shape, 4).astype(np.int64)
    pb = b.astype("<u4").view(np.int8).reshape(*b.shape, 4).astype(np.int64)
    return (pa * pb).sum(-1)


def _shifted(row_words, nq):
    """[7, ..., nq] words whose byte j is row[dx + 4q + j] (the source's
    `shifted`: funnel shifts of staged words q, q + 1, q + 2)."""
    w64 = row_words.astype(np.uint64)
    a, b, c = w64[..., :nq], w64[..., 1:nq + 1], w64[..., 2:nq + 2]
    fs = lambda lo, hi, s: ((hi << np.uint64(32) | lo) >> np.uint64(s)) \
        & np.uint64(0xffffffff)
    return np.stack([a, fs(a, b, 8), fs(a, b, 16), fs(a, b, 24), b,
                     fs(b, c, 8), fs(b, c, 16)]).astype(np.uint32)


def _model(rois, templ, consts):
    """The kernel's arithmetic on one ROI at a time, band by band as the
    wrapper plans them; returns descent_best's outputs for B = cc * 1."""
    B, H, W = rois.shape
    h, w = templ.shape
    nq = -(-w // 4)
    rows = dsk.plan(h, w)
    assert dsk.smem_bytes(rows, w) <= dsk.SMEM_MAX
    tail = w - 4 * (nq - 1)
    mask = np.full(nq, 0xffffffff, np.uint32)
    mask[-1] = 0xffffffff if tail == 4 else (1 << (8 * tail)) - 1
    ones = np.full(nq, 0x01010101, np.uint32)
    tw = _words(templ, nq)
    out = []
    for b in range(B):
        rw = _words(rois[b], nq + 2)
        tot = np.zeros((3, 7, 7), np.int64)
        for i0 in range(0, h, rows):
            nr = min(rows, h - i0)
            band = rw[i0:i0 + nr + 6]
            sh = _shifted(band, nq)                       # [7dx, nr+6, nq]
            for dy in range(7):
                prod = _dp4a(sh[:, dy:dy + nr], tw[None, i0:i0 + nr])
                assert np.abs(prod).max(initial=0) <= 4 * 128 * 128
                tot[0, dy] += prod.sum((1, 2))
            m = sh & mask
            r1 = _dp4a(m, ones).sum(-1)                   # [7dx, nr+6]
            r2 = _dp4a(m, m).sum(-1)
            assert np.abs(r2).max() < 2 ** 31
            for dy in range(7):
                tot[1, dy] += r1[:, dy:dy + nr].sum(1)
                tot[2, dy] += r2[:, dy:dy + nr].sum(1)
        out.append(_epilogue(tot.astype(np.float32).reshape(3, 49),
                             consts))
    return out


def _epilogue(t, consts):
    """The source's ncc_score on 49 shifts, then the first maximum and the
    outputs, in numpy's IEEE f32 / f64 steps; the square root is the CPU's
    torch.sqrt, as in the plain version it is held against here. That one
    is not correctly rounded (on AVX-512 about 0.6% of f32 values come out
    an ulp off); the kernel's __fsqrt_rn is, as the card's torch.sqrt is,
    and the `cuda` tests hold it against the plain version on the card."""
    f, d = np.float32, np.float64
    mean_c, area_c, inv_area, norm, eps10, tiny = (f(c) for c in consts)
    corr, s1, s2 = t
    num = (s1.astype(d) * d(mean_c) + corr.astype(d)).astype(f)
    wnd = (s2 + f(256.0) * s1) + area_c
    diff2 = ((-(s1 * s1)).astype(d) * d(inv_area) + s2.astype(d)).astype(f)
    diff2 = np.where(diff2 < 0, f(0), diff2)
    cut = eps10 * wnd
    cut = np.where(cut > f(0.5), f(0.5), cut)
    root = torch.sqrt(torch.from_numpy(diff2)).numpy()
    tt = np.where(diff2 <= cut, f(0), root * norm)
    na = np.abs(num)
    safe = np.where(tt < tiny, tiny, tt)
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(na < tt, num / safe,
                     np.where(na < tt * f(1.125), np.sign(num), f(0)))
    s = s.astype(f)
    bi = int(np.argmax(s))
    py, px = divmod(bi, 7)
    sy, sx = min(max(py - 1, 0), 4), min(max(px - 1, 0), 4)
    return (s[bi], (px, py), px in (0, 6) or py in (0, 6),
            s.reshape(7, 7)[sy:sy + 3, sx:sx + 3])


def _hold_model(rois, templ, stats, k_ang=1):
    B = rois.shape[0]
    want = _ref(rois, templ, stats, B // k_ang, k_ang)
    consts = ncc.score_constants(*stats,
                                 float(templ.shape[0] * templ.shape[1]))
    got = _model(rois, templ, consts)
    wv, wxy, wb, wp = (x.reshape(B, *x.shape[2:]).numpy() for x in want)
    for b, (v, xy, border, patch) in enumerate(got):
        assert np.float32(v).view(np.int32) == wv[b].view(np.int32), b
        assert tuple(wxy[b]) == xy and bool(wb[b]) == border, b
        assert np.array_equal(patch.view(np.int32), wp[b].view(np.int32)), b
    return want


@pytest.mark.parametrize("hw,B,seed", [
    ((17, 24), 6, 1),      # the flagship's level 5, one band
    ((33, 48), 3, 2),      # level 4: three bands, w % 4 == 0
    ((21, 25), 4, 3),      # w % 4 == 1, two bands
    ((19, 30), 2, 4),      # w % 4 == 2
    ((16, 15), 2, 5),      # w % 4 == 3, one full band
    ((54, 54), 5, 6),      # the washers' level 0, four bands
    ((5, 4), 3, 7),
])
def test_kernel_model_equals_plain(hw, B, seed):
    """The kernel's integer scheme and epilogue, modelled in numpy, equal
    the plain version bit for bit on ROIs with and without the
    template."""
    templ = _template(*hw, seed)
    _hold_model(_rois(templ, B, seed), templ, _stats(templ))


@pytest.mark.parametrize("case", ["ties", "border", "band", "over_band",
                                  "flat_roi", "saturated"])
def test_kernel_model_special_maps(case):
    """Tied maxima (a ROI periodic in x: the first wins), maxima on the
    border, scores in the 1.125 band (the norm scaled so that num / t
    lies in [1, 1.125): +-1) and above it (0), flat ROIs under the
    rounding cutoff (0 everywhere), and ROIs and templates at 0 and 255."""
    h, w = 14, 18
    templ = _template(h, w, 11)
    stats = _stats(templ)
    rois = _rois(templ, 4, 12)
    if case == "ties":
        row = np.random.default_rng(13).integers(0, 256, (4, h + 6, 2))
        rois = np.tile(row, (1, 1, (w + 6) // 2)).astype(np.float32)
    elif case == "border":
        rois = _rois(templ, 8, 14, offsets=[(0, 0), (6, 6), (0, 3), (5, 6)])
    elif case in ("band", "over_band"):
        stats = (stats[0], stats[1] * (0.95 if case == "band" else 0.8),
                 stats[2])
    elif case == "flat_roi":
        rois = np.full((3, h + 6, w + 6), 77.0, np.float32)
    else:
        templ = np.where(templ > 100, 255.0, 0.0).astype(np.float32)
        stats = _stats(templ)
        rois = np.where(_rois(templ, 4, 15) > 128, 255.0, 0.0).astype(
            np.float32)
    v, xy, border, _ = _hold_model(rois, templ, stats)
    if case == "ties":
        smap = ncc.ncc_score_map(torch.as_tensor(rois), torch.as_tensor(
            templ), *stats, False).reshape(-1, 49)
        assert ((smap == smap.max(1, keepdim=True).values).sum(1) > 1).all()
        assert (xy[:, 0, 0] <= 1).all()
    elif case == "border":
        assert border[::2].all()
    elif case == "band":
        assert (v[::2] == 1.0).all()
    elif case == "flat_roi":
        assert (v == 0.0).all() and (xy == 0).all()


def _model_stack(rois, templs, index, table):
    """The stack kernel's arithmetic: ROI b staged against template
    index[b] with row index[b] of the constants table, each ROI as the
    single-template model computes it."""
    return [_model(rois[b:b + 1], templs[g], tuple(table[g]))[0]
            for b, g in enumerate(index)]


@pytest.mark.parametrize("hw,G,index", [
    ((26, 17), 3, [2, 0, 1, 1, 2, 0, 2]),   # ocr's level 1, w % 4 == 1
    ((52, 34), 4, [3, 3, 0, 2, 1]),         # ocr's level 0, two bands
])
def test_kernel_model_with_index_equals_per_template(hw, G, index):
    """The kernel's model with a template index equals the model of each
    template on its own ROIs, and both equal the plain stacked version
    (ops/ncc.py::descent_best_stack_ref) and the plain version of each
    template, bit for bit."""
    templs = np.stack([_template(*hw, 90 + g) for g in range(G)])
    stats = [_stats(t) for t in templs]
    area = float(hw[0] * hw[1])
    table = np.array([ncc.score_constants(*st, area) for st in stats],
                     np.float32)
    rois = np.concatenate([_rois(templs[g], 1, 100 + b)
                           for b, g in enumerate(index)])
    got = _model_stack(rois, templs, index, table)
    plain = ncc.descent_best_stack_ref(
        torch.as_tensor(rois), torch.as_tensor(templs),
        torch.tensor(index, dtype=torch.int32), torch.as_tensor(table),
        False, len(index), 1)
    for g in range(G):
        sel = [b for b, i in enumerate(index) if i == g]
        own = _model(rois[sel], templs[g], tuple(table[g]))
        want = _ref(rois[sel], templs[g], stats[g], len(sel), 1)
        for j, b in enumerate(sel):
            for x, y in zip(got[b], own[j]):
                assert np.array_equal(np.asarray(x), np.asarray(y)), b
            assert np.float32(got[b][0]).view(np.int32) == \
                want[0][j, 0].numpy().view(np.int32)
            for w_part, p_part in zip(want, plain):
                assert torch.equal(p_part[b], w_part[j]), b


# ----------------------------------------------------------------- CPU side

def test_descent_score_module_imports_without_nvcc():
    """Importing the wrapper and ops/ncc.py, in a fresh process with no
    nvcc reachable, builds and loads nothing."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME="/nonexistent", CUDA_PATH="/nonexistent")
    code = ("import fastest_image_pattern_matching_tpu_torch.ops.cuda."
            "descent_score_kernel as d; import fastest_image_pattern_"
            "matching_tpu_torch.ops.ncc; from fastest_image_pattern_"
            "matching_tpu_torch.utils.profiling import counter; assert "
            "d._LIB is None and counter('descent_score.launches') == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


@pytest.mark.parametrize("hw,cc,k_ang", [((17, 24), 4, 3), ((54, 54), 3, 1)])
def test_cpu_tensors_take_plain_version(hw, cc, k_ang):
    """descent_best on CPU tensors is the plain version, with its spans'
    path, and counts no launch."""
    templ = _template(*hw, 21)
    rois = _rois(templ, cc * k_ang, 22)
    stats = _stats(templ)
    before = profiling.counter("descent_score.launches")
    got = ncc.descent_best(torch.as_tensor(rois), torch.as_tensor(templ),
                           *stats, False, cc, k_ang, True)
    _same(got, _ref(rois, templ, stats, cc, k_ang))
    assert got[0].shape == (cc, k_ang) and got[3].shape == (cc, k_ang, 3, 3)
    assert profiling.counter("descent_score.launches") == before


T = torch.zeros((5, 6))
R = torch.zeros((3, 11, 12))


@pytest.mark.parametrize("rois,templ,cc,err,match", [
    (R, T, 3, ValueError, "CUDA device"),
    (R.double(), T, 3, TypeError, "float32"),
    (R, T.double(), 3, TypeError, "float32"),
    (torch.zeros((3, 12, 11)).transpose(1, 2), T, 3, ValueError,
     "contiguous"),
    (torch.zeros((3, 12, 12)), T, 3, ValueError, "grown by 6"),
    (R, T, 2, ValueError, "grown by 6"),
    (R[0], T, 1, ValueError, r"\[B, h \+ 6, w \+ 6\]"),
])
def test_descent_score_wrapper_rejects(rois, templ, cc, err, match):
    """The CUDA entry point raises instead of falling back to the plain
    version: CPU tensors, other dtypes, non-contiguous ROIs, ROIs that are
    not the template grown by 6 or not cc x k_ang of them."""
    consts = ncc.score_constants(100.0, 50.0, 1 / 30, 30.0)
    with pytest.raises(err, match=match):
        dsk.descent_score_cuda(rois, templ, consts, cc, 1)


TS = torch.zeros((4, 5, 6))
TABLE = torch.zeros((4, 6))
INDEX = torch.zeros(3, dtype=torch.int32)


@pytest.mark.parametrize("templ,index,table,match", [
    (TS, INDEX.long(), TABLE, "templ_index must be"),
    (TS, INDEX[:2], TABLE, "templ_index must be"),
    (TS, torch.zeros((3, 1), dtype=torch.int32), TABLE,
     "templ_index must be"),
    (TS, INDEX.to("meta"), TABLE, "templ_index must be"),
    (TS, INDEX, TABLE[:, :5], "consts must be"),
    (TS, INDEX, TABLE[:3], "consts must be"),
    (TS, INDEX, TABLE.double(), "consts must be"),
    (TS, INDEX, (0.0,) * 6, "consts must be"),
    (T, INDEX, TABLE, r"templ \[G, h, w\]"),
    (TS, INDEX, TABLE, "CUDA device"),
])
def test_descent_score_wrapper_rejects_stacks(templ, index, table, match):
    """A stacked launch's template index (int32, one a ROI, contiguous, on
    the ROIs' device) and constants table (float32 [G, 6] on that device)
    are checked without reading them back; a well-formed stack of CPU
    tensors still raises for the device."""
    with pytest.raises(ValueError, match=match):
        dsk.descent_score_cuda(R, templ, table, 3, 1, index)


def test_plan_rows_and_shared_memory():
    """A band is 16 template rows (the flagship's level 0: 33 bands, 29 KB
    a block), fewer only where a wide template's rows would not fit, and a
    template too wide for one row a block is refused."""
    assert dsk.plan(521, 762) == 16 and dsk.plan(5, 4) == 5
    assert dsk.smem_bytes(16, 762) == 4 * (22 * 193 + 16 * 191)
    rows = dsk.plan(400, 8000)
    assert 1 <= rows < 16 and dsk.smem_bytes(rows, 8000) <= dsk.SMEM_MAX
    assert dsk.smem_bytes(rows + 1, 8000) > dsk.SMEM_MAX
    with pytest.raises(ValueError, match="too wide"):
        dsk.plan(10, 40000)


def test_flagship_levels_and_chunks():
    """The shapes the card tests use are the flagship's: level sizes of a
    521x762 template and the descent's chunk of each."""
    templ = _template(521, 762, 31).astype(np.uint8)
    pat = tfipm.learn_pattern(templ, 256, device="cpu")
    assert tuple(lv.templ.shape for lv in pat.levels[:6]) == FLAGSHIP_LEVELS
    assert tuple(tm._descend_chunk((h + 6, w + 6), h * w, 3)
                 for h, w in FLAGSHIP_LEVELS) == FLAGSHIP_CHUNKS
    assert tm._descend_chunk((60, 60), 54 * 54, 1) == 32
    assert all(lv.u8_valued for lv in pat.levels)


def test_u8_valued_levels():
    """LevelData.u8_valued: integers in [0, 255] only."""
    lv = tm.LevelData(templ=np.array([[0.0, 255.0]], np.float32), mean=0.0,
                      norm=1.0, inv_area=0.5, result_equal1=False)
    assert lv.u8_valued
    for bad in (0.5, -1.0, 256.0):
        lv = tm.LevelData(templ=np.array([[bad, 3.0]], np.float32),
                          mean=0.0, norm=1.0, inv_area=0.5,
                          result_equal1=False)
        assert not lv.u8_valued


@pytest.mark.parametrize("cfg_kw,fractional,integer", [
    ({}, False, True),
    ({"quantize_warp": False}, False, False),
    ({"compute_dtype": "f32"}, False, False),
    ({}, True, True),
])
def test_descent_routes_by_what_it_observes(monkeypatch, cfg_kw,
                                            fractional, integer):
    """Every descent chunk asks for the kernel's route exactly where its
    sums are exact: quantized warps of clipped frames and a u8-valued
    template (a level-0 template with a fractional value is not; the
    pyramid's levels above it are). On the CPU the chunks take the plain
    version either way."""
    t = np.full((40, 56), 30.0, np.float32)
    t[8:30, 10:46] = 200.0
    if fractional:
        t[10, 12] = 100.5
    f = np.random.default_rng(40).integers(0, 30, (200, 240)).astype(
        np.uint8)
    f[60:100, 70:126] = np.clip(t, 0, 255).astype(np.uint8)
    cfg = tfipm.MatchConfig(max_pos=1, score=0.6, tolerance_angle=20.0,
                            max_overlap=0.3, **cfg_kw)
    pattern = tfipm.learn_pattern(t, cfg.min_reduce_area, device="cpu")
    seen = set()

    def spy(*args):
        seen.add((tuple(args[1].shape), args[-1]))
        return ncc.descent_best(*args)

    monkeypatch.setattr(tm, "descent_best", spy)
    res = tfipm.match(f, pattern, cfg, device="cpu")
    assert len(res) == 1 and res[0].score > 0.9
    levels = {hw for hw, _ in seen}
    assert len(levels) == pattern.top_layer and (40, 56) in levels
    assert seen == {(hw, integer and not (fractional and hw == (40, 56)))
                    for hw in levels}


def test_packs_carry_descent_score_library():
    """The deployment packs bundle, install and load the descent-score
    kernel's library with the others, so a pack never runs nvcc for it."""
    assert dsk.SOURCE in aot._CUDA_SOURCES
    assert os.path.isfile(os.path.join(build.CSRC_DIR, dsk.SOURCE))
    assert build.library_identity(dsk.SOURCE)["file"].startswith(
        "libdescent_score_")


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _hold(rois, templ, stats, cc, k_ang, dev):
    """The kernel (through descent_best) against the plain version on the
    card, bit for bit, one launch."""
    r = torch.as_tensor(rois, device=dev)
    t = torch.as_tensor(templ, device=dev)
    before = profiling.counter("descent_score.launches")
    got = ncc.descent_best(r, t, *stats, False, cc, k_ang, True)
    torch.cuda.synchronize()
    assert profiling.counter("descent_score.launches") == before + 1
    want = ncc.descent_best_ref(r, t, *stats, False, cc, k_ang)
    _same(got, want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("level", range(6))
@pytest.mark.parametrize("cc", [8, 32, 64, 5, 1])
def test_kernel_flagship_levels_on_card(cuda_device, level, cc):
    """The flagship's level 0-5 ROIs at k_ang 3, in chunks of 8, 32 and 64
    candidates, a short last chunk of 5 and a chunk of 1."""
    h, w = FLAGSHIP_LEVELS[level]
    templ = _template(h, w, 50 + level)
    _hold(_rois(templ, 3 * cc, 60 + level), templ, _stats(templ), cc, 3,
          cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("cc", [32, 9, 1])
def test_kernel_washers_on_card(cuda_device, cc):
    """The washers' 60x60 ROIs at k_ang 1: chunks of 32, the last of 9."""
    templ = _template(*WASHER, 70)
    _hold(_rois(templ, cc, 71), templ, _stats(templ), cc, 1, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties", "border", "band", "over_band",
                                  "flat_roi", "saturated"])
@pytest.mark.parametrize("hw", [(17, 24), (131, 191)])
def test_kernel_special_maps_on_card(cuda_device, case, hw):
    """test_kernel_model_special_maps' cases on the card, at the
    flagship's level 5 and level 2 sizes."""
    h, w = hw
    templ = _template(h, w, 80)
    stats = _stats(templ)
    rois = _rois(templ, 6, 81)
    if case == "ties":
        row = np.random.default_rng(82).integers(0, 256, (6, h + 6, 1))
        rois = np.tile(row, (1, 1, w + 6)).astype(np.float32)
    elif case == "border":
        rois = _rois(templ, 8, 83, offsets=[(0, 0), (6, 6), (0, 3), (5, 6)])
    elif case in ("band", "over_band"):
        stats = (stats[0], stats[1] * (0.95 if case == "band" else 0.8),
                 stats[2])
    elif case == "flat_roi":
        # 128 centres to 0: diff2 is 0 at any size (a flat 200 leaves
        # diff2 the rounding of s1^2, above the cutoff at 131x191).
        rois = np.full((6, h + 6, w + 6), 128.0, np.float32)
    else:
        templ = np.where(templ > 100, 255.0, 0.0).astype(np.float32)
        stats = _stats(templ)
        rois = np.where(_rois(templ, 6, 84) > 128, 255.0, 0.0).astype(
            np.float32)
    v, xy, border, _ = _hold(rois, templ, stats, rois.shape[0] // 2, 2,
                             cuda_device)
    if case == "band":
        assert (v.reshape(-1)[::2] == 1.0).all()
    elif case == "flat_roi":
        assert (v == 0.0).all()
    elif case == "ties":
        assert (xy[..., 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["flagship", "washers"])
def test_match_on_card_equals_cpu(cuda_device, monkeypatch, scene):
    """A full flagship match (3 parts at 180 deg tolerance) and a washers
    match (100 parts, tol 0) on the card, every descent chunk through the
    kernel (one launch a chunk), against the same match on the CPU: the
    same valid entries, scores within 1e-5 and poses within 1e-3."""
    chunks = []

    def spy(*args):
        chunks.append(args[-1])
        return ncc.descent_best(*args)

    monkeypatch.setattr(tm, "descent_best", spy)
    sys.path.insert(0, REPO)
    import chip_smoke
    if scene == "flagship":
        frame, templ, _ = chip_smoke.flagship_scene()
        cfg = chip_smoke.flagship_config(tfipm)
    else:
        frame, templ, _ = chip_smoke.many_target_scene(3648, 100)
        cfg = chip_smoke.many_target_config(tfipm, 100)
    pat = tfipm.learn_pattern(templ, cfg.min_reduce_area, device=cuda_device)
    launches = profiling.counter("descent_score.launches")
    slots = profiling.counter("descent.slots")
    got = tm.match_arrays(frame, pat, cfg, device=cuda_device)
    launched = profiling.counter("descent_score.launches") - launches
    assert launched == len(chunks) > 0 and all(chunks)
    cpat = tfipm.learn_pattern(templ, cfg.min_reduce_area, device="cpu")
    want = tm.match_arrays(frame, cpat, cfg, device="cpu")
    assert profiling.counter("descent.slots") > slots
    assert np.array_equal(got["valid"], want["valid"])
    v = want["valid"]
    assert v.sum() == (3 if scene == "flagship" else 100)
    assert np.abs(got["score"] - want["score"]).max() <= 1e-5
    assert np.abs(got["center"][v] - want["center"][v]).max() <= 1e-3
    assert np.abs(got["angle"][v] - want["angle"][v]).max() <= 1e-3


# ocr's levels 1 and 0 (52x34 glyphs, top layer 2) and their chunks at
# k_ang 1: 64 and 32 candidates.
OCR_LEVELS = (((26, 17), 64), ((52, 34), 32))


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1])
def test_stacked_launch_equals_a_launch_a_template_on_card(cuda_device,
                                                          level):
    """36 templates at ocr's level-1 and level-0 sizes, a chunk of ROIs
    each against a template drawn from the 36: one stacked launch equals
    one single-template launch per template on that template's ROIs, and
    the plain stacked version, bit for bit."""
    (h, w), cc = OCR_LEVELS[level]
    G = 36
    templs = np.stack([_template(h, w, 200 + g) for g in range(G)])
    index = np.random.default_rng(300 + level).integers(0, G, cc)
    rois = np.concatenate([_rois(templs[g], 1, 400 + b)
                           for b, g in enumerate(index)])
    area = float(h * w)
    consts = [ncc.score_constants(*_stats(t), area) for t in templs]
    dev = cuda_device
    r = torch.as_tensor(rois, device=dev)
    t = torch.as_tensor(templs, device=dev)
    table = torch.tensor(consts, dtype=torch.float32, device=dev)
    tidx = torch.as_tensor(index, dtype=torch.int32, device=dev)
    before = profiling.counter("descent_score.launches")
    got = ncc.descent_best_stack(r, t, tidx, table, False, cc, 1, True)
    torch.cuda.synchronize()
    assert profiling.counter("descent_score.launches") == before + 1
    _same(got, ncc.descent_best_stack_ref(r, t, tidx, table, False, cc, 1))
    for g in np.unique(index):
        sel = torch.as_tensor(np.nonzero(index == g)[0], device=dev)
        one = dsk.descent_score_cuda(r[sel].contiguous(), t[g].contiguous(),
                                     consts[g], sel.numel(), 1)
        _same(tuple(x[sel] for x in got), one)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flagship_L0", "washers"])
def test_null_index_launch_unchanged_on_card(cuda_device, case):
    """The launch without a template index (one template, its constants
    by value: every single-pattern match) at the flagship's level-0 chunk
    (8 candidates x 3 angles of 527x768) and Test7's chunk (32 of 60x60):
    one launch, bit-equal to the plain version."""
    if case == "flagship_L0":
        hw, cc, k_ang = FLAGSHIP_LEVELS[0], FLAGSHIP_CHUNKS[0], 3
    else:
        hw, cc, k_ang = WASHER, 32, 1
    templ = _template(*hw, 500)
    _hold(_rois(templ, cc * k_ang, 501), templ, _stats(templ), cc, k_ang,
          cuda_device)

