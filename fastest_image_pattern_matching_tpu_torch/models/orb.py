"""ORB feature matching — the port of
fastest_image_pattern_matching_tpu/models/orb.py, the reference's secondary
path (ORBMatch/ORBFeatureMatcher.{h,cpp}).

Reference pipeline (ORBFeatureMatcher.cpp:21-201): ORB detect+describe on
both images (500 features, 1.2 scale, 8 levels, Harris score, :14) ->
BFMatcher Hamming (:58-60) -> top-150 by distance (:76-82) -> RANSAC
homography (thresh 2.0, 2000 iters, conf 0.99, :104-109) -> inlier
extraction + average pixel shift (:141-185) -> corners via
perspectiveTransform(H^-1) (:329-371).

Every data-dependent loop is a fixed-size batch, as in the JAX package,
and the sources of a call are the leading axis of every stage: orb_match
is orb_match_many with one source. The images go up once, the packed
result comes back in one copy, and nothing in between reads a value on
the host.

Spans (utils/profiling.py): fipm.orb around each entry, over
fipm.orb.upload, fipm.orb.detect (once for the template, once for the
sources; inside it one fipm.orb.level per level with a budget, over
.resize, .fast, .harris, .select, .orient and .describe), fipm.orb.match,
fipm.orb.ransac (over .ransac.hyp and .ransac.lo), fipm.orb.readback and
fipm.orb.results. Counters take only what the host knows already:
orb.levels (levels detected, per image), orb.hypotheses (draws times
sources), and orb.frames, orb.good and orb.inliers from the packed result
once it is on the host.

Arithmetic. The JAX package runs every stage in f32 under XLA, which sums
and fuses in its own order. The port keeps f32 where JAX's value is exact
or where the stage is elementwise, and takes f64 where an f32 result would
depend on the summation order of the device or of the batch size:
  * the pyramid levels are JAX's antialiased triangle resize, its f32
    weights applied as a banded gather-and-sum in f64, rounded to f32 once;
  * Sobel gradients and the 7x7 Harris box sums are exact in f64 (integer
    sums at level 0), rounded to f32 before JAX's f32 det - k tr^2;
  * the orientation moments are exact in f64; atan2, cos and sin in f64,
    rounded to f32;
  * the rBRIEF blur is evaluated only at the sampled pixels, in f64 (exact
    at level 0), then rounded to an integer as JAX's f32 conv is;
  * the 4-point and refit solves run in f64 on the f32 systems JAX builds,
    and their homographies are scored in f32 as JAX scores them.
So the card and the CPU, and a source alone or in a batch, give the same
bits except where an f64 value straddles an f32 rounding boundary.
Tie-breaking follows jax.lax.top_k (lower index first on equal values):
stable sorts, and for the keypoint ranking a top-k on a composite
(value, -index) key.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from ..utils.profiling import count, span
from .template_matcher import upload_frames


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    max_features: int = 500        # cv::ORB::create nfeatures (:14)
    scale_factor: float = 1.2
    n_levels: int = 8
    fast_threshold: int = 20
    max_good_matches: int = 150    # top-N matches kept (:80)
    ransac_threshold: float = 2.0  # (:105)
    ransac_iters: int = 2000       # (:106)
    harris_k: float = 0.04
    patch_size: int = 31


@dataclasses.dataclass
class ORBResult:
    is_matched: bool
    homography: Optional[np.ndarray]      # maps source pts -> template pts
    num_inliers: int
    num_good_matches: int
    avg_pixel_shift: float
    corners: Optional[np.ndarray]         # template corners in source frame
    src_pts: Optional[np.ndarray] = None  # matched source points [M, 2]
    dst_pts: Optional[np.ndarray] = None  # matched template points [M, 2]
    inlier_mask: Optional[np.ndarray] = None
    # physics-pixel calibration (ORBFeatureMatcher.cpp:179-180)
    scale_mm_per_pix: float = 0.0
    # rotation angle (deg) extracted from the homography's affine part —
    # an extension; the reference leaves rotationAngle unset (:188)
    rotation_angle: float = 0.0


# FAST-9/16 Bresenham circle offsets (x, y), standard ordering.
_FAST_OFFSETS = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)


def _on(dev) -> str:
    """Cache key of a device."""
    return str(torch.device(dev))


@functools.lru_cache(maxsize=None)
def _fast_lut_np() -> np.ndarray:
    """[65536] bool: does a 16-bit circle mask hold 9 contiguous set bits,
    wrapping around (JAX's `runs` over the mask and its first 8 again)."""
    m = np.arange(1 << 16, dtype=np.uint32)
    x = m | (m << 16)
    y = x.copy()
    for s in range(1, 9):
        y &= x >> s
    return (y & 0xFFFF) != 0


@functools.lru_cache(maxsize=8)
def _fast_consts(dev: str):
    """The 9-run table and the bit weights of the 16 circle comparisons on
    a device."""
    return (torch.as_tensor(_fast_lut_np(), device=dev),
            torch.tensor([1 << k for k in range(16)], dtype=torch.int32,
                         device=dev).view(16, 1, 1, 1))


def _fast_corners(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 corner mask [..., H, W] (True where >= 9 contiguous circle
    pixels are all brighter than p+t or all darker than p-t). Each pixel's
    16 comparisons become a 16-bit code, looked up in a table of the
    circular 9-runs."""
    H, W = img.shape[-2:]
    x = img.reshape(-1, 1, H, W)
    pad = F.pad(x, (3, 3, 3, 3), mode="replicate")[:, 0]
    views = torch.stack([pad[:, 3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
                         for (dx, dy) in _FAST_OFFSETS.tolist()])
    img3 = img.reshape(-1, H, W)
    lut, weights = _fast_consts(_on(img.device))

    def code(mask):
        return (mask.to(torch.int32) * weights).sum(0).long()

    out = lut[code(views > img3 + threshold)] | lut[code(
        views < img3 - threshold)]
    # Exclude the border band where the circle leaves the image.
    out[:, :3] = False
    out[:, -3:] = False
    out[:, :, :3] = False
    out[:, :, -3:] = False
    return out.reshape(img.shape)


def _harris_response(img: torch.Tensor, k: float) -> torch.Tensor:
    """Harris corner response via Sobel gradients + 7x7 box window ("SAME",
    zero padding), [..., H, W] f32. Gradients and box sums in f64 (exact
    on integer images), det and trace in f32 as JAX computes them."""
    H, W = img.shape[-2:]
    x = img.reshape(-1, 1, H, W).double()
    p = F.pad(x, (1, 1, 1, 1))
    v = p[..., :-2, :] + 2.0 * p[..., 1:-1, :] + p[..., 2:, :]
    ix = v[..., 2:] - v[..., :-2]
    h = p[..., :-2] + 2.0 * p[..., 1:-1] + p[..., 2:]
    iy = h[..., 2:, :] - h[..., :-2, :]
    prods = torch.cat([ix * ix, iy * iy, ix * iy], dim=1)
    box = F.avg_pool2d(prods, 7, stride=1, padding=3,
                       count_include_pad=True, divisor_override=1).float()
    sxx, syy, sxy = box[:, 0], box[:, 1], box[:, 2]
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return (det - k * tr * tr).reshape(img.shape)


def _local_max_3x3(r: torch.Tensor) -> torch.Tensor:
    H, W = r.shape[-2:]
    mx = F.max_pool2d(r.reshape(-1, 1, H, W), 3, stride=1, padding=1)
    return r >= mx.reshape(r.shape)


def _top_k_first(x: torch.Tensor, k: int):
    """jax.lax.top_k along the last axis of f32 x without NaN: the k
    largest values in descending order, equal values by lower index first.
    torch.topk promises no order among ties, so it runs on a unique int64
    key: the value's order-preserving integer image, then -index.
    Returns (values, indices)."""
    L = x.shape[-1]
    bits = x.contiguous().view(torch.int32).long()
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    low = (0xFFFFFFFF - torch.arange(L, device=x.device)).expand_as(key)
    _, idx = torch.topk((key << 32) | low, k, dim=-1, sorted=True)
    return torch.gather(x, -1, idx), idx


def _sort_desc_first(x: torch.Tensor) -> torch.Tensor:
    """Indices that order the last axis by value, descending, equal values
    by lower index first (jax.lax.top_k's order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices


def _orientation(img: torch.Tensor, pts: torch.Tensor, radius: int = 15
                 ) -> torch.Tensor:
    """Intensity-centroid orientation (rad) for keypoints [..., N, 2]
    (x, y) of img [..., H, W]: one gather of every 31x31 patch around the
    truncated keypoint (edge padding), moments in f64 (exact sums), atan2
    in f64 rounded to f32."""
    d = 2 * radius + 1
    H, W = img.shape[-2:]
    lead = pts.shape[:-2]
    n = pts.shape[-2]
    dev = img.device
    padded = F.pad(img.reshape(-1, 1, H, W), (radius,) * 4,
                   mode="replicate").reshape(-1, (H + d - 1) * (W + d - 1))
    wp = W + d - 1
    x0 = pts[..., 0].to(torch.int32).long().reshape(-1, n)
    y0 = pts[..., 1].to(torch.int32).long().reshape(-1, n)
    off = torch.arange(d, device=dev)
    idx = ((y0[..., None, None] + off[:, None]) * wp
           + x0[..., None, None] + off)                     # [B, n, d, d]
    patch = torch.gather(padded, 1, idx.reshape(idx.shape[0], -1)
                         ).reshape(idx.shape).double()
    oy, ox = _orientation_grids(radius, _on(dev))
    m10 = (patch * ox).sum((-1, -2))
    m01 = (patch * oy).sum((-1, -2))
    return torch.atan2(m01, m10).float().reshape(*lead, n)


@functools.lru_cache(maxsize=8)
def _orientation_grids(radius: int, dev: str):
    oy, ox = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    circ = (ox * ox + oy * oy) <= radius * radius
    return (torch.as_tensor(oy * circ, dtype=torch.float64, device=dev),
            torch.as_tensor(ox * circ, dtype=torch.float64, device=dev))


@functools.lru_cache(maxsize=1)
def _brief_pattern() -> np.ndarray:
    """The 256-pair rBRIEF sampling pattern [256, 4] as (x1, y1, x2, y2).

    cv::ORB's learned pattern (models/orb_bit_pattern.npy, the same table
    as the JAX package's), so descriptors stay bit-compatible with the JAX
    package's and with cv::ORB's on shared keypoints (up to blur rounding
    ties). Falls back to a seeded Gaussian pattern (BRIEF-style, sigma =
    patch/5) if the table file is absent, as the JAX package does."""
    path = os.path.join(os.path.dirname(__file__), "orb_bit_pattern.npy")
    if os.path.exists(path):
        return np.load(path).astype(np.int32)
    rng = np.random.default_rng(0x5EED)
    sigma = 31 / 5.0
    pts = np.clip(np.round(rng.normal(0, sigma, size=(256, 4))), -13, 13)
    return pts.astype(np.int32)


@functools.lru_cache(maxsize=1)
def _gauss7_kernel() -> np.ndarray:
    """cv::ORB's descriptor pre-blur: 7x7 Gaussian, sigma 2 (the kernel
    cv::getGaussianKernel(7, 2) produces)."""
    d = np.arange(-3, 4, dtype=np.float64)
    g = np.exp(-(d * d) / 8.0)
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _descriptor_consts(dev: str):
    pat = torch.as_tensor(_brief_pattern(), dtype=torch.float32, device=dev)
    kern = torch.as_tensor(_gauss7_kernel(), dtype=torch.float64, device=dev)
    return pat, kern


def _descriptors(img: torch.Tensor, pts: torch.Tensor, angles: torch.Tensor
                 ) -> torch.Tensor:
    """Steered-BRIEF descriptors as ±1 f32 [..., N, 256]. Pixels are
    compared on the 7x7/sigma-2 Gaussian-blurred image ("SAME", zero
    padding) rounded to integers, cv::ORB's model. The blur is evaluated
    only at the sampled pixels, in f64."""
    H, W = img.shape[-2:]
    lead = pts.shape[:-2]
    n = pts.shape[-2]
    dev = img.device
    pat, kern = _descriptor_consts(_on(dev))
    a = angles.reshape(-1, n, 1).double()
    ca = torch.cos(a).float()
    sa = torch.sin(a).float()
    px = pts[..., 0].reshape(-1, n, 1)
    py = pts[..., 1].reshape(-1, n, 1)
    padded = F.pad(img.reshape(-1, 1, H, W), (3, 3, 3, 3)).reshape(
        -1, (H + 6) * (W + 6)).double()
    off = torch.arange(7, device=dev)

    def sample(xs, ys):
        # Rotate pattern offsets by keypoint orientation (steered BRIEF).
        rx = ca * xs - sa * ys
        ry = sa * xs + ca * ys
        xi = torch.clamp(torch.round(px + rx), 0, W - 1).long()
        yi = torch.clamp(torch.round(py + ry), 0, H - 1).long()
        idx = ((yi[..., None, None] + off[:, None]) * (W + 6)
               + xi[..., None, None] + off)              # [B, n, 256, 7, 7]
        nb = torch.gather(padded, 1, idx.reshape(idx.shape[0], -1))
        return torch.round((nb.reshape(idx.shape) * kern).sum((-1, -2)))

    bits = sample(pat[:, 0], pat[:, 1]) < sample(pat[:, 2], pat[:, 3])
    out = torch.where(bits, 1.0, -1.0).to(torch.float32)
    return out.reshape(*lead, n, 256)


def _detect_level(img: torch.Tensor, cfg: ORBConfig, k_feat: int):
    """Top-k_feat keypoints on one pyramid level of img [..., H, W].
    Returns (pts [..., k, 2] f32, resp [..., k], valid [..., k])."""
    with span("fipm.orb.fast"):
        fast = _fast_corners(img, float(cfg.fast_threshold))
    with span("fipm.orb.harris"):
        harris = _harris_response(img, cfg.harris_k)
    with span("fipm.orb.select"):
        # Rank FAST pixels by Harris (like ORB's HARRIS_SCORE) and 3x3-NMS
        # the *masked* response — the raw Harris peak usually sits a pixel
        # inside the shape, off the FAST ring.
        masked = torch.where(fast, harris, -torch.inf)
        cand = fast & _local_max_3x3(masked)
        score = torch.where(cand, harris, -torch.inf)
        H, W = img.shape[-2:]
        flat = score.reshape(*img.shape[:-2], H * W)
        vals, idx = _top_k_first(flat, min(k_feat, H * W))
        ys = (idx // W).to(torch.float32)
        xs = (idx % W).to(torch.float32)
        valid = torch.isfinite(vals)
        return torch.stack([xs, ys], -1), vals, valid


@functools.lru_cache(maxsize=64)
def _resize_band_np(m: int, n: int):
    """The nonzero band of jax.image.resize's "linear" (antialiased
    triangle) weight matrix from m samples to n along one axis, computed
    in f32 by JAX's formula (jax._src.image.scale.compute_weight_mat):
    for each output, K input indices (clamped; the extra ones weigh 0)
    and their weights. Returns (idx [n, K] int64, w [n, K] f32)."""
    f32 = np.float32
    inv = f32(1.0 / (n / m))
    ks = f32(max(1.0 / (n / m), 1.0))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    K = int(np.ceil(2 * float(ks))) + 2
    j = np.floor(sample - ks).astype(np.int64)[:, None] + np.arange(K)
    x = np.abs(sample[:, None] - j.astype(f32)) / ks
    w = np.maximum(f32(0), f32(1) - np.abs(x)).astype(f32)
    w[(j < 0) | (j >= m)] = 0
    total = w.sum(1, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    w = np.where(inside[:, None], w, f32(0)).astype(f32)
    return np.clip(j, 0, m - 1), w


@functools.lru_cache(maxsize=64)
def _resize_band(m: int, n: int, dev: str):
    idx, w = _resize_band_np(m, n)
    return (torch.as_tensor(idx, device=dev),
            torch.as_tensor(w, dtype=torch.float64, device=dev))


def _resize(img: torch.Tensor, hw) -> torch.Tensor:
    """jax.image.resize(img, hw, "linear") on [B, H, W]: the antialiased
    triangle filter, rows then columns, each as a banded gather and sum in
    f64; one rounding to f32 at the end. An axis of unchanged size is left
    as it is, as JAX does."""
    H, W = img.shape[-2:]
    h, w = hw
    x = img.double()
    dev = _on(img.device)
    if h != H:
        idx, wt = _resize_band(H, h, dev)
        x = (x[:, idx, :] * wt[:, :, None]).sum(2)
    if w != W:
        idx, wt = _resize_band(W, w, dev)
        x = (x[:, :, idx] * wt).sum(-1)
    return x.float()


def _level_budgets(cfg: ORBConfig):
    """Geometric per-level feature budget like OpenCV ORB."""
    n = cfg.n_levels
    factor = 1.0 / cfg.scale_factor
    ndesired = cfg.max_features * (1 - factor) / (1 - factor ** n)
    budgets = []
    remaining = cfg.max_features
    for i in range(n):
        b = min(int(round(ndesired * factor ** i)), remaining)
        if i == n - 1:
            b = remaining
        budgets.append(max(b, 0))
        remaining -= b
    return budgets


def _detect_and_describe(imgs: torch.Tensor, cfg: ORBConfig):
    """Multi-scale ORB features of a stack [B, H, W] f32 on its device.
    Returns (pts [B, N, 2] in level-0 coords, desc ±1 [B, N, 256],
    valid [B, N])."""
    with span("fipm.orb.detect"):
        H, W = imgs.shape[-2:]
        all_pts, all_desc, all_valid = [], [], []
        for lvl, budget in enumerate(_level_budgets(cfg)):
            if budget == 0:
                continue
            with span("fipm.orb.level"):
                count("orb.levels", imgs.shape[0])
                scale = cfg.scale_factor ** lvl
                cur = imgs
                if lvl > 0:
                    with span("fipm.orb.resize"):
                        cur = _resize(imgs, (max(8, int(round(H / scale))),
                                             max(8, int(round(W / scale)))))
                pts, _, valid = _detect_level(cur, cfg, budget)
                with span("fipm.orb.orient"):
                    ang = _orientation(cur, pts)
                with span("fipm.orb.describe"):
                    all_desc.append(_descriptors(cur, pts, ang))
                all_pts.append(pts * scale)
                all_valid.append(valid)
        n = cfg.max_features
        return (torch.cat(all_pts, 1)[:, :n], torch.cat(all_desc, 1)[:, :n],
                torch.cat(all_valid, 1)[:, :n])


def detect_and_describe(img, cfg: ORBConfig, device=None):
    """Multi-scale ORB features of one image (host array or tensor).

    Returns (pts [N,2] in level-0 coords, desc ±1 [N,256], valid [N]) as
    tensors on the device. Fixed N = cfg.max_features; invalid slots are
    masked."""
    dev = resolve_device(device)
    pts, desc, valid = _detect_and_describe(upload_frames(img, dev)[None],
                                            cfg)
    return pts[0], desc[0], valid[0]


def hamming_match(desc_s: torch.Tensor, valid_s, desc_t: torch.Tensor,
                  valid_t):
    """Brute-force Hamming on ±1 descriptors: dist = (256 - <s, t>) / 2,
    one matmul (exact in f32: the entries are ±1 and the sums integers).
    desc_s [..., Ns, 256], desc_t [Nt, 256]. Returns (train_idx [..., Ns],
    dist [..., Ns]) — the best template match per source feature, the
    first on ties, like BFMatcher::match (ORBFeatureMatcher.cpp:58-60)."""
    dot = torch.matmul(desc_s, desc_t.T)
    dist = (256.0 - dot) / 2.0
    dist = torch.where(valid_t, dist, torch.inf)
    dist = torch.where(valid_s[..., None], dist, torch.inf)
    ti = torch.argmin(dist, dim=-1)
    return ti, torch.gather(dist, -1, ti[..., None])[..., 0]


def _solve_h_4pt(src4: torch.Tensor, dst4: torch.Tensor) -> torch.Tensor:
    """Exact homographies from 4 correspondences [..., 4, 2]: JAX's f32
    8x8 system with h33 = 1 (its + 1e-8 I included), solved in f64 with no
    error check. Returns [..., 3, 3] f32; singular systems give inf/NaN
    entries, whose hypotheses score no inliers (NaN compares False), as
    in JAX."""
    x, y = src4[..., 0], src4[..., 1]
    u, v = dst4[..., 0], dst4[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    rows_u = torch.stack([x, y, o, z, z, z, -u * x, -u * y], dim=-1)
    rows_v = torch.stack([z, z, z, x, y, o, -v * x, -v * y], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)                 # [..., 8, 8]
    A = A + 1e-8 * torch.eye(8, dtype=torch.float32, device=A.device)
    b = torch.cat([u, v], dim=-1)                           # [..., 8]
    h = torch.linalg.solve_ex(A.double(), b.double()[..., None],
                              check_errors=False).result[..., 0].float()
    return torch.cat([h, torch.ones_like(h[..., :1])], -1).reshape(
        *h.shape[:-1], 3, 3)


def _project(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """pts [..., M, 2] through homographies H [..., 3, 3] (broadcast over
    the leading axes) -> [..., M, 2], in f32 as JAX computes it."""
    x, y = pts[..., 0], pts[..., 1]
    ph = [x * H[..., j, 0, None] + y * H[..., j, 1, None] + H[..., j, 2, None]
          for j in range(3)]
    w = torch.where(torch.abs(ph[2]) > 1e-12, ph[2], 1e-12)
    return torch.stack([ph[0] / w, ph[1] / w], -1)


def _sq_err(H: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """Squared reprojection error [..., M] of src through H against dst."""
    d = _project(H, src) - dst
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]


def _refit(mask: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """Normalized DLT on the masked inliers (all M rows, zero-weighted
    outliers), in f64: mask [..., M] bool, src/dst broadcastable to
    [..., M, 2]. Returns [..., 3, 3] f32 with H[2, 2] = 1."""
    w = mask.double()
    wsum = torch.clamp(w.sum(-1), min=1.0)

    def norm_pts(p):
        p = p.double()
        c = (p * w[..., None]).sum(-2) / wsum[..., None]
        d = torch.sqrt(((p - c[..., None, :]) ** 2).sum(-1)) * w
        s = math.sqrt(2.0) / torch.clamp(d.sum(-1) / wsum, min=1e-9)
        zero = torch.zeros_like(s)
        T = torch.stack([s, zero, -s * c[..., 0],
                         zero, s, -s * c[..., 1],
                         zero, zero, torch.ones_like(s)], -1).reshape(
                             *s.shape, 3, 3)
        return (p - c[..., None, :]) * s[..., None, None], T

    sn, Ts = norm_pts(src)
    dn, Td = norm_pts(dst)
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1) * w[..., None]
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], -1) * w[..., None]
    A = torch.cat([r1, r2], dim=-2)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    Hn = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 3)
    Hf = torch.linalg.solve_ex(Td, Hn @ Ts, check_errors=False).result
    h22 = Hf[..., 2, 2, None, None]
    return (Hf / torch.where(torch.abs(h22) > 1e-12, h22, 1e-12)).float()


@functools.lru_cache(maxsize=8)
def _ransac_samples(seed: int, iters: int, dev: str) -> torch.Tensor:
    """The default RANSAC draws: [iters, 4] int64 in [0, 2^30) from a CPU
    generator seeded with `seed`, so one seed gives the same hypotheses on
    every device. (The JAX package draws them with jax.random.PRNGKey,
    which torch cannot reproduce; tests inject JAX's table instead.)"""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2 ** 30, (iters, 4), generator=g).to(dev)


def _ransac(src, dst, valid, thresh: float, samples):
    """Batched-hypothesis RANSAC with LO refits over a leading batch axis:
    src/dst [B, M, 2] f32, valid [B, M] bool, samples [iters, 4] raw draws
    shared by the batch. Returns (H [B, 3, 3] f32, inlier mask [B, M])."""
    B, M = valid.shape
    count("orb.hypotheses", samples.shape[0] * B)

    def inliers(Hm, t):
        return (_sq_err(Hm, src[:, None], dst[:, None]) < t * t) \
            & valid[:, None]

    with span("fipm.orb.ransac.hyp"):
        n_valid = valid.sum(-1)
        nvalid = torch.clamp(n_valid, min=4)
        # jnp.nonzero(valid, size=M, fill_value=0): the valid indices in
        # order, then zeros.
        order = torch.sort((~valid).to(torch.int8), dim=-1,
                           stable=True).indices
        pos = torch.where(torch.arange(M, device=valid.device)
                          < n_valid[:, None], order, 0)
        r = samples[None] % nvalid[:, None, None]           # [B, I, 4]
        smp = torch.gather(pos, 1, r.reshape(B, -1)).reshape(r.shape)

        def at(p):
            return torch.gather(p, 1, smp.reshape(B, -1, 1).expand(-1, -1, 2)
                                ).reshape(*smp.shape, 2)

        Hs = _solve_h_4pt(at(src), at(dst))                 # [B, I, 3, 3]
        inls = inliers(Hs, thresh)                          # [B, I, M]
        counts = inls.sum(-1)

    with span("fipm.orb.ransac.lo"):
        # Iterated local optimization (LO-RANSAC style) from the top-8
        # hypotheses, refit sets on a wide-then-narrow threshold schedule
        # (2t -> 1.5t -> t), acceptance always at the narrow threshold;
        # then the best final (count, -error). As in the JAX package.
        n_lo = min(8, samples.shape[0])
        top = _sort_desc_first(counts)[:, :n_lo]
        Hb = torch.gather(Hs, 1, top[..., None, None].expand(-1, -1, 3, 3))
        mb = torch.gather(inls, 1, top[..., None].expand(-1, -1, M))
        cur = mb
        for mult in (2.0, 1.5, 1.0):
            Hf = _refit(cur, src[:, None], dst[:, None])
            mf = inliers(Hf, thresh)
            better = mf.sum(-1) >= mb.sum(-1)
            Hb = torch.where(better[..., None, None], Hf, Hb)
            mb = torch.where(better[..., None], mf, mb)
            cur = inliers(Hf, thresh * mult)
        e = _sq_err(Hb, src[:, None], dst[:, None])
        err = torch.where(mb, e.double(), 0.0).sum(-1).float()
        c_lo = mb.sum(-1)
        # Rank: most inliers, then least inlier reprojection error (f32, as
        # in JAX: the count term quantizes the error term).
        pick = torch.argmax(c_lo.to(torch.float32) * 1e6 - err, dim=-1)
        b = torch.arange(B, device=valid.device)
        return Hb[b, pick], mb[b, pick]


def ransac_homography(src, dst, valid, thresh: float, iters: int,
                      seed: int = 0, samples: Optional[torch.Tensor] = None):
    """Batched-hypothesis RANSAC: all 4-point subsets drawn up front, all
    homographies solved in one batch, all scored in one pass, then LO
    refits (normalized DLT via eigh) from the top 8. src/dst [M, 2],
    valid [M] (tensors on one device). `samples` are the raw [iters, 4]
    draws in [0, 2^30) before `% nvalid`; by default _ransac_samples(seed).
    Returns (H [3,3], inlier_mask [M])."""
    dev = src.device
    if samples is None:
        samples = _ransac_samples(seed, iters, _on(dev))
    H, mask = _ransac(src[None].float(), dst[None].float(),
                      valid[None].bool(), thresh,
                      torch.as_tensor(samples, device=dev).long())
    return H[0], mask[0]


def _good_matches(src_feats, templ_feats, max_good: int):
    """Hamming match of the sources' features [B, Ns, ...] against the
    template's, then the N = min(max_good, Ns) best by distance (ties by
    lower index). Returns (source points [B, N, 2], template points
    [B, N, 2], valid [B, N], finite distances per source [B])."""
    ps, ds, vs = src_feats
    pt, dt, vt = templ_feats
    ti, dist = hamming_match(ds, vs, dt, vt)
    finite = torch.isfinite(dist)
    N = min(max_good, dist.shape[-1])
    neg = torch.where(finite, -dist, -torch.inf)
    order = _sort_desc_first(neg)[:, :N]
    s_pts = torch.gather(ps, 1, order[..., None].expand(-1, -1, 2))
    t_pts = pt[torch.gather(ti, 1, order)]
    return s_pts, t_pts, torch.gather(finite, 1, order), finite.sum(-1)


def _match_against(cfg: ORBConfig, samples, sources, templ_feats):
    """Sources [B, H, W] f32 against the template's features: detect,
    Hamming match, top-N by distance, RANSAC. Returns the packed f32
    result [B, 10 + 6N] (the JAX package's layout, _result_from_packed)."""
    feats = _detect_and_describe(sources, cfg)
    with span("fipm.orb.match"):
        s_pts, t_pts, good_valid, n_finite = _good_matches(
            feats, templ_feats, cfg.max_good_matches)
    with span("fipm.orb.ransac"):
        H, mask = _ransac(s_pts, t_pts, good_valid, cfg.ransac_threshold,
                          samples)
    B = sources.shape[0]
    N = s_pts.shape[1]
    return torch.cat([
        H.reshape(B, 9), n_finite.to(torch.float32)[:, None],
        mask.to(torch.float32), good_valid.to(torch.float32),
        s_pts.reshape(B, 2 * N), t_pts.reshape(B, 2 * N)], dim=1)


def _orb_packed(sources, template, cfg: ORBConfig, seed: int, dev):
    """The device pipeline for host (or device) sources [B, H, W] and one
    template: the template's features once, then every source. One upload
    each, one packed host copy back. Returns [B, 10 + 6N] numpy f32."""
    with span("fipm.orb.upload"):
        templ = upload_frames(template, dev)[None]
        srcs = upload_frames(sources, dev)
    pt, dt, vt = _detect_and_describe(templ, cfg)
    samples = _ransac_samples(seed, cfg.ransac_iters, _on(dev))
    packed = _match_against(cfg, samples, srcs, (pt[0], dt[0], vt[0]))
    with span("fipm.orb.readback"):
        return packed.cpu().numpy()


def _gray(img, ndim_color: int):
    img = np.asarray(img) if not torch.is_tensor(img) else img
    if img.ndim == ndim_color:
        from ..utils.imageio import ensure_gray
        img = ensure_gray(img)
    return img


def orb_match(source, template, cfg: Optional[ORBConfig] = None,
              seed: int = 0, physics_shift_mm: float = 8.0,
              device=None) -> ORBResult:
    """Full ORB matching pipeline (performORBMatching parity,
    ORBFeatureMatcher.cpp:21-201) on `device` (CUDA unless "cpu" is
    asked for) + host-side result assembly."""
    with span("fipm.orb"):
        cfg = cfg or ORBConfig()
        dev = resolve_device(device)
        source = _gray(source, 3)
        template = _gray(template, 3)
        packed = _orb_packed(source[None], template, cfg, seed, dev)
        with span("fipm.orb.results"):
            return _result_from_packed(packed[0], tuple(template.shape),
                                       physics_shift_mm)


def _result_from_packed(packed: np.ndarray, templ_hw,
                        physics_shift_mm: float) -> ORBResult:
    """Host-side result assembly from the packed device vector
    (ORBFeatureMatcher.cpp:141-185 inlier stats + :329-371 corners),
    counted as orb.frames, orb.good and orb.inliers."""
    res = _assemble(packed, templ_hw, physics_shift_mm)
    count("orb.frames")
    count("orb.good", res.num_good_matches)
    count("orb.inliers", res.num_inliers)
    return res


def _assemble(packed: np.ndarray, templ_hw,
              physics_shift_mm: float) -> ORBResult:
    N = (packed.shape[0] - 10) // 6
    Hnp = packed[:9].astype(np.float64).reshape(3, 3)
    n_finite = int(packed[9])
    mask_np = packed[10:10 + N] > 0.5
    good_valid = packed[10 + N:10 + 2 * N] > 0.5
    s_np = packed[10 + 2 * N:10 + 4 * N].reshape(N, 2)
    t_np = packed[10 + 4 * N:10 + 6 * N].reshape(N, 2)
    if n_finite < 10:  # :66
        return ORBResult(False, None, 0, 0, 0.0, None)
    n_inl = int(mask_np.sum())
    if n_inl < 2:  # :156
        return ORBResult(False, None, n_inl, N, 0.0, None)

    shifts = np.linalg.norm(t_np[mask_np] - s_np[mask_np], axis=1)
    avg_shift = float(shifts.mean())
    scale_mm = (physics_shift_mm / avg_shift) if avg_shift > 1e-6 else 0.0
    rot_deg = float(np.degrees(np.arctan2(Hnp[1, 0], Hnp[0, 0])))

    # Template corners in the source frame: perspectiveTransform with
    # H^-1 (:340-353).
    h, w = templ_hw
    tc = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    Hinv = np.linalg.inv(Hnp)
    ph = np.concatenate([tc, np.ones((4, 1))], axis=1) @ Hinv.T
    corners = ph[:, :2] / ph[:, 2:3]

    return ORBResult(
        is_matched=True, homography=Hnp,
        num_inliers=n_inl, num_good_matches=int(np.asarray(good_valid).sum()),
        avg_pixel_shift=avg_shift, corners=corners,
        src_pts=s_np, dst_pts=t_np, inlier_mask=mask_np,
        scale_mm_per_pix=scale_mm, rotation_angle=rot_deg)


def orb_match_many(sources, template, cfg: Optional[ORBConfig] = None,
                   seed: int = 0, physics_shift_mm: float = 8.0,
                   device=None):
    """Match one template against a batch of same-shape sources [B, H, W]
    in one pass of the pipeline (template features computed once; every
    stage takes the batch as its leading axis) — the serving analogue of
    repeated interactive ORB runs (ORBFeatureMatcher.cpp:21). Each
    result equals that source's own orb_match on the same device. Returns
    a list of ORBResult."""
    with span("fipm.orb"):
        cfg = cfg or ORBConfig()
        dev = resolve_device(device)
        sources = _gray(sources, 4)
        template = _gray(template, 3)
        if sources.ndim != 3:
            raise ValueError(f"sources must be [B, H, W], got "
                             f"{tuple(sources.shape)}")
        packed = _orb_packed(sources, template, cfg, seed, dev)
        with span("fipm.orb.results"):
            return [_result_from_packed(packed[b], tuple(template.shape),
                                        physics_shift_mm)
                    for b in range(packed.shape[0])]
