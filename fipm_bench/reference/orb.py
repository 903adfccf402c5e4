"""The plain ORB reference: one frame, one template, in PyTorch.

The ORB registration of the reference tool's second matcher
(ORBMatch/ORBFeatureMatcher.cpp: ORB features on both images, a
brute-force Hamming match, the best N matches, a RANSAC homography, the
template's corners through its inverse), with the semantics the port
states for each stage, written out plainly, image by image:

  * levels: jax.image.resize's antialiased triangle filter from level 0 to
    each level's size, as two dense weight matrices (rows, then columns)
    applied in f64 and rounded to f32 once. The weights are JAX's formula
    in f32, each output's taps summed in f32 over the same band of
    ceil(2 * kernel scale) + 2 taps (another order moves some weights by
    an ulp, and with them whole rows of a level);
  * FAST-9: the 16 circle pixels against p + t and p - t, and a direct
    test of 9 contiguous ones at each of the 16 starting positions, no
    lookup table; nothing within 3 px of the border;
  * Harris: Sobel gradients and the 7x7 zero-padded box sums as f64
    conv2d, rounded to f32 before det - k tr^2 in f32;
  * selection: the 3x3 maximum of the FAST-masked response, then the
    level's budget (OpenCV's geometric split) of the largest responses,
    equal ones by lower pixel index (a stable sort);
  * orientation: the intensity centroid over the disc of radius 15
    around the keypoint (edge-replicated), moments in f64, atan2 rounded
    to f32;
  * descriptors: rBRIEF on the 7x7 sigma-2 Gaussian blur (zero padding,
    f64, rounded to integers), cv::ORB's 256 pairs (orb_bit_pattern.npy)
    turned by the keypoint's angle and rounded to pixels;
  * matching: each source feature's nearest template feature by Hamming
    distance (XOR and popcount; the first on ties), then the N nearest
    pairs, equal distances by lower source index;
  * RANSAC: [iters, 4] int64 draws in [0, 2^30) from a CPU
    torch.Generator seeded with `seed`, each taken modulo the number of
    valid pairs (4 at least) as an index into the valid pairs in order;
    a homography from each draw's 4 pairs (the f32 8x8 system with
    h33 = 1 and 1e-8 on its diagonal, solved in f64, rounded to f32);
    inliers where the f32 squared reprojection error is below t^2; from
    the 8 hypotheses with most inliers (lower index first), three
    normalized-DLT refits on the inliers at t, then at 2t, then at 1.5t,
    each kept when it holds at least as many inliers at t; the pick by
    most inliers, then least summed error (count * 1e6 - error in f32);
  * result: no match below 10 matched features or 2 inliers; the
    template's corners (0, 0), (w, 0), (w, h), (0, h) through H^-1.

Where the fork's C++ (OpenCV) differs, and this reference with the port
does not follow it: cv::resize (area and bilinear) against the
antialiased triangle resize; no 31 px edge threshold, so keypoints lie
as near as 3 px to the border (patches are edge-replicated);
findHomography's adaptive iteration count and Levenberg-Marquardt
refinement against the fixed draws and LO refits above.

It imports nothing of the port and nothing of JAX. TF32 stays off in
matmuls and convolutions. `answer` is the entry the harness calls, by the
name `orb` that a configuration gives as its `reference`;
`pyramid_dtype` (a configuration's control) names the dtype the levels
are resized in.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

BIT_PATTERN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "orb_bit_pattern.npy")
# The FAST circle of radius 3, (dx, dy) in order around the ring.
CIRCLE = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
          (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
          (-1, -3))
ORB_FIELDS = ("max_features", "scale_factor", "n_levels", "fast_threshold",
              "max_good_matches", "ransac_threshold", "ransac_iters",
              "harris_k", "patch_size", "seed")


def answer(frame_u8: np.ndarray, templ_u8: np.ndarray, config: dict,
           device, work=None, pyramid_dtype="float64") -> dict:
    """The reference's answer for one frame of an ORB configuration (its
    `orb` fields), as setups/orb.py::rows gives the port's. `work` is
    taken for the harness and left empty: no kernel of the port is
    measured against this reference."""
    cfg = dict(config["orb"])
    unknown = sorted(set(cfg) - set(ORB_FIELDS))
    if unknown:
        raise ValueError(f"ORB fields this reference does not follow: "
                         f"{unknown}")
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return register(frame_u8, templ_u8, cfg, torch.device(device),
                        getattr(torch, pyramid_dtype))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def register(frame_u8, templ_u8, cfg: dict, dev, pyramid_dtype) -> dict:
    """{"matched", "inliers", "good", "pairs" [G, 4] (source x, y,
    template x, y of the valid best pairs, in order), "corners" [4, 2] or
    None}."""
    def image(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(
            torch.float32)
    ps, ds, vs = features(image(frame_u8), cfg, pyramid_dtype)
    pt, dt, vt = features(image(templ_u8), cfg, pyramid_dtype)
    src, dst, valid, n_finite = best_pairs(ps, ds, vs, pt, dt, vt,
                                           cfg["max_good_matches"])
    H, inl = ransac(src, dst, valid, cfg["ransac_threshold"],
                    draws(cfg["seed"], cfg["ransac_iters"]).to(dev))
    n_inl = int(inl.sum())
    if n_finite < 10 or n_inl < 2:
        return {"matched": False, "inliers": n_inl if n_finite >= 10 else 0,
                "good": 0, "pairs": np.zeros((0, 4)), "corners": None}
    good = int(valid.sum())
    pairs = torch.cat([src, dst], 1)[valid].cpu().double().numpy()
    h, w = templ_u8.shape
    tc = np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], np.float64)
    ph = tc @ np.linalg.inv(H.cpu().double().numpy()).T
    return {"matched": True, "inliers": n_inl, "good": good, "pairs": pairs,
            "corners": ph[:, :2] / ph[:, 2:]}


# ---- the pyramid ----------------------------------------------------------

def level_budgets(n_features: int, scale_factor: float, n_levels: int):
    """OpenCV's split of the features over the levels: a geometric series
    of ratio 1 / scale_factor, rounded, the last level taking the rest."""
    f = 1.0 / scale_factor
    first = n_features * (1 - f) / (1 - f ** n_levels)
    out, left = [], n_features
    for i in range(n_levels):
        b = left if i == n_levels - 1 else min(int(round(first * f ** i)),
                                               left)
        out.append(max(b, 0))
        left -= b
    return out


def resize_weights(m: int, n: int) -> np.ndarray:
    """[n, m] f32: jax.image.resize's "linear" weights from m samples to
    n (the triangle kernel widened by m / n when shrinking, each row
    normalised by its sum, rows of samples outside the input zeroed)."""
    f32 = np.float32
    inv = f32(m / n)
    ks = max(inv, f32(1))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    K = math.ceil(2 * float(ks)) + 2
    taps = np.floor(sample - ks).astype(np.int64)[:, None] + np.arange(K)
    w = np.maximum(f32(0), f32(1) - np.abs(sample[:, None]
                                           - taps.astype(f32)) / ks)
    w = w.astype(f32)
    w[(taps < 0) | (taps >= m)] = 0
    total = w.sum(1, dtype=f32)[:, None]
    w = np.where(np.abs(total) > 1000 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0)).astype(f32)
    w[~((sample >= -0.5) & (sample <= m - 0.5))] = 0
    dense = np.zeros((n, m), f32)
    np.add.at(dense, (np.repeat(np.arange(n), K),
                      np.clip(taps, 0, m - 1).ravel()), w.ravel())
    return dense


def resize(img: torch.Tensor, h: int, w: int, dtype) -> torch.Tensor:
    """img [H, W] f32 resized to [h, w]: rows, then columns, in `dtype`
    (f64: one rounding to f32 at the end); an axis of unchanged size
    stays as it is."""
    H, W = img.shape
    x = img.to(dtype)
    if h != H:
        x = torch.as_tensor(resize_weights(H, h), device=img.device).to(
            dtype) @ x
    if w != W:
        x = x @ torch.as_tensor(resize_weights(W, w),
                                device=img.device).to(dtype).T
    return x.to(torch.float32)


def features(img: torch.Tensor, cfg: dict, pyramid_dtype):
    """ORB features of one image: (points [N, 2] in level-0 pixels,
    descriptor bits [N, 256] bool, valid [N]), N = max_features, level
    by level."""
    H, W = img.shape
    pts, bits, valid = [], [], []
    budgets = level_budgets(cfg["max_features"], cfg["scale_factor"],
                            cfg["n_levels"])
    for lvl, budget in enumerate(budgets):
        if budget == 0:
            continue
        scale = cfg["scale_factor"] ** lvl
        cur = img if lvl == 0 else resize(
            img, max(8, int(round(H / scale))), max(8, int(round(W / scale))),
            pyramid_dtype)
        p, ok = keypoints(cur, cfg, budget)
        ang = orientation(cur, p, cfg["patch_size"] // 2)
        bits.append(brief(cur, p, ang))
        pts.append(p * scale)
        valid.append(ok)
    n = cfg["max_features"]
    return (torch.cat(pts)[:n], torch.cat(bits)[:n], torch.cat(valid)[:n])


# ---- one level -------------------------------------------------------------

def fast9(img: torch.Tensor, t: float) -> torch.Tensor:
    """[H, W] bool: 9 contiguous circle pixels all above p + t or all
    below p - t; False within 3 px of the border."""
    H, W = img.shape
    pad = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    ring = torch.stack([pad[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
                        for dx, dy in CIRCLE])

    def nine(m):
        ext = torch.cat([m, m[:8]])
        out = torch.zeros_like(m[0])
        for s in range(16):
            out |= ext[s:s + 9].all(0)
        return out
    out = nine(ring > img + t) | nine(ring < img - t)
    out[:3] = False
    out[-3:] = False
    out[:, :3] = False
    out[:, -3:] = False
    return out


def harris(img: torch.Tensor, k: float) -> torch.Tensor:
    """[H, W] f32 Harris response with a 7x7 window."""
    sx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                      dtype=torch.float64, device=img.device)
    grads = F.conv2d(img.double()[None, None],
                     torch.stack([sx, sx.T])[:, None], padding=1)[0]
    ix, iy = grads[0], grads[1]
    prods = torch.stack([ix * ix, iy * iy, ix * iy])[:, None]
    box = F.conv2d(prods, torch.ones(1, 1, 7, 7, dtype=torch.float64,
                                     device=img.device), padding=3)
    sxx, syy, sxy = box[:, 0].float()
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def keypoints(img: torch.Tensor, cfg: dict, budget: int):
    """The level's `budget` keypoints: (points [k, 2] f32 as (x, y),
    valid [k]); slots beyond the level's candidates are not valid."""
    H, W = img.shape
    corner = fast9(img, float(cfg["fast_threshold"]))
    resp = harris(img, cfg["harris_k"])
    masked = torch.where(corner, resp, -torch.inf)
    peak = F.max_pool2d(masked[None, None], 3, stride=1, padding=1)[0, 0]
    score = torch.where(corner & (masked >= peak), resp, -torch.inf)
    flat = score.flatten()
    order = torch.sort(flat, descending=True, stable=True).indices
    idx = order[:min(budget, H * W)]
    pts = torch.stack([(idx % W).float(), (idx // W).float()], 1)
    return pts, torch.isfinite(flat[idx])


def orientation(img: torch.Tensor, pts: torch.Tensor, r: int):
    """Each keypoint's angle (rad, f32): atan2 of the intensity centroid
    over the disc of radius r."""
    pad = F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    off = torch.arange(-r, r + 1, device=img.device)
    dy, dx = torch.meshgrid(off, off, indexing="ij")
    disc = (dx * dx + dy * dy <= r * r).double()
    x = pts[:, 0].long()
    y = pts[:, 1].long()
    patch = pad[(y + r)[:, None, None] + dy, (x + r)[:, None, None] + dx]
    patch = patch.double() * disc
    m10 = (patch * dx).sum((1, 2))
    m01 = (patch * dy).sum((1, 2))
    return torch.atan2(m01, m10).float()


def gauss7(sigma: float = 2.0) -> np.ndarray:
    """cv::ORB's descriptor blur, 7x7, as f32."""
    d = np.arange(-3, 4, dtype=np.float64)
    g = np.exp(-(d * d) / (2 * sigma * sigma))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def brief(img: torch.Tensor, pts: torch.Tensor, ang: torch.Tensor):
    """[k, 256] bool: the steered-BRIEF tests of each keypoint, pair i
    set where blur(first point) < blur(second point)."""
    H, W = img.shape
    kern = torch.as_tensor(gauss7(), device=img.device).double()
    blur = torch.round(F.conv2d(img.double()[None, None], kern[None, None],
                                padding=3)[0, 0])
    pat = torch.as_tensor(np.load(BIT_PATTERN), dtype=torch.float32,
                          device=img.device)
    c = torch.cos(ang.double()).float()[:, None]
    s = torch.sin(ang.double()).float()[:, None]

    def at(px, py):
        rx = c * px - s * py
        ry = s * px + c * py
        xi = torch.clamp(torch.round(pts[:, :1] + rx), 0, W - 1).long()
        yi = torch.clamp(torch.round(pts[:, 1:] + ry), 0, H - 1).long()
        return blur[yi, xi]
    return at(pat[:, 0], pat[:, 1]) < at(pat[:, 2], pat[:, 3])


# ---- matching and the homography -------------------------------------------

def best_pairs(ps, ds, vs, pt, dt, vt, n_best: int):
    """Each valid source feature's nearest valid template feature, then
    the n_best nearest pairs. Returns (source points [N, 2], template
    points [N, 2], valid [N], matched source features)."""
    dist = (ds[:, None, :] ^ dt[None, :, :]).sum(-1).float()
    dist = torch.where(vs[:, None] & vt[None, :], dist, torch.inf)
    nearest = torch.argmin(dist, 1)
    d = dist.gather(1, nearest[:, None])[:, 0]
    order = torch.sort(d, stable=True).indices[:min(n_best, len(d))]
    finite = torch.isfinite(d)
    return ps[order], pt[nearest[order]], finite[order], int(finite.sum())


def draws(seed: int, iters: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2 ** 30, (iters, 4), generator=g)


def four_point(src4, dst4) -> torch.Tensor:
    """[I, 3, 3] f32 homographies from [I, 4, 2] pairs."""
    x, y = src4[..., 0], src4[..., 1]
    u, v = dst4[..., 0], dst4[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    A = torch.cat([torch.stack([x, y, o, z, z, z, -u * x, -u * y], -1),
                   torch.stack([z, z, z, x, y, o, -v * x, -v * y], -1)], -2)
    A = A + 1e-8 * torch.eye(8, dtype=torch.float32, device=A.device)
    b = torch.cat([u, v], -1)
    h = torch.linalg.solve_ex(A.double(), b.double()[..., None],
                              check_errors=False).result[..., 0].float()
    return torch.cat([h, torch.ones_like(h[:, :1])], 1).reshape(-1, 3, 3)


def sq_err(H, src, dst):
    """[I, M] f32 squared distance of src through each H from dst."""
    x, y = src[:, 0], src[:, 1]
    ph = [x * H[:, j, 0, None] + y * H[:, j, 1, None] + H[:, j, 2, None]
          for j in range(3)]
    w = torch.where(torch.abs(ph[2]) > 1e-12, ph[2], 1e-12)
    dx = ph[0] / w - dst[:, 0]
    dy = ph[1] / w - dst[:, 1]
    return dx * dx + dy * dy


def dlt(src, dst, keep) -> torch.Tensor:
    """[3, 3] f32 normalized-DLT homography of the pairs where keep, in
    f64, H[2, 2] = 1."""
    s, d = src[keep].double(), dst[keep].double()

    def normalise(p):
        c = p.mean(0)
        k = math.sqrt(2.0) / max(float(torch.sqrt(((p - c) ** 2).sum(1))
                                       .mean()), 1e-9)
        cx, cy = c.tolist()
        T = torch.tensor([[k, 0, -k * cx], [0, k, -k * cy], [0, 0, 1]],
                         dtype=torch.float64, device=p.device)
        return (p - c) * k, T
    sn, Ts = normalise(s)
    dn, Td = normalise(d)
    x, y, u, v = sn[:, 0], sn[:, 1], dn[:, 0], dn[:, 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    A = torch.cat([torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], 1),
                   torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], 1)])
    _, vecs = torch.linalg.eigh(A.T @ A)
    Hn = vecs[:, 0].reshape(3, 3)
    Hf = torch.linalg.solve(Td, Hn @ Ts)
    h22 = Hf[2, 2]
    return (Hf / (h22 if abs(float(h22)) > 1e-12 else 1e-12)).float()


def ransac(src, dst, valid, t: float, raw):
    """The homography [3, 3] f32 and its inlier mask [M]."""
    M = len(valid)
    idx = torch.nonzero(valid)[:, 0]
    pos = torch.zeros(M, dtype=torch.long, device=valid.device)
    pos[:len(idx)] = idx
    pick = pos[raw % max(len(idx), 4)]                      # [I, 4]
    Hs = four_point(src[pick], dst[pick])

    def inliers(H, thr):
        return (sq_err(H, src, dst) < thr * thr) & valid

    masks = inliers(Hs, t)
    top = torch.sort(masks.sum(1), descending=True, stable=True).indices[:8]
    best = []
    for i in top.tolist():
        Hb, mb = Hs[i:i + 1], masks[i]
        fit_on = mb
        for wider in (2.0, 1.5, 1.0):
            # A refit on no pairs is the all-NaN homography, as the
            # zero-weighted DLT gives; it holds no inliers.
            Hf = dlt(src, dst, fit_on)[None] if bool(fit_on.any()) \
                else torch.full((1, 3, 3), torch.nan, device=src.device)
            mf = inliers(Hf, t)[0]
            if int(mf.sum()) >= int(mb.sum()):
                Hb, mb = Hf, mf
            fit_on = inliers(Hf, t * wider)[0]
        err = torch.where(mb, sq_err(Hb, src, dst)[0].double(), 0.0).sum()
        best.append((Hb[0], mb, float(mb.sum()), err.float()))
    rank = torch.stack([torch.tensor(c, dtype=torch.float32) * 1e6 - e.cpu()
                        for _, _, c, e in best])
    k = int(torch.argmax(rank))
    return best[k][0], best[k][1]
