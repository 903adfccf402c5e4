"""The goldens replay through the port: tests/test_conformance.py's cases
(tests/goldens.json, the JAX package's match lists on the reference's
real Test Images pairs, recorded by tools/record_goldens.py) run through
the port on the CPU, with the same tolerances. The images are not in the
repository: each case skips, saying so, where the reference's Test Images
directory is absent."""

import os

import pytest
import torch

import fastest_image_pattern_matching_tpu_torch as tfipm
from fastest_image_pattern_matching_tpu_torch.utils.imageio import load_gray

from test_conformance import TI, _G

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(_G))
def test_conformance_case(name):
    case = _G[name]
    paths = [os.path.join(TI, case[k]) for k in ("src", "dst")]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        pytest.skip(f"reference images unavailable: {missing} (the goldens "
                    f"replay needs the reference's Test Images directory)")
    src = load_gray(paths[0])
    if case.get("invert_src"):
        src = 255 - src
    tpl = load_gray(paths[1])
    cfg = tfipm.MatchConfig(**case["config"])
    pattern = tfipm.learn_pattern(tpl, cfg.min_reduce_area, device="cpu")
    res = tfipm.match(src, pattern, cfg, device="cpu")

    want = case["matches"]
    assert len(res) == len(want), (
        f"{name}: {len(res)} matches vs golden {len(want)}")
    for r, (ws, wa, wx, wy) in zip(res, want):
        assert abs(r.score - ws) < 5e-3, (name, r.score, ws)
        da = (r.angle - wa + 180) % 360 - 180
        assert abs(da) < 0.5, (name, r.angle, wa)
        assert abs(r.pos_x - wx) < 1.0, (name, r.pos_x, wx)
        assert abs(r.pos_y - wy) < 1.0, (name, r.pos_y, wy)
