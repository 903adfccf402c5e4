"""Set-up of a template-matching configuration: the port's MatchConfig
from the configuration's `match` fields and the pattern learned from the
scene's template; an answer is a match list as rows."""

import types

import numpy as np


def learn(fipm, config: dict, templ, device):
    """-> what the entries get as ctx.learned: .pattern and .cfg."""
    cfg = fipm.MatchConfig(**config["match"])
    pattern = fipm.learn_pattern(templ, cfg.min_reduce_area, device=device)
    return types.SimpleNamespace(pattern=pattern, cfg=cfg)


def rows(results) -> np.ndarray:
    """A match list as [n, 4] rows of (score, angle, centre x, y)."""
    return np.array([[r.score, r.angle, r.center[0], r.center[1]]
                     for r in results], np.float64).reshape(-1, 4)
