"""Set-up of an ORB configuration: the port's ORBConfig from the
configuration's `orb` fields (all but `seed`, the RANSAC draws' seed); an
answer is one frame's ORBResult as the comparison reads it."""

import types

import numpy as np


def learn(fipm, config: dict, templ, device):
    """-> what the entries get as ctx.learned: .cfg, .seed and .template
    (the host u8 array). ORB learns nothing ahead: each call detects the
    template's features again."""
    fields = dict(config["orb"])
    seed = fields.pop("seed")
    return types.SimpleNamespace(cfg=fipm.ORBConfig(**fields), seed=seed,
                                 template=templ)


def rows(result) -> dict:
    """{"matched", "inliers", "good" (valid best pairs), "pairs" [good, 4]
    (source x, y, template x, y, in the port's order), "corners" [4, 2]
    or None}; an unmatched result holds no pairs."""
    if not result.is_matched:
        return {"matched": False, "inliers": int(result.num_inliers),
                "good": 0, "pairs": np.zeros((0, 4)), "corners": None}
    g = int(result.num_good_matches)
    pairs = np.concatenate([result.src_pts[:g], result.dst_pts[:g]], 1)
    return {"matched": True, "inliers": int(result.num_inliers), "good": g,
            "pairs": pairs.astype(np.float64),
            "corners": np.asarray(result.corners, np.float64)}
