"""Core data types: learned pattern, match results.

TPU mapping of the reference structs:
  - LearnedPattern  <- s_TemplData  (MatchTool/MatchToolDlg.h:14-42)
  - MatchResult     <- s_SingleTargetMatch (MatchToolDlg.h:83-88)
Per-level statistics are computed once at learn time in float64 on the host
(mirroring cv::meanStdDev in LearnPattern, MatchToolDlg.cpp:453-491) and are
baked into the compiled match program as scalars.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class LevelData:
    """Per-pyramid-level template data."""
    templ: np.ndarray          # [h, w] f32, u8-valued
    mean: float                # cv::meanStdDev mean (channel 0)
    norm: float                # sigma * sqrt(area)
    inv_area: float
    result_equal1: bool        # flat template -> all scores 1

    @functools.cached_property
    def u8_valued(self) -> bool:
        """Whether templ holds integers in [0, 255] alone, worked out once
        a level: the descent-score kernel's integer sums need it."""
        t = np.asarray(self.templ)
        return bool(np.all((t >= 0) & (t <= 255) & (np.rint(t) == t)))


@dataclasses.dataclass
class LearnedPattern:
    """Learned template pyramid + stats (s_TemplData equivalent).

    Serializable via save()/load() — the reference keeps this only in RAM;
    a persistent artifact is part of the TPU build's checkpointing story
    (SURVEY.md §5).
    """
    levels: List[LevelData]
    border_color: int          # 255 if template mean < 128 else 0
    min_reduce_area: int
    # Learn-time ROI (x, y, w, h) in full-template-image coordinates, if the
    # pattern was trained on a sub-rectangle (the UI's user rect capability,
    # src/MatchToolDialog.cpp:1087-1123). None = whole image.
    roi: Optional[Tuple[int, int, int, int]] = None
    # User-marked polygon regions in learned-template coordinates (the UI's
    # polygon marking, src/MatchToolDialog.cpp:962-1530); each is an [N, 2]
    # float array. Projected onto every match by MatchResult.project_points.
    regions: Tuple[np.ndarray, ...] = ()

    @property
    def top_layer(self) -> int:
        return len(self.levels) - 1

    @property
    def shapes(self) -> List[Tuple[int, int]]:
        return [lv.templ.shape for lv in self.levels]

    def save(self, path: str) -> None:
        arrs = {f"templ_{i}": lv.templ for i, lv in enumerate(self.levels)}
        for i, reg in enumerate(self.regions):
            arrs[f"region_{i}"] = np.asarray(reg, np.float32)
        meta = np.array([
            [lv.mean, lv.norm, lv.inv_area, float(lv.result_equal1)]
            for lv in self.levels], dtype=np.float64)
        roi = np.array([-1, -1, -1, -1] if self.roi is None else self.roi,
                       dtype=np.int64)
        np.savez(path, meta=meta, border_color=self.border_color,
                 min_reduce_area=self.min_reduce_area, roi=roi, **arrs)

    @classmethod
    def load(cls, path: str) -> "LearnedPattern":
        data = np.load(path)
        meta = data["meta"]
        levels = [
            LevelData(templ=data[f"templ_{i}"], mean=float(m[0]),
                      norm=float(m[1]), inv_area=float(m[2]),
                      result_equal1=bool(m[3]))
            for i, m in enumerate(meta)]
        roi = None
        if "roi" in data.files:
            r = data["roi"]
            roi = None if r[0] < 0 else tuple(int(v) for v in r)
        regions = []
        i = 0
        while f"region_{i}" in data.files:
            regions.append(data[f"region_{i}"])
            i += 1
        return cls(levels=levels, border_color=int(data["border_color"]),
                   min_reduce_area=int(data["min_reduce_area"]),
                   roi=roi, regions=tuple(regions))


@dataclasses.dataclass
class MatchResult:
    """One matched target (s_SingleTargetMatch equivalent)."""
    score: float
    angle: float               # degrees, wrapped to (-180, 180]
    center: Tuple[float, float]
    lt: Tuple[float, float]
    rt: Tuple[float, float]
    rb: Tuple[float, float]
    lb: Tuple[float, float]
    # Marked pattern regions projected into this match's source frame
    # (populated by match() when the pattern carries regions); each [N, 2].
    regions: Tuple[np.ndarray, ...] = ()

    @property
    def pos_x(self) -> float:
        return self.center[0]

    @property
    def pos_y(self) -> float:
        return self.center[1]

    def project_points(self, pts: np.ndarray) -> np.ndarray:
        """Map template-coordinate points [N, 2] into this match's source
        frame: p -> LT + R(-angle) p, the same affine frame the corners are
        built from (rotated_rect_corners; the reference's center-offset
        formulation transformPolygonToResult,
        src/MatchToolDialog.cpp:1481-1530, is the same map re-anchored at
        the template center)."""
        pts = np.asarray(pts, np.float64)
        # corners are rotated_rect_corners(lt, internal_angle) with
        # internal_angle = -self.angle (result assembly negates,
        # MatchToolDlg.cpp:1093-1099), and that helper uses
        # ra = -internal_angle, i.e. ra = +self.angle.
        r = self.angle * np.pi / 180.0
        c, s = np.cos(r), np.sin(r)
        lt = np.asarray(self.lt, np.float64)
        # Columns of R: image of (1,0) is (c, -s) (matches rt-lt = w*(c,-s));
        # image of (0,1) is (s, c) (matches lb-lt = h*(s, c)).
        x = pts[:, 0] * c + pts[:, 1] * s + lt[0]
        y = -pts[:, 0] * s + pts[:, 1] * c + lt[1]
        return np.stack([x, y], axis=1)
