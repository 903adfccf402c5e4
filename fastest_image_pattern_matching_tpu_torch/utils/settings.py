"""Persistent user settings (a copy of
fastest_image_pattern_matching_tpu/utils/settings.py: the same file and the
same FIPM_TPU_SETTINGS override, since both packages serve one user's
settings) — the headless analogue of the reference's
QSettings store (org "FastestImagePatternMatching", app "MatchTool":
loadSettings/saveSettings, src/MatchToolDialog.cpp:495-561), which persists
the matching parameters and the last-used image paths between sessions.

Stored as JSON under $FIPM_TPU_SETTINGS, or ~/.config/fipm_tpu/settings.json.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

# The persisted parameter set mirrors MatchToolDialog::saveSettings
# (src/MatchToolDialog.cpp:528-561): the 5 numeric params, the checkboxes,
# and the last source/template paths — plus the camera store
# (CameraPreviewDialog::saveCameraSettings, src/CameraPreviewDialog.cpp:
# 722-739: last selected camera, exposure, gain, trigger flag).
PERSISTED_KEYS = (
    "max_pos", "max_overlap", "score", "tolerance_angle", "min_reduce_area",
    "use_subpixel", "bitwise_not", "fast_mode", "compute_dtype",
    "last_source", "last_template",
    "last_camera", "camera_exposure", "camera_gain", "camera_trigger",
)


def settings_path() -> str:
    env = os.environ.get("FIPM_TPU_SETTINGS")
    if env:
        return env
    base = os.environ.get("XDG_CONFIG_HOME",
                          os.path.join(os.path.expanduser("~"), ".config"))
    return os.path.join(base, "fipm_tpu", "settings.json")


def load_settings(path: str = None) -> Dict[str, Any]:
    path = path or settings_path()
    try:
        with open(path) as f:
            data = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return {}
    return {k: v for k, v in data.items() if k in PERSISTED_KEYS}


def save_settings(values: Dict[str, Any], path: str = None) -> str:
    path = path or settings_path()
    current = load_settings(path)
    current.update({k: v for k, v in values.items()
                    if k in PERSISTED_KEYS and v is not None})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(current, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def clear_settings(path: str = None) -> None:
    path = path or settings_path()
    try:
        os.remove(path)
    except FileNotFoundError:
        pass
