"""The port's camera surface, twins of tests/test_camera_controls.py and
tests/test_cli_camera.py: VideoCaptureSource's exposure / gain / trigger /
scan controls and every-frame mode against the same stand-in capture
object, and the port's CLI `watch --camera` (trigger mode, and a video
file through cv2.VideoCapture) on the CPU (`--device cpu`)."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from fastest_image_pattern_matching_tpu_torch import cli
from fastest_image_pattern_matching_tpu_torch.utils import sources
from fastest_image_pattern_matching_tpu_torch.utils.sources import (
    VideoCaptureSource)

# cv2 provides the CAP_PROP_* constants of the passthrough and the
# default grabber; the port imports it only there.
cv2 = pytest.importorskip("cv2")

torch.set_num_threads(1)


class FakeCap:
    """Stands in for cv2.VideoCapture: records property sets, serves
    numbered frames."""

    def __init__(self, source, n_frames=100, openable=True):
        self.source = source
        self.props = {}
        self.n_frames = n_frames
        self.reads = 0
        self.released = False
        self._openable = openable

    def isOpened(self):
        return self._openable

    def set(self, prop, value):
        self.props[prop] = value
        return True

    def get(self, prop):
        return self.props.get(prop, 0.0)

    def read(self):
        if self.reads >= self.n_frames:
            return False, None
        self.reads += 1
        return True, np.full((24, 32), self.reads % 256, np.uint8)

    def release(self):
        self.released = True


def test_exposure_gain_applied_on_open():
    caps = []

    def factory(src):
        cap = FakeCap(src)
        caps.append(cap)
        return cap

    with VideoCaptureSource(0, exposure=8000.0, gain=2.5,
                            cap_factory=factory) as cam:
        assert caps[0].props[cv2.CAP_PROP_EXPOSURE] == 8000.0
        assert caps[0].props[cv2.CAP_PROP_GAIN] == 2.5
        assert cam.get_exposure() == 8000.0
        assert cam.get_gain() == 2.5
        assert cam.set_exposure(4000.0)
        assert cam.get_exposure() == 4000.0
    assert caps[0].released


def test_controls_require_open():
    cam = VideoCaptureSource(0, cap_factory=FakeCap)
    with pytest.raises(RuntimeError, match="not open"):
        cam.set_exposure(1.0)
    with pytest.raises(RuntimeError, match="not open"):
        cam.set_trigger(True)


def test_software_trigger_capture_on_demand():
    with VideoCaptureSource(0, cap_factory=FakeCap) as cam:
        with pytest.raises(RuntimeError, match="not armed"):
            cam.trigger_fire()
        cam.set_trigger(True)
        assert cam.trigger_enabled
        f1 = cam.trigger_fire()
        f2 = cam.trigger_fire()
        assert f1.shape == (24, 32) and f2[0, 0] == 2
        assert cam.frame_count == 2
        # frames() refuses to free-run while the trigger is armed.
        with pytest.raises(RuntimeError, match="trigger is armed"):
            next(cam.frames())
        cam.set_trigger(False)
        assert not cam.trigger_enabled


def test_trigger_fire_stream_end():
    with VideoCaptureSource(0, cap_factory=lambda s: FakeCap(s, n_frames=1)
                            ) as cam:
        cam.set_trigger(True)
        cam.trigger_fire()
        with pytest.raises(RuntimeError, match="no frame"):
            cam.trigger_fire()


def test_scan_enumerates_openable_devices():
    def factory(i):
        return FakeCap(i, openable=(i in (0, 2)))

    assert VideoCaptureSource.scan(max_devices=4, cap_factory=factory) \
        == [0, 2]


def test_every_frame_counts_frames():
    src = VideoCaptureSource(0, max_frames=3, latest_only=False,
                             cap_factory=FakeCap)
    frames = list(src.frames())
    assert len(frames) == 3
    assert src.frame_count == 3


def _watch(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--device", "cpu", "watch", *argv])
    return rc, buf.getvalue()


def test_watch_camera_trigger_mode(tmp_path, monkeypatch):
    """watch --camera --trigger: one fire per match loop; the camera
    settings persisted. The template is a PNG written by cv2."""
    rng = np.random.default_rng(4)
    tpl = rng.integers(0, 255, (20, 24), np.uint8)

    class SceneCap(FakeCap):
        def read(self):
            self.reads += 1
            if self.reads > 5:
                return False, None
            f = rng.integers(0, 40, (120, 160), np.uint8)
            f[30:50, 60:84] = tpl
            return True, f

    monkeypatch.setattr(sources, "VideoCaptureSource",
                        lambda *a, **kw: VideoCaptureSource(
                            *a, **{**kw, "cap_factory": SceneCap}))
    monkeypatch.setenv("FIPM_TPU_SETTINGS", str(tmp_path / "settings.json"))
    tp = str(tmp_path / "t.png")
    cv2.imwrite(tp, tpl)
    out_jsonl = str(tmp_path / "res.jsonl")
    rc, _ = _watch(["-t", tp, "-c", "0", "--trigger", "--max-frames", "3",
                    "--tolerance-angle", "0", "--score", "0.5",
                    "--max-pos", "2", "--exposure", "5000",
                    "--out", out_jsonl])
    assert rc == 0
    recs = [json.loads(line) for line in open(out_jsonl)]
    assert len(recs) == 3
    assert all(len(r["matches"]) == 1 for r in recs)
    saved = json.load(open(tmp_path / "settings.json"))
    assert saved["last_camera"] == "0"
    assert saved["camera_exposure"] == 5000.0


def test_watch_camera_video_stream(tmp_path, monkeypatch):
    monkeypatch.setenv("FIPM_TPU_SETTINGS", str(tmp_path / "settings.json"))
    rng = np.random.default_rng(1)
    tpl = rng.integers(0, 255, (40, 48), np.uint8)
    vp = str(tmp_path / "clip.avi")
    vw = cv2.VideoWriter(vp, cv2.VideoWriter_fourcc(*"MJPG"), 30.0,
                         (320, 240), isColor=False)
    assert vw.isOpened()
    for _ in range(10):
        f = rng.integers(0, 40, (240, 320), np.uint8)
        f[60:100, 100:148] = tpl
        vw.write(f)
    vw.release()
    tp = str(tmp_path / "t.png")
    cv2.imwrite(tp, tpl)
    out_jsonl = str(tmp_path / "res.jsonl")
    rc, out = _watch(["-t", tp, "-c", vp, "--every-frame", "--max-frames",
                      "4", "--tolerance-angle", "0", "--score", "0.5",
                      "--max-pos", "2", "--out", out_jsonl])
    assert rc == 0
    assert out.count("1 matches") == 4
    recs = [json.loads(line) for line in open(out_jsonl)]
    assert len(recs) == 4
    # MJPG is lossy; the planted target's centre must still be found.
    m = recs[0]["matches"][0]
    assert abs(m["pos_x"] - 123.5) < 2 and abs(m["pos_y"] - 79.5) < 2


def test_watch_requires_directory_or_camera(tmp_path):
    tp = str(tmp_path / "t.png")
    cv2.imwrite(tp, np.zeros((16, 16), np.uint8))
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["watch", "-t", tp])
