"""The port's CLI (fastest_image_pattern_matching_tpu_torch/cli.py) and the
host helpers it needs (utils/imageio.save_gray, serialization, settings,
i18n, sources), on the CPU (`--device cpu`), with the settings file in the
test's temporary directory.

The CLI's `match` is held to the port's own match() exactly (the same
code), and to the JAX CLI's output on the same files within the port's
end-to-end tolerances (valid count equal, score 1e-5, centre and angle
1e-3). The helpers are copies of the JAX package's numpy-only modules and
are held against them on the same inputs.
"""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from fastest_image_pattern_matching_tpu import cli as jcli
from fastest_image_pattern_matching_tpu import types as jtypes
from fastest_image_pattern_matching_tpu.utils import i18n as ji18n
from fastest_image_pattern_matching_tpu.utils import (
    serialization as jser)
from fastest_image_pattern_matching_tpu.utils import settings as jset
from fastest_image_pattern_matching_tpu.utils import sources as jsrc

import fastest_image_pattern_matching_tpu_torch as tfipm
from fastest_image_pattern_matching_tpu_torch import cli as tcli
from fastest_image_pattern_matching_tpu_torch import types as ttypes
from fastest_image_pattern_matching_tpu_torch.utils import i18n as ti18n
from fastest_image_pattern_matching_tpu_torch.utils import (
    serialization as tser)
from fastest_image_pattern_matching_tpu_torch.utils import settings as tset
from fastest_image_pattern_matching_tpu_torch.utils import sources as tsrc
from fastest_image_pattern_matching_tpu_torch.utils.imageio import (
    load_gray, save_gray)
from chip_smoke import glyph, ocr_plate
from tests.test_torch_orb import _dryrun_pair

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATCH_FLAGS = ["--max-pos", "2", "--tolerance-angle", "30"]


@pytest.fixture
def files(tmp_path, monkeypatch):
    """The dry-run ORB scene and its template as BMPs, the settings file
    in tmp_path."""
    monkeypatch.setenv("FIPM_TPU_SETTINGS", str(tmp_path / "settings.json"))
    scene, tpl = _dryrun_pair()
    paths = {"scene": str(tmp_path / "scene.bmp"),
             "tpl": str(tmp_path / "tpl.bmp")}
    save_gray(paths["scene"], scene)
    save_gray(paths["tpl"], tpl)
    return paths, scene, tpl


def _run(capsys, argv):
    rc = tcli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _match_cfg():
    return tfipm.MatchConfig(max_pos=2, tolerance_angle=30.0)


def test_match_json_equals_the_ports_match(files, capsys):
    paths, scene, tpl = files
    rc, out, _ = _run(capsys, ["--device", "cpu", "match", "-s",
                               paths["scene"], "-t", paths["tpl"], "--json"]
                      + MATCH_FLAGS)
    assert rc == 0
    got = json.loads(out)
    want = tfipm.match(scene, tfipm.learn_pattern(tpl, device="cpu"),
                       _match_cfg(), device="cpu")
    assert got["count"] == len(want) == 1
    assert got["matches"] == [{
        "index": i, "score": r.score, "angle": r.angle, "pos_x": r.pos_x,
        "pos_y": r.pos_y,
        "corners": [list(r.lt), list(r.rt), list(r.rb), list(r.lb)],
    } for i, r in enumerate(want)]


def test_match_json_vs_the_jax_cli(files, capsys, monkeypatch):
    paths, _, _ = files
    monkeypatch.setenv("FIPM_CACHE_DIR", "")
    argv = ["match", "-s", paths["scene"], "-t", paths["tpl"], "--json",
            "--no-settings"] + MATCH_FLAGS
    assert jcli.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    rc, out, _ = _run(capsys, ["--device", "cpu"] + argv)
    assert rc == 0
    got = json.loads(out)
    assert got["count"] == want["count"] == 1
    for g, w in zip(got["matches"], want["matches"]):
        assert abs(g["score"] - w["score"]) <= 1e-5
        assert abs(g["angle"] - w["angle"]) <= 1e-3
        assert abs(g["pos_x"] - w["pos_x"]) <= 1e-3
        assert abs(g["pos_y"] - w["pos_y"]) <= 1e-3
        assert np.abs(np.subtract(g["corners"], w["corners"])).max() <= 1e-3


def test_match_settings_precedence_and_roi_dump(files, capsys, tmp_path):
    """Flag > saved setting > UI default; the last paths are remembered;
    --output-roi writes the matched crop as a BMP."""
    paths, scene, _ = files
    rc, _, _ = _run(capsys, ["--device", "cpu", "match", "-s",
                             paths["scene"], "-t", paths["tpl"], "--json",
                             "--score", "0.6"] + MATCH_FLAGS)
    assert rc == 0
    saved = tset.load_settings()
    assert saved["score"] == 0.6 and saved["max_pos"] == 2
    assert saved["last_source"] == paths["scene"]
    roi_dir = str(tmp_path / "rois")
    rc, out, _ = _run(capsys, ["--device", "cpu", "match", "--max-pos", "1",
                               "--output-roi", roi_dir])
    assert rc == 0
    assert "Total number: 1" in out
    saved = tset.load_settings()
    assert saved["max_pos"] == 1 and saved["score"] == 0.6
    assert saved["tolerance_angle"] == 30.0
    r = tfipm.match(scene, tfipm.learn_pattern(files[2], device="cpu"),
                    tfipm.MatchConfig(max_pos=1, score=0.6,
                                      tolerance_angle=30.0),
                    device="cpu")[0]
    xs, ys = (r.lt[0], r.rt[0], r.rb[0], r.lb[0]), (r.lt[1], r.rt[1],
                                                     r.rb[1], r.lb[1])
    crop = scene[int(min(ys)):int(max(ys)) + 1, int(min(xs)):int(max(xs)) + 1]
    assert crop.shape[0] >= 80 and crop.shape[1] >= 100
    np.testing.assert_array_equal(
        load_gray(os.path.join(roi_dir, "roi0.bmp")), crop)


def test_match_text_output_in_a_lang_file_language(files, capsys,
                                                   tmp_path):
    paths, _, _ = files
    lang = tmp_path / "MatchTool.Lang"
    lang.write_text("[Deutsch]\nTotalNumber=Anzahl\nScore=Wert\n",
                    encoding="utf-8")
    base = ["--device", "cpu", "match", "-s", paths["scene"], "-t",
            paths["tpl"], "--no-settings"] + MATCH_FLAGS
    rc, out, _ = _run(capsys, base + ["--lang", "Deutsch", "--lang-file",
                                      str(lang)])
    assert rc == 0
    assert "Anzahl: 1" in out and "Wert" in out and "PosX" in out
    rc, _, err = _run(capsys, base + ["--lang", "Deutsch"])
    assert rc == 2 and "lang_file" in err


def test_orb_json_equals_orb_match(files, capsys):
    paths, scene, tpl = files
    rc, out, _ = _run(capsys, ["--device", "cpu", "orb", "-s",
                               paths["scene"], "-t", paths["tpl"], "--json",
                               "--max-features", "150",
                               "--max-good-matches", "60"])
    assert rc == 0
    got = json.loads(out)
    want = tfipm.orb_match(scene, tpl, tfipm.ORBConfig(
        max_features=150, max_good_matches=60), device="cpu")
    assert got["is_matched"] is True
    assert got["num_inliers"] == want.num_inliers
    assert got["num_good_matches"] == want.num_good_matches
    assert got["homography"] == want.homography.tolist()
    assert got["corners"] == want.corners.tolist()
    assert np.abs(np.asarray(got["corners"][0]) - [40, 30]).max() < 2.0


def test_ocr_json_reads_a_three_glyph_plate(tmp_path, capsys):
    gdir = tmp_path / "glyphs"
    gdir.mkdir()
    for ch in "A7Z":
        save_gray(str(gdir / f"{ch}.bmp"), glyph(ch))
    plate, _ = ocr_plate("Z7A", hw=(120, 220), x0=20, y0=30)
    save_gray(str(tmp_path / "plate.bmp"), plate)
    rc, out, _ = _run(capsys, ["--device", "cpu", "ocr", "--glyphs-dir",
                               str(gdir), "-s", str(tmp_path / "plate.bmp"),
                               "--json"])
    assert rc == 0
    got = json.loads(out)
    assert got["text"] == "Z7A" and got["glyphs"] == 3
    assert [m["label"] for m in sorted(got["matches"],
                                       key=lambda m: m["pos_x"])] == [
        "Z", "7", "A"]
    rc, _, err = _run(capsys, ["--device", "cpu", "ocr", "--glyphs-dir",
                               str(tmp_path / "rois"), "-s",
                               str(tmp_path / "plate.bmp")])
    assert rc == 2 and "no glyph images" in err


def test_watch_directory_max_frames(files, capsys, tmp_path):
    paths, scene, tpl = files
    wdir = tmp_path / "watch"
    wdir.mkdir()
    frames = [scene, np.roll(scene, 20, axis=1), np.roll(scene, 15, axis=0),
              scene]
    for i, f in enumerate(frames):
        save_gray(str(wdir / f"f{i}.bmp"), f)
    out_p = str(tmp_path / "w.jsonl")
    rc, out, _ = _run(capsys, ["--device", "cpu", "watch", "-t",
                               paths["tpl"], "--directory", str(wdir),
                               "--max-frames", "3", "--out", out_p,
                               "--max-pos", "1", "--tolerance-angle", "10"])
    assert rc == 0
    with open(out_p) as f:
        recs = [json.loads(line) for line in f]
    assert [os.path.basename(r["path"]) for r in recs] == [
        "f0.bmp", "f1.bmp", "f2.bmp"]
    pat = tfipm.learn_pattern(tpl, device="cpu")
    cfg = tfipm.MatchConfig(max_pos=1, tolerance_angle=10.0)
    for r, f in zip(recs, frames):
        want = tser.match_results_to_dict(
            tfipm.match(f, pat, cfg, device="cpu"))
        assert r["matches"] == want["matches"] and r["count"] == 1


def test_settings_show_and_clear(files, capsys):
    tset.save_settings({"score": 0.8, "last_source": "a.bmp"})
    rc, out, _ = _run(capsys, ["settings"])
    assert rc == 0
    shown = json.loads(out)
    assert shown["path"] == os.environ["FIPM_TPU_SETTINGS"]
    assert shown["settings"] == {"score": 0.8, "last_source": "a.bmp"}
    rc, out, _ = _run(capsys, ["settings", "--clear"])
    assert rc == 0 and out.startswith("cleared")
    assert tset.load_settings() == {}


def test_cuda_without_a_card_exits_nonzero(files, capsys, monkeypatch):
    import torch
    paths, _, _ = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["match", "-s", paths["scene"], "-t", paths["tpl"]],
                 ["orb", "-s", paths["scene"], "-t", paths["tpl"]]):
        rc, out, err = _run(capsys, argv)
        assert rc == 2 and out == ""
        assert "torch.cuda.is_available() is False" in err
    assert not os.path.exists(os.environ["FIPM_TPU_SETTINGS"])


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (40, 33), (3, 4)])
def test_save_gray_load_gray_round_trip(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(
        np.uint8)
    p = str(tmp_path / "a.bmp")
    save_gray(p, img)
    np.testing.assert_array_equal(load_gray(p), img)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_GRAYSCALE), img)
    q = str(tmp_path / "a.png")
    save_gray(q, img.astype(np.float64) + 0.3)
    np.testing.assert_array_equal(load_gray(q), img)


def _results(types):
    return [types.MatchResult(score=0.9 - 0.1 * i, angle=10.0 * i,
                              center=(50.0 + i, 40.0), lt=(10.0, 5.0 + i),
                              rt=(90.0, 5.0), rb=(90.0, 75.0),
                              lb=(10.0, 75.0)) for i in range(3)]


def test_serialization_matches_the_jax_copy(tmp_path):
    jr, tr = _results(jtypes), _results(ttypes)
    assert tser.match_results_to_dict(tr, 3.5) == \
        jser.match_results_to_dict(jr, 3.5)
    tser.save_match_results(str(tmp_path / "t.json"), tr, 1.0)
    jser.save_match_results(str(tmp_path / "j.json"), jr, 1.0)
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    back = tser.load_match_results(str(tmp_path / "j.json"))
    assert [(r.score, r.center, r.lb) for r in back] == \
        [(r.score, r.center, r.lb) for r in tr]
    for mod, name in ((tser, "t.jsonl"), (jser, "j.jsonl")):
        mod.append_jsonl(str(tmp_path / name), {"a": 1})
        mod.append_jsonl(str(tmp_path / name), {"b": [2.5]})
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    src = np.random.default_rng(2).integers(0, 256, (100, 120)).astype(
        np.uint8)
    tp = tser.save_roi_dumps(str(tmp_path / "troi"), src, tr)
    jp = jser.save_roi_dumps(str(tmp_path / "jroi"), src, jr)
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp]
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(load_gray(a), cv2.imread(
            b, cv2.IMREAD_GRAYSCALE))


def test_orb_records_match_the_jax_copy(tmp_path):
    res = tfipm.ORBResult(
        is_matched=True, homography=np.eye(3), num_inliers=40,
        num_good_matches=60, avg_pixel_shift=12.5,
        corners=np.array([[0.0, 0.0], [10.0, 0.0], [10.0, 8.0], [0.0, 8.0]]),
        scale_mm_per_pix=0.64, rotation_angle=3.0)
    for ext in (".json", ".yml"):
        t, j = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
        assert tser.save_orb_result(t, res) and jser.save_orb_result(j, res)
        assert tser.load_orb_result(t) == jser.load_orb_result(j)
    assert tser.load_orb_result(str(tmp_path / "t.json"))[
        "matchLocation_x"] == 5.0
    assert not tser.save_orb_result(str(tmp_path / "u.json"),
                                    tfipm.ORBResult(False, None, 0, 0, 0.0,
                                                    None))


def test_settings_match_the_jax_copy(tmp_path, monkeypatch):
    monkeypatch.setenv("FIPM_TPU_SETTINGS", str(tmp_path / "s.json"))
    assert tset.settings_path() == jset.settings_path()
    monkeypatch.delenv("FIPM_TPU_SETTINGS")
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    assert tset.settings_path() == jset.settings_path() == str(
        tmp_path / "cfg" / "fipm_tpu" / "settings.json")
    p = str(tmp_path / "x" / "s.json")
    vals = {"max_pos": 5, "score": None, "unknown": 1, "fast_mode": True,
            "last_template": "t.bmp"}
    tset.save_settings(vals, p)
    assert jset.load_settings(p) == tset.load_settings(p) == {
        "max_pos": 5, "fast_mode": True, "last_template": "t.bmp"}
    q = str(tmp_path / "y" / "s.json")
    jset.save_settings(vals, q)
    assert open(p).read() == open(q).read()
    tset.clear_settings(p)
    tset.clear_settings(p)
    assert tset.load_settings(p) == {}


@pytest.mark.parametrize("encoding", ["utf-8", "utf-16"])
def test_i18n_matches_the_jax_copy(tmp_path, encoding):
    path = tmp_path / "MatchTool.Lang"
    path.write_text("; comment\n[English]\nScore=Score\n[Deutsch]\n"
                    "Score = Wert\nIndex=Nr.\nIndex=Nummer\n# x\nbad line\n"
                    "[Espanol]\nPosX=Pos X\n", encoding=encoding)
    assert ti18n.parse_lang_file(str(path)) == \
        ji18n.parse_lang_file(str(path))
    assert ti18n.available_languages(str(path)) == \
        ji18n.available_languages(str(path)) == [
            "Deutsch", "English", "Espanol"]
    t = ti18n.Translator("Deutsch", str(path))
    j = ji18n.Translator("Deutsch", str(path))
    for key in ("Score", "Index", "PosX", "TotalNumber", "NoSuchKey"):
        assert t.t(key) == j.t(key)
    assert t.t("Index") == "Nummer"
    for args in (("Deutsch", None), ("Klingon", str(path))):
        with pytest.raises(ValueError):
            ti18n.Translator(*args)
        with pytest.raises(ValueError):
            ji18n.Translator(*args)


def test_sources_match_the_jax_copy(tmp_path):
    rng = np.random.default_rng(6)
    imgs = [rng.integers(0, 256, (30, 40)).astype(np.uint8)
            for _ in range(3)]
    for i, im in enumerate(imgs):
        save_gray(str(tmp_path / f"f{i}.bmp"), im)
    t = list(tsrc.FolderSource(str(tmp_path)))
    j = list(jsrc.FolderSource(str(tmp_path)))
    assert len(t) == len(j) == 3
    for a, b, c in zip(t, j, imgs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    tpl = imgs[0][:8, :10]
    for a, b in zip(tsrc.SyntheticSource((20, 30), 3, seed=2,
                                         template=tpl),
                    jsrc.SyntheticSource((20, 30), 3, seed=2,
                                         template=tpl)):
        np.testing.assert_array_equal(a, b)


def test_video_capture_source_every_frame_with_an_injected_grabber():
    class Cap:
        def __init__(self, src):
            self.n = 0

        def isOpened(self):
            return True

        def read(self):
            self.n += 1
            if self.n > 4:
                return False, None
            return True, np.full((6, 8, 3), 10 * self.n, np.uint8)

        def release(self):
            pass

    got = list(tsrc.VideoCaptureSource("clip", latest_only=False,
                                       cap_factory=Cap).frames())
    want = list(jsrc.VideoCaptureSource("clip", latest_only=False,
                                        cap_factory=Cap).frames())
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.shape == (6, 8)
        np.testing.assert_array_equal(a, b)


def test_port_cli_and_orb_import_no_jax():
    code = ("import sys\n"
            "import fastest_image_pattern_matching_tpu_torch.cli\n"
            "import fastest_image_pattern_matching_tpu_torch.models.orb\n"
            "import fastest_image_pattern_matching_tpu_torch.utils.sources\n"
            "import fastest_image_pattern_matching_tpu_torch.utils."
            "serialization\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('jaxlib') or m == "
            "'fastest_image_pattern_matching_tpu' or m.startswith("
            "'fastest_image_pattern_matching_tpu.') or m == 'cv2']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
