"""Headless CLI of the PyTorch port — the port of
fastest_image_pattern_matching_tpu/cli.py, the replacement for the
reference's GUI apps.

    python -m fastest_image_pattern_matching_tpu_torch.cli [--device cpu] \
        {match,settings,orb,aot-export,aot-match,ocr,watch} ...

Mirrors the Qt entry's flags (-s/--source, -t/--template, src/main.cpp:29-63)
and exposes every matching parameter of the dialogs (MatchToolDlg.cpp:108-117
validation ranges; ui/MatchToolDialog.ui defaults). Outputs the results table
the dialogs show (index/score/angle/posX/posY, MatchToolDlg.cpp:1119-1139)
as text or JSON, plus optional annotated overlay and matched-ROI dumps
(OutputRoi, MatchToolDlg.cpp:1223-1236).

The subcommands, flags, defaults and outputs are the JAX CLI's. --device
(default cuda) takes the place of its --platform; a CUDA device without a
card is an error, never a quiet run on the CPU. The overlay images of
--output-image need cv2, imported only for them. aot-export writes a
deployment pack (aot.py: the learned pattern, config and plans, and with
--include-executables the kernels' and the native library's shared
libraries); aot-match serves a frame from one. Not ported: bench (it
measures the JAX package).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fipm-torch",
        description="Rotation-invariant template matching on an NVIDIA "
                    "card (PyTorch/CUDA)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs on "
                   "the host)")
    sub = p.add_subparsers(dest="command", required=True)

    m = sub.add_parser("match", help="find template instances in a source image")
    # Numeric params default to None so saved settings (the QSettings
    # analogue, src/MatchToolDialog.cpp:495-561) can fill unspecified ones;
    # reference UI defaults apply last (ui/MatchToolDialog.ui:103-213).
    m.add_argument("-s", "--source", default=None, help="source image path "
                   "(defaults to the last used one from settings)")
    m.add_argument("-t", "--template", default=None, help="template image "
                   "path (defaults to the last used one from settings)")
    m.add_argument("--max-pos", type=int, default=None,
                   help="max targets (1-200)")
    m.add_argument("--max-overlap", type=float, default=None)
    m.add_argument("--score", type=float, default=None)
    m.add_argument("--tolerance-angle", type=float, default=None)
    m.add_argument("--min-reduce-area", type=int, default=None)
    m.add_argument("--tolerance-ranges", type=float, nargs=4,
                   metavar=("T1", "T2", "T3", "T4"), default=None,
                   help="dual angle ranges [T1,T2] and [T3,T4]")
    m.add_argument("--no-subpixel", action="store_true")
    m.add_argument("--bitwise-not", action="store_true")
    m.add_argument("--fast-mode", action="store_true",
                   help="stop pyramid descent at layer 1")
    m.add_argument("--compute-dtype", choices=["bf16", "f32", "int8"],
                   default=None)
    m.add_argument("--roi", type=int, nargs=4, metavar=("X", "Y", "W", "H"),
                   default=None, help="learn from this template sub-rect")
    m.add_argument("--no-settings", action="store_true",
                   help="ignore and don't update the settings file")
    m.add_argument("--json", action="store_true", help="JSON output")
    m.add_argument("--lang", default=None, help="output language (a "
                   "section name in --lang-file; the reference's "
                   "MatchTool.Lang mechanism, MatchToolDlg.cpp:618-709)")
    m.add_argument("--lang-file", default=None,
                   help="MatchTool-format .Lang INI path")
    m.add_argument("--output-image", help="write annotated overlay image")
    m.add_argument("--output-roi", help="directory to dump matched ROIs")
    m.add_argument("--pattern-out", help="save learned pattern (.npz)")

    st = sub.add_parser("settings", help="show or clear persisted settings "
                        "(QSettings analogue)")
    st.add_argument("--clear", action="store_true")

    o = sub.add_parser("orb", help="ORB feature matching (secondary path)")
    o.add_argument("-s", "--source", required=True)
    o.add_argument("-t", "--template", required=True)
    o.add_argument("--max-features", type=int, default=500)
    o.add_argument("--max-good-matches", type=int, default=150)
    o.add_argument("--ransac-threshold", type=float, default=2.0)
    o.add_argument("--json", action="store_true")
    o.add_argument("--output-image", help="write side-by-side match "
                   "visualization (drawMatches equivalent)")

    ae = sub.add_parser("aot-export", help="export a match pipeline to a "
                        "pack file (deployment prewarm: fresh processes "
                        "skip learning and, with --include-executables, "
                        "the kernel build)")
    ae.add_argument("-t", "--template", required=True)
    ae.add_argument("-o", "--out", required=True, help="pack path (.npz)")
    ae.add_argument("--source-shape", type=int, nargs=2, required=True,
                    metavar=("H", "W"), help="inspection frame shape")
    ae.add_argument("--batch-sizes", type=int, nargs="*", default=[],
                    help="also export match_many programs for these "
                    "batch buckets")
    ae.add_argument("--max-pos", type=int, default=70)
    ae.add_argument("--max-overlap", type=float, default=0.1)
    ae.add_argument("--score", type=float, default=0.7)
    ae.add_argument("--tolerance-angle", type=float, default=180.0)
    ae.add_argument("--min-reduce-area", type=int, default=256)
    ae.add_argument("--roi", type=int, nargs=4, metavar=("X", "Y", "W", "H"),
                    default=None)
    ae.add_argument("--include-executables", action="store_true",
                    help="bundle the shared libraries the path loads on "
                    "--device (built first if needed), so a fresh host "
                    "with this package runs neither nvcc nor g++")

    am = sub.add_parser("aot-match", help="match using an exported pack")
    am.add_argument("-p", "--pack", required=True)
    am.add_argument("-s", "--source", required=True)
    am.add_argument("--json", action="store_true")

    oc = sub.add_parser("ocr", help="multi-template glyph matching: learn "
                        "a glyph directory, read the string in a scene "
                        "(the reference's 36-glyph M12 demo, "
                        "MatchToolDlg.cpp:714-771)")
    oc.add_argument("--glyphs-dir", required=True,
                    help="directory of glyph images (file stem = label)")
    oc.add_argument("-s", "--source", required=True, help="scene image")
    oc.add_argument("--score", type=float, default=0.85)
    oc.add_argument("--max-pos", type=int, default=8)
    oc.add_argument("--tolerance-angle", type=float, default=0.0)
    oc.add_argument("--max-overlap", type=float, default=0.4)
    oc.add_argument("--min-reduce-area", type=int, default=256)
    oc.add_argument("--per-glyph", action="store_true",
                    help="run the pipeline once per glyph (the reference's "
                    "loop structure) instead of the batched shape groups")
    oc.add_argument("--cross-nms", action="store_true",
                    help="suppress overlapping detections across glyphs")
    oc.add_argument("--json", action="store_true", dest="as_json")

    w = sub.add_parser("watch", help="live inspection: poll a directory "
                       "for new images, or stream from a camera/video "
                       "(the reference's -c/--camera mode, src/main.cpp:29)")
    w.add_argument("-t", "--template", required=True)
    grp = w.add_mutually_exclusive_group(required=True)
    grp.add_argument("--directory", default=None)
    grp.add_argument("-c", "--camera", default=None,
                     help="V4L2 device index, video file, or RTSP/GStreamer"
                     " URL (threaded latest-frame grabber; slow matches "
                     "drop frames instead of back-pressuring)")
    w.add_argument("--every-frame", action="store_true",
                   help="with --camera: process every frame instead of "
                   "latest-only (file replay mode)")
    w.add_argument("--exposure", type=float, default=None,
                   help="with --camera: exposure (cv2 CAP_PROP_EXPOSURE "
                   "passthrough; dvpSetExposure analogue)")
    w.add_argument("--gain", type=float, default=None,
                   help="with --camera: analog gain (CAP_PROP_GAIN; "
                   "dvpSetAnalogGain analogue)")
    w.add_argument("--trigger", action="store_true",
                   help="with --camera: software-trigger mode — fire one "
                   "capture per match loop instead of free-running "
                   "(dvpSetTriggerSource/dvpTriggerFire analogue)")
    w.add_argument("--out", default=None, help="JSONL results path")
    w.add_argument("--interval", type=float, default=0.5)
    w.add_argument("--max-frames", type=int, default=0,
                   help="stop after N frames (0 = forever)")
    w.add_argument("--score", type=float, default=0.7)
    w.add_argument("--max-pos", type=int, default=10)
    w.add_argument("--tolerance-angle", type=float, default=180.0)
    return p


_UI_DEFAULTS = dict(max_pos=70, max_overlap=0.1, score=0.7,
                    tolerance_angle=180.0, min_reduce_area=256,
                    compute_dtype="bf16")


def _cmd_match(args, dev) -> int:
    import numpy as np
    from . import MatchConfig, learn_pattern, match
    from .utils.imageio import load_gray, save_gray
    from .utils.settings import load_settings, save_settings

    # Parameter precedence: explicit flag > saved settings > UI defaults
    # (loadSettings, src/MatchToolDialog.cpp:495-527).
    saved = {} if args.no_settings else load_settings()

    def pick(key):
        v = getattr(args, key)
        return v if v is not None else saved.get(key, _UI_DEFAULTS[key])

    source = args.source or saved.get("last_source")
    template = args.template or saved.get("last_template")
    if not source or not template:
        print("error: --source/--template required (no saved last paths)",
              file=sys.stderr)
        return 2

    src = load_gray(source)
    tpl = load_gray(template)
    cfg = MatchConfig(
        max_pos=pick("max_pos"), max_overlap=pick("max_overlap"),
        score=pick("score"), tolerance_angle=pick("tolerance_angle"),
        min_reduce_area=pick("min_reduce_area"),
        tolerance_ranges=(tuple(args.tolerance_ranges)
                          if args.tolerance_ranges else None),
        use_subpixel=not args.no_subpixel, bitwise_not=args.bitwise_not,
        fast_mode=args.fast_mode, compute_dtype=pick("compute_dtype"))

    if not args.no_settings:
        # Persist params + last paths (saveSettings,
        # src/MatchToolDialog.cpp:528-561).
        save_settings(dict(
            max_pos=cfg.max_pos, max_overlap=cfg.max_overlap,
            score=cfg.score, tolerance_angle=cfg.tolerance_angle,
            min_reduce_area=cfg.min_reduce_area,
            use_subpixel=cfg.use_subpixel, bitwise_not=cfg.bitwise_not,
            fast_mode=cfg.fast_mode, compute_dtype=cfg.compute_dtype,
            last_source=source, last_template=template))

    pattern = learn_pattern(tpl, cfg.min_reduce_area,
                            roi=tuple(args.roi) if args.roi else None,
                            device=dev)
    if args.pattern_out:
        pattern.save(args.pattern_out)
    t0 = time.perf_counter()
    results = match(src, pattern, cfg, device=dev)
    dt = (time.perf_counter() - t0) * 1000

    if args.json:
        print(json.dumps({
            "execution_ms": round(dt, 2),
            "count": len(results),
            "matches": [{
                "index": i, "score": r.score, "angle": r.angle,
                "pos_x": r.pos_x, "pos_y": r.pos_y,
                "corners": [list(r.lt), list(r.rt), list(r.rb), list(r.lb)],
            } for i, r in enumerate(results)],
        }))
    else:
        from .utils.i18n import Translator
        try:
            tr = Translator(args.lang, args.lang_file).t
        except ValueError as e:
            # Usage error (e.g. --lang without --lang-file): a clear
            # message, not a traceback.
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"{tr('ExecutionTime')}: {dt:.1f} ms "
              f"(includes kernel loading on first run)")
        print(f"{tr('TotalNumber')}: {len(results)}")
        print(f"{tr('Index'):>5} {tr('Score'):>8} {tr('Angle(deg)'):>10} "
              f"{tr('PosX'):>10} {tr('PosY'):>10}")
        for i, r in enumerate(results):
            print(f"{i:>5} {r.score:>8.3f} {r.angle:>10.3f} "
                  f"{r.pos_x:>10.3f} {r.pos_y:>10.3f}")

    if args.output_image:
        import cv2
        vis = cv2.cvtColor(src, cv2.COLOR_GRAY2BGR)
        for i, r in enumerate(results):
            pts = np.array([r.lt, r.rt, r.rb, r.lb], np.int32)
            cv2.polylines(vis, [pts], True, (0, 255, 0), 2)
            cv2.circle(vis, (int(r.pos_x), int(r.pos_y)), 3, (0, 0, 255), -1)
            cv2.putText(vis, str(i), (int(r.lt[0]), int(r.lt[1]) - 4),
                        cv2.FONT_HERSHEY_PLAIN, 1.2, (0, 255, 0), 1)
            # Marked pattern regions projected onto the match
            # (drawUserPolygonOnResults, src/MatchToolDialog.cpp:1444-1478).
            for reg in r.regions:
                cv2.polylines(vis, [reg.astype(np.int32)], True,
                              (255, 100, 0), 2)
        cv2.imwrite(args.output_image, vis)

    if args.output_roi:
        import os
        os.makedirs(args.output_roi, exist_ok=True)
        for i, r in enumerate(results):
            xs = [r.lt[0], r.rt[0], r.rb[0], r.lb[0]]
            ys = [r.lt[1], r.rt[1], r.rb[1], r.lb[1]]
            x0, x1 = max(0, int(min(xs))), min(src.shape[1], int(max(xs)) + 1)
            y0, y1 = max(0, int(min(ys))), min(src.shape[0], int(max(ys)) + 1)
            if x1 > x0 and y1 > y0:
                save_gray(f"{args.output_roi}/roi{i}.bmp", src[y0:y1, x0:x1])
    return 0


def _cmd_orb(args, dev) -> int:
    from .models.orb import ORBConfig, orb_match
    from .utils.imageio import load_gray

    src = load_gray(args.source)
    tpl = load_gray(args.template)
    cfg = ORBConfig(max_features=args.max_features,
                    max_good_matches=args.max_good_matches,
                    ransac_threshold=args.ransac_threshold)
    t0 = time.perf_counter()
    res = orb_match(src, tpl, cfg, device=dev)
    dt = (time.perf_counter() - t0) * 1000
    out = {
        "execution_ms": round(dt, 2),
        "is_matched": res.is_matched,
        "num_inliers": res.num_inliers,
        "num_good_matches": res.num_good_matches,
        "avg_pixel_shift": res.avg_pixel_shift,
        "homography": (res.homography.tolist()
                       if res.homography is not None else None),
        "corners": (res.corners.tolist() if res.corners is not None else None),
    }
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")

    if args.output_image and res.is_matched:
        # Side-by-side visualization like getMatchResultImage
        # (ORBFeatureMatcher.cpp:260-327).
        import cv2
        import numpy as np
        h = max(src.shape[0], tpl.shape[0])
        canvas = np.zeros((h, src.shape[1] + tpl.shape[1], 3), np.uint8)
        canvas[:src.shape[0], :src.shape[1]] = cv2.cvtColor(
            src, cv2.COLOR_GRAY2BGR)
        canvas[:tpl.shape[0], src.shape[1]:] = cv2.cvtColor(
            tpl, cv2.COLOR_GRAY2BGR)
        off = src.shape[1]
        if res.src_pts is not None:
            for sp, tp, ok in zip(res.src_pts, res.dst_pts, res.inlier_mask):
                color = (0, 255, 0) if ok else (80, 80, 200)
                cv2.line(canvas, (int(sp[0]), int(sp[1])),
                         (int(tp[0]) + off, int(tp[1])), color, 1)
        if res.corners is not None:
            c = res.corners.astype(int)
            for i in range(4):
                cv2.line(canvas, tuple(c[i]), tuple(c[(i + 1) % 4]),
                         (0, 255, 255), 2)
        cv2.imwrite(args.output_image, canvas)
    return 0


def _cmd_aot_export(args, dev) -> int:
    from . import MatchConfig, export_match_pack, learn_pattern
    from .utils.imageio import load_gray

    tpl = load_gray(args.template)
    cfg = MatchConfig(max_pos=args.max_pos, max_overlap=args.max_overlap,
                      score=args.score, tolerance_angle=args.tolerance_angle,
                      min_reduce_area=args.min_reduce_area)
    pattern = learn_pattern(tpl, cfg.min_reduce_area,
                            roi=tuple(args.roi) if args.roi else None,
                            device=dev)
    t0 = time.perf_counter()
    timings = export_match_pack(args.out, pattern, cfg,
                                tuple(args.source_shape),
                                batch_sizes=args.batch_sizes,
                                include_executables=args.include_executables,
                                device=dev)
    dt = time.perf_counter() - t0
    print(f"exported {args.out} in {dt:.1f}s "
          f"({', '.join(f'{k} {v:.1f}s' for k, v in timings.items())})")
    return 0


def _cmd_aot_match(args, dev) -> int:
    from . import AotMatcher
    from .utils.imageio import load_gray

    # Load first: it installs the pack's native library, which decodes a
    # .bmp source.
    m = AotMatcher.load(args.pack, device=dev)
    src = load_gray(args.source)
    t0 = time.perf_counter()
    results = m.match(src)
    dt = (time.perf_counter() - t0) * 1000
    if args.json:
        print(json.dumps({
            "execution_ms": round(dt, 2), "count": len(results),
            "matches": [{
                "index": i, "score": r.score, "angle": r.angle,
                "pos_x": r.pos_x, "pos_y": r.pos_y,
            } for i, r in enumerate(results)],
        }))
    else:
        print(f"Execution time: {dt:.1f} ms (no learning; no kernel build "
              f"when the pack bundles its libraries)")
        print(f"Total number: {len(results)}")
        for i, r in enumerate(results):
            print(f"{i:>5} {r.score:>8.3f} {r.angle:>10.3f} "
                  f"{r.pos_x:>10.3f} {r.pos_y:>10.3f}")
    return 0


def _cmd_ocr(args, dev) -> int:
    from .config import MatchConfig
    from .models.multi_template import MultiTemplateMatcher, read_string
    from .utils.imageio import load_gray

    cfg = MatchConfig(max_pos=args.max_pos, score=args.score,
                      tolerance_angle=args.tolerance_angle,
                      max_overlap=args.max_overlap,
                      min_reduce_area=args.min_reduce_area)
    m = MultiTemplateMatcher(cfg, device=dev)
    m.learn_glyph_dir(args.glyphs_dir)
    if not m.patterns:
        print(f"no glyph images found in {args.glyphs_dir}",
              file=sys.stderr)
        return 2
    scene = load_gray(args.source)
    t0 = time.perf_counter()
    matches = m.match_all(scene, cross_nms=args.cross_nms,
                          batched=not args.per_glyph)
    dt = (time.perf_counter() - t0) * 1000
    text = read_string(matches, cfg.score)
    if args.as_json:
        print(json.dumps({
            "text": text, "time_ms": dt, "glyphs": len(m.patterns),
            "matches": [{
                "label": mm.label, "score": mm.result.score,
                "angle": mm.result.angle, "pos_x": mm.result.pos_x,
                "pos_y": mm.result.pos_y,
            } for mm in matches],
        }))
    else:
        print(f"Read: {text}")
        print(f"Time: {dt:.1f} ms ({len(m.patterns)} glyph patterns, "
              f"includes kernel loading on first run)")
        print(f"{'Label':>6} {'Score':>8} {'Angle':>8} {'PosX':>10} "
              f"{'PosY':>10}")
        for mm in matches:
            r = mm.result
            print(f"{mm.label:>6} {r.score:>8.3f} {r.angle:>8.3f} "
                  f"{r.pos_x:>10.3f} {r.pos_y:>10.3f}")
    return 0


def _cmd_watch(args, dev) -> int:
    """Poll a directory for new images, match each as it appears — the
    headless analogue of the camera live path (imageCaptured ->
    onCameraImageCaptured, src/MatchToolDialog.cpp:1557). With --camera,
    stream frames from a device/file/URL through the threaded
    latest-frame grabber instead (CameraPreviewDialog.cpp:84-131)."""
    import os
    import glob
    from . import MatchConfig, learn_pattern, match
    from .utils.imageio import load_gray
    from .utils.serialization import append_jsonl, match_results_to_dict

    tpl = load_gray(args.template)
    cfg = MatchConfig(max_pos=args.max_pos, score=args.score,
                      tolerance_angle=args.tolerance_angle)
    pattern = learn_pattern(tpl, cfg.min_reduce_area, device=dev)

    if args.camera is not None:
        from .utils.imageio import ensure_gray
        from .utils.settings import save_settings
        from .utils.sources import VideoCaptureSource
        src_id = int(args.camera) if args.camera.isdigit() else args.camera
        n = 0
        with VideoCaptureSource(src_id, max_frames=args.max_frames,
                                latest_only=not args.every_frame,
                                exposure=args.exposure,
                                gain=args.gain) as cam:
            # Persist the camera selection + parameters, like the
            # reference's saveCameraSettings QSettings store
            # (src/CameraPreviewDialog.cpp:784-812).
            save_settings({"last_camera": str(args.camera),
                           "camera_exposure": args.exposure,
                           "camera_gain": args.gain})

            def frame_iter():
                if args.trigger:
                    # Software-trigger mode: one capture per loop
                    # (dvpTriggerFire per inspection cycle).
                    cam.set_trigger(True)
                    while not (args.max_frames
                               and cam.frame_count >= args.max_frames):
                        try:
                            yield cam.trigger_fire()
                        except RuntimeError:
                            break         # stream ended / fire failed
                else:
                    yield from cam.frames()

            for frame in frame_iter():
                if frame.ndim == 3:
                    frame = ensure_gray(frame)
                t0 = time.perf_counter()
                res = match(frame, pattern, cfg, device=dev)
                ms = (time.perf_counter() - t0) * 1000
                rec = {"frame": n, **match_results_to_dict(res, ms)}
                print(f"frame {n}: {len(res)} matches, {ms:.0f} ms")
                if args.out:
                    append_jsonl(args.out, rec)
                n += 1
                if args.max_frames and n >= args.max_frames:
                    break
        return 0
    seen = set()
    n = 0
    while True:
        paths = sorted(
            p for pat in ("*.bmp", "*.jpg", "*.png")
            for p in glob.glob(os.path.join(args.directory, pat)))
        for p in paths:
            if p in seen:
                continue
            seen.add(p)
            try:
                src = load_gray(p)
            except (ValueError, FileNotFoundError):
                continue
            t0 = time.perf_counter()
            res = match(src, pattern, cfg, device=dev)
            ms = (time.perf_counter() - t0) * 1000
            rec = {"path": p, **match_results_to_dict(res, ms)}
            print(f"{os.path.basename(p)}: {len(res)} matches, {ms:.0f} ms")
            if args.out:
                append_jsonl(args.out, rec)
            n += 1
            if args.max_frames and n >= args.max_frames:
                return 0
        if args.max_frames and n >= args.max_frames:
            return 0
        time.sleep(args.interval)


_COMMANDS = {"match": _cmd_match, "orb": _cmd_orb,
             "aot-export": _cmd_aot_export, "aot-match": _cmd_aot_match,
             "ocr": _cmd_ocr, "watch": _cmd_watch}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "settings":
        from .utils.settings import (clear_settings, load_settings,
                                     settings_path)
        if args.clear:
            clear_settings()
            print(f"cleared {settings_path()}")
        else:
            print(json.dumps({"path": settings_path(),
                              "settings": load_settings()}, indent=1))
        return 0
    from .utils.device import resolve_device
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return _COMMANDS[args.command](args, dev)


if __name__ == "__main__":
    sys.exit(main())
