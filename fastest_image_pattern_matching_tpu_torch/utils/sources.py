"""Image acquisition sources — the port of
fastest_image_pattern_matching_tpu/utils/sources.py.

The reference's camera stack (C14: QImageAcquisition worker thread +
CameraPreviewDialog over the binary DVP vendor SDK,
src/CameraPreviewDialog.cpp:42-131, include/CameraPreviewDialog.h) is
vendor-binary-bound; the package keeps the *abstraction*: a FrameSource
protocol that a real grabber can implement, plus file/folder/synthetic
sources used by the CLI and the corpus pipeline. The native threaded
BatchLoader plays the grabber thread's role (decode on CPU threads while
the device computes).
"""

from __future__ import annotations

import abc
import collections
import glob
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np

from .profiling import count, span, traced_for, tracing


class FrameSource(abc.ABC):
    """Yields grayscale uint8 frames, like the camera's imageCaptured
    signal feeding the matcher (src/MatchToolDialog.cpp:1557)."""

    @abc.abstractmethod
    def frames(self) -> Iterator[np.ndarray]:
        ...

    def __iter__(self):
        return self.frames()


class FileSource(FrameSource):
    """A fixed list of image files, yielded in order. An all-BMP list
    decodes on n_threads native threads (native/loader.py::BatchLoader)
    when the native library can be built; any other list through
    load_gray on a pool of n_threads Python threads (zlib and the native
    decode loops release the interpreter lock), at most 2 * n_threads
    frames ahead of the consumer. A file that fails to decode raises
    where its frame would have been yielded. Each frame yielded counts
    as source.frames, each decoded on the pool also as source.pooled."""

    def __init__(self, paths: List[str], n_threads: int = 4):
        self.paths = list(paths)
        self._n_threads = n_threads

    def frames(self) -> Iterator[np.ndarray]:
        from ..native import bmp as native_bmp
        if (self.paths and all(p.lower().endswith(".bmp") for p in self.paths)
                and native_bmp.available()):
            from ..native.loader import BatchLoader
            with BatchLoader(self.paths, self._n_threads) as bl:
                for i, p in enumerate(self.paths):
                    with span("fipm.source.take"):
                        img = bl.take(i)
                        if img is not None:
                            count("source.frames")
                    if img is None:
                        raise ValueError(f"cannot decode BMP: {p}")
                    yield img
            return
        yield from self._pooled()

    def _pooled(self) -> Iterator[np.ndarray]:
        """load_gray over the paths on a thread pool, in order. The pool's
        spans record while the consuming thread's do (read at each take),
        so decode time under the profiler is summed over the workers."""
        from . import imageio
        n = max(1, self._n_threads)
        traced = [tracing()]

        def decode(path):
            with traced_for(traced[0]), span("fipm.source.decode"):
                img = imageio.load_gray(path)
                count("source.pooled")
                return img

        ex = ThreadPoolExecutor(n, thread_name_prefix="fipm-decode")
        try:
            ahead = collections.deque(
                ex.submit(decode, p) for p in self.paths[:2 * n])
            rest = iter(self.paths[2 * n:])
            while ahead:
                traced[0] = tracing()
                with span("fipm.source.take"):
                    img = ahead.popleft().result()
                    count("source.frames")
                nxt = next(rest, None)
                if nxt is not None:
                    ahead.append(ex.submit(decode, nxt))
                yield img
        finally:
            ex.shutdown(wait=True, cancel_futures=True)


class FolderSource(FileSource):
    """All images in a directory (sorted), like batch inspection runs."""

    def __init__(self, directory: str,
                 patterns=("*.bmp", "*.jpg", "*.png", "*.jpeg"),
                 n_threads: int = 4):
        paths: List[str] = []
        for pat in patterns:
            paths.extend(glob.glob(os.path.join(directory, pat)))
        super().__init__(sorted(paths), n_threads)


class VideoCaptureSource(FrameSource):
    """A real grabber over cv2.VideoCapture — V4L2 device index, video
    file, or GStreamer/RTSP URL. The concrete stand-in for the reference's
    DVP camera grabber (dvpOpenByName/dvpGetFrame + 30 ms QTimer loop on a
    QThread, src/CameraPreviewDialog.cpp:386,42-131): frames are read and
    converted to grey on a grabber thread of their own, beside the
    consumer's matching, and handed over in one of two modes:

      * latest-only (the default): a 1-deep latest-frame slot (the
        QMutex-guarded QPixmap analogue at :120), so the matcher always
        sees the freshest frame and slow matches drop frames (counted as
        source.dropped) instead of back-pressuring the camera;
      * every frame (latest_only=False): a FIFO of at most queue_frames
        frames (the camera driver's buffer queue), every frame in order
        and none dropped; when it is full the grabber waits.

    The consumer waits at most timeout_s for a frame: latest-only mode
    then ends, every-frame mode raises TimeoutError. The stream's end (a
    read() that returns no frame) ends the stream, and a read() that
    raises raises, each where its frame would have been yielded. Closing
    the generator stops and joins the grabber.

    Camera control surface (the CameraPreviewDialog parameter set,
    src/CameraPreviewDialog.cpp:310-658): scan() enumerates devices
    (dvpRefresh/dvpEnum :310-362), set_exposure/set_gain map
    dvpSetExposure (:434) / dvpSetAnalogGain (:440) onto the
    cv2.CAP_PROP_* passthrough, set_trigger + trigger_fire implement the
    software-trigger mode (dvpSetTriggerState/dvpSetTriggerSource :446-455,
    dvpTriggerFire :658): with the trigger armed the free-running grabber
    stops and each trigger_fire() captures exactly one frame on demand.
    frame_count mirrors the dvpGetFrameCount status readout (:693).

    Usage:
        with VideoCaptureSource(0) as cam:          # /dev/video0
            for frame in cam.frames():
                ...
        VideoCaptureSource("clip.avi", latest_only=False)  # every frame
        with VideoCaptureSource(0, exposure=8000, gain=2.0) as cam:
            cam.set_trigger(True)
            frame = cam.trigger_fire()              # capture-on-demand
    """

    def __init__(self, source, max_frames: int = 0, latest_only: bool = True,
                 timeout_s: float = 3.0, exposure: float = None,
                 gain: float = None, cap_factory=None,
                 queue_frames: int = 16):
        if queue_frames < 1:
            raise ValueError(f"queue_frames must be >= 1, got {queue_frames}")
        self.source = source
        self.max_frames = max_frames
        self.latest_only = latest_only
        # Every-frame mode's read-ahead: two of inspect_corpus's default
        # batches.
        self.queue_frames = queue_frames
        # Frame timeout mirrors the reference's 3 s dvpGetFrame timeout
        # (src/CameraPreviewDialog.cpp:87).
        self.timeout_s = timeout_s
        self._init_exposure = exposure
        self._init_gain = gain
        # Injection point for tests / non-cv2 grabbers; None = cv2.
        self._cap_factory = cap_factory
        self._cap = None
        self._thread = None
        self._stop = None
        self._trigger = False
        self.frame_count = 0          # frames delivered (dvpGetFrameCount)

    @staticmethod
    def scan(max_devices: int = 16, cap_factory=None):
        """Enumerate openable capture devices 0..max_devices-1 — the
        dvpRefresh/dvpEnum scan (src/CameraPreviewDialog.cpp:310-362,
        which also caps at 16). Returns the list of openable indices."""
        if cap_factory is None:
            import cv2
            cap_factory = cv2.VideoCapture
        found = []
        for i in range(max_devices):
            cap = cap_factory(i)
            try:
                if cap.isOpened():
                    found.append(i)
            finally:
                cap.release()
        return found

    def open(self):
        if self._cap is None:
            factory = self._cap_factory
            if factory is None:
                import cv2
                factory = cv2.VideoCapture
            self._cap = factory(self.source)
            if not self._cap.isOpened():
                self._cap = None
                raise RuntimeError(f"cannot open capture {self.source!r}")
            # initCameraParameters (src/CameraPreviewDialog.cpp:421-466):
            # apply the configured exposure/gain right after open.
            if self._init_exposure is not None:
                self.set_exposure(self._init_exposure)
            if self._init_gain is not None:
                self.set_gain(self._init_gain)
        return self

    # --- parameter controls (cv2 CAP_PROP passthrough) -----------------
    def _prop(self, name: str) -> int:
        import cv2
        return getattr(cv2, f"CAP_PROP_{name}")

    def set_exposure(self, value: float) -> bool:
        """dvpSetExposure (src/CameraPreviewDialog.cpp:434, :670). Returns the
        driver's accept/reject status, like dvpStatus."""
        self._require_open()
        return bool(self._cap.set(self._prop("EXPOSURE"), float(value)))

    def get_exposure(self) -> float:
        self._require_open()
        return float(self._cap.get(self._prop("EXPOSURE")))

    def set_gain(self, value: float) -> bool:
        """dvpSetAnalogGain (src/CameraPreviewDialog.cpp:440, :685)."""
        self._require_open()
        return bool(self._cap.set(self._prop("GAIN"), float(value)))

    def get_gain(self) -> float:
        self._require_open()
        return float(self._cap.get(self._prop("GAIN")))

    def set_trigger(self, enabled: bool) -> None:
        """Arm/disarm the software trigger (dvpSetTriggerState +
        TRIGGER_SOURCE_SOFTWARE, src/CameraPreviewDialog.cpp:447-458,
        628-650). Armed: the free-running grabber stops; frames are
        captured one per trigger_fire(). Disarmed: frames() streams
        free-running again."""
        self._require_open()
        self._trigger = bool(enabled)
        if enabled and self._stop is not None:
            # Stop a running free-stream grabber thread.
            self._stop.set()
            if self._thread is not None:
                self._thread.join(timeout=self.timeout_s)
                self._thread = None

    @property
    def trigger_enabled(self) -> bool:
        return self._trigger

    def trigger_fire(self):
        """Capture exactly one frame on demand (dvpTriggerFire,
        src/CameraPreviewDialog.cpp:652-661). Requires the trigger armed,
        like the reference's guard (:654). Returns a grayscale frame, or
        raises if the capture produced none."""
        self._require_open()
        if not self._trigger:
            raise RuntimeError("software trigger is not armed; call "
                               "set_trigger(True) first")
        ok, frame = self._cap.read()
        if not ok:
            raise RuntimeError("trigger fire produced no frame")
        self.frame_count += 1
        return self._to_gray(frame)

    def _require_open(self):
        if self._cap is None:
            raise RuntimeError("capture is not open (call open() or use "
                               "the context manager)")

    @staticmethod
    def _to_gray(frame):
        if frame.ndim == 3:
            from .imageio import ensure_gray
            return ensure_gray(frame)
        return frame

    def close(self):
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s)
            self._thread = None
        if self._cap is not None:
            self._cap.release()
            self._cap = None

    def __enter__(self):
        return self.open()

    def __exit__(self, *exc):
        self.close()

    def _grab(self, fifo, traced, stop):
        """The grabber thread: read each frame and convert it to grey,
        then hand it on (latest-only: replace a frame not yet taken;
        every frame: wait for room in the FIFO). The stream's end, or
        the exception of a read that raised, goes into the FIFO behind
        the frames before it. Its spans record while the consumer's do
        (traced[0], set at each take)."""
        n = 0
        while not stop.is_set():
            if not self.latest_only and self.max_frames \
                    and n >= self.max_frames:
                return
            try:
                with traced_for(traced[0]), span("fipm.source.grab"):
                    with span("fipm.source.read"):
                        ok, frame = self._cap.read()
                    if ok:
                        with span("fipm.source.grey"):
                            frame = self._to_gray(frame)
                        if self.latest_only:
                            try:
                                fifo.get_nowait()
                                count("source.dropped")
                            except queue.Empty:
                                pass
                            fifo.put_nowait(frame)
            except Exception as e:        # raised again by the consumer
                _put(fifo, e, stop)
                return
            if not ok:
                _put(fifo, _END, stop)
                return
            if not self.latest_only and not _put(fifo, frame, stop):
                return
            n += 1

    def frames(self) -> Iterator[np.ndarray]:
        if self._cap is None:
            self.open()
        if self._trigger:
            raise RuntimeError(
                "software trigger is armed — capture frames with "
                "trigger_fire(), or set_trigger(False) to free-run")
        fifo = queue.Queue(maxsize=1 if self.latest_only
                           else self.queue_frames)
        stop = self._stop = threading.Event()
        traced = [tracing()]
        self._thread = threading.Thread(
            target=self._grab, args=(fifo, traced, stop), name="fipm-grab",
            daemon=True)
        self._thread.start()
        try:
            n = 0
            while not (self.max_frames and n >= self.max_frames):
                traced[0] = tracing()
                with span("fipm.source.take"):
                    ready = not fifo.empty()
                    try:
                        item = fifo.get(timeout=self.timeout_s)
                    except queue.Empty:
                        item = None
                    if item is not None and item is not _END \
                            and not isinstance(item, Exception):
                        count("source.frames")
                        if ready:
                            count("source.ready")
                if item is None:
                    if self.latest_only:
                        break             # grabber stalled
                    raise TimeoutError(
                        f"no frame from {self.source!r} within "
                        f"{self.timeout_s} s (frame {n})")
                if item is _END:
                    break
                if isinstance(item, Exception):
                    raise item
                self.frame_count += 1
                yield item
                n += 1
        finally:
            self.close()


# What the grabber hands on after the last frame of a stream.
_END = object()


def _put(fifo, item, stop) -> bool:
    """Put item into fifo, waiting for room until stop is set; False
    when it was set first."""
    while not stop.is_set():
        try:
            fifo.put(item, timeout=0.05)
            return True
        except queue.Full:
            pass
    return False


class SyntheticSource(FrameSource):
    """Deterministic synthetic frames for soak/perf testing (the 'camera'
    of the test rig)."""

    def __init__(self, hw, n_frames: int, seed: int = 0,
                 template: Optional[np.ndarray] = None):
        self.hw = hw
        self.n = n_frames
        self.seed = seed
        self.template = template

    def frames(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        for i in range(self.n):
            f = rng.integers(0, 40, size=self.hw, dtype=np.uint8)
            if self.template is not None:
                th, tw = self.template.shape
                y = int(rng.integers(0, self.hw[0] - th))
                x = int(rng.integers(0, self.hw[1] - tw))
                f[y:y + th, x:x + tw] = self.template
            yield f
