"""A camera stream through the port's every-frame VideoCaptureSource
into one inspect_corpus generator for the whole run, batch_size =
frames_per_call: the grabber thread reads and converts each BGR24 frame
to grey beside the match, at most the traffic's queue_frames (16) frames
ahead; a call takes the stream's next frames_per_call reports. Set-up's
warm-up is the stream's first batch. A port without the bounded
every-frame FIFO cannot run this traffic, and its source raises at once.

The capture device is in-process: its read() returns a fresh copy of
the pool's next frame, cycling through the pool in order, and never
waits (a recorded stream, or a camera faster than the matcher)."""

import itertools


class Camera:
    """Stands in for cv2.VideoCapture over the pool's BGR24 frames."""

    def __init__(self, pool):
        self.pool = pool
        self.reads = 0
        self.props = {}

    def isOpened(self):
        return True

    def read(self):
        frame = self.pool[self.reads % len(self.pool)].copy()
        self.reads += 1
        return True, frame

    def set(self, prop, value):
        self.props[prop] = value
        return True

    def get(self, prop):
        return self.props.get(prop, 0.0)

    def release(self):
        pass


def prepare(ctx):
    from fastest_image_pattern_matching_tpu_torch.utils.sources import (
        VideoCaptureSource)
    per, n = ctx.traffic["frames_per_call"], len(ctx.pool)
    cam = VideoCaptureSource(0, latest_only=False,
                             queue_frames=ctx.traffic["queue_frames"],
                             cap_factory=lambda _: Camera(ctx.pool))
    reports = ctx.fipm.inspect_corpus(
        cam.frames(), ctx.learned.pattern, ctx.learned.cfg, batch_size=per,
        device=ctx.device)

    def call(k):
        return [(r.index % n, ctx.rows(r.results))
                for r in itertools.islice(reports, per)]
    return call
