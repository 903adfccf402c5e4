"""A folder of image files through the port's inspect_corpus over a
FolderSource, batch_size = frames_per_call: set-up writes every pool
frame as a file of the traffic's format (scenes/<format>.py) under the
run's scratch directory; a call reads and matches the whole folder. Each
next() of the source (file read and decode) is recorded as a "decode"
span, and as a profiler range of that name for the traced window's idle
gaps."""

import concurrent.futures
import os
import time


def prepare(ctx):
    spec = ctx.traffic["file"]
    writer = ctx.writer(spec["format"])
    folder = os.path.join(ctx.workdir, "frames")
    os.makedirs(folder)
    paths = [os.path.join(folder, f"frame_{i:04d}{writer.SUFFIX}")
             for i in range(len(ctx.pool))]
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        for f in [ex.submit(writer.write, p, img, spec)
                  for p, img in zip(paths, ctx.pool)]:
            f.result()
    from torch.profiler import record_function
    from fastest_image_pattern_matching_tpu_torch.utils.sources import (
        FolderSource)

    def frames():
        src = iter(FolderSource(folder))
        while True:
            t0 = time.perf_counter()
            try:
                with record_function("fipm_bench.decode"):
                    img = next(src)
            except StopIteration:
                return
            ctx.spans.append(("decode", t0, time.perf_counter()))
            yield img

    def call(k):
        reports = ctx.fipm.inspect_corpus(
            frames(), ctx.learned.pattern, ctx.learned.cfg,
            batch_size=ctx.traffic["frames_per_call"], device=ctx.device)
        return [(r.index, ctx.rows(r.results)) for r in reports]
    return call
