"""The roofline arithmetic against hand counts, and the readers that
turn a traced window's records into per-layer metrics."""

import pytest
import torch

from fipm_bench import readers, roofline


def test_identity_warp_bound_by_hand():
    src = torch.zeros(4, 4)
    maps = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])
    # A 2x3 output at the identity reads rows 0-2 and columns 0-3 through
    # its bilinear taps (the x + 1 and y + 1 taps included): 12 pixels.
    assert roofline.warp_source_pixels((4, 4), maps, (2, 3)) == 12
    n_bytes = 4 * (12 + 6 + 6)
    want = max(n_bytes / 3.35e12, 21 * 6 / 67e12)
    assert roofline.warp_bound_s(src, maps, (2, 3)) == pytest.approx(
        want, rel=1e-12)


def test_warp_outside_the_source_reads_nothing():
    maps = torch.tensor([[[1.0, 0.0, 100.0], [0.0, 1.0, 0.0]]])
    assert roofline.warp_source_pixels((4, 4), maps, (2, 3)) == 0


def test_correlation_bound_by_hand():
    canv = torch.arange(64.0).reshape(1, 8, 8) - 32.0
    templ = torch.ones(3, 3)
    # 6x6 outputs of 9 multiply-adds; bytes of the canvas, template, map.
    n_bytes = 4 * (64 + 9 + 36)
    ops = 2 * 36 * 9
    assert roofline.corr_bound_s(canv, templ) == pytest.approx(
        max(n_bytes / 3.35e12, ops / 1979e12), rel=1e-12)
    # Fractional inputs go at the f32 rate.
    assert roofline.corr_bound_s(canv + 0.5, templ) == pytest.approx(
        max(n_bytes / 3.35e12, ops / 67e12), rel=1e-12)


def test_work_bounds_sums_by_kind():
    src = torch.zeros(4, 4)
    maps = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])
    canv = torch.zeros(1, 8, 8)
    templ = torch.ones(3, 3)
    warp = roofline.warp_bound_s(src, maps, (2, 3))
    work = [("warp", warp), ("warp", warp),
            ("corr", roofline.corr_bound_s(canv, templ))]
    got = roofline.work_bounds(work)
    assert set(got) == {"warp", "corr"}
    assert got["warp"] == pytest.approx(
        2 * roofline.warp_bound_s(src, maps, (2, 3)))
    assert got["corr"] == pytest.approx(roofline.corr_bound_s(canv, templ))


def test_readers_on_records():
    rec = {"frames": 4, "window_s": 2.0, "busy_s": 0.5,
           "device_events": [("k", 0.0, 1.0)] * 8,
           "device_s_by_name": {"void warp_affine_kernel(float)": 0.002,
                                "other": 1.0},
           "host_counts": {"cudaStreamSynchronize": 6,
                           "cudaMemcpyAsync": 2, "aten::add": 50},
           "work": {"warp": 0.001, "corr": 0.0},
           "spans": [("decode", 1.0, 1.2), ("decode", 2.0, 2.2),
                     ("other", 0.0, 5.0)],
           "latencies_s": [0.1, 0.2, 0.3, 0.4]}
    assert readers.device_idle_pct(rec) == pytest.approx(75.0)
    assert readers.device_ops_per_frame(rec) == 2.0
    assert readers.host_syncs_per_frame(rec) == 2.0
    assert readers.roofline_pct(rec, "warp", "warp_affine_kernel") == \
        pytest.approx(50.0)
    assert readers.roofline_pct(rec, "corr", "ccorr_valid_kernel") is None
    assert readers.span_ms_per_frame(rec, "decode") == pytest.approx(100.0)
    assert readers.frames_per_s(rec) == 2.0
    assert readers.latency_quantile_ms(rec, 50) == pytest.approx(250.0)
    assert readers.device_idle_pct({"frames": 1}) is None
