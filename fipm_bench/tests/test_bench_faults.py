"""Runs of the harness on the CPU, past its look for a card, with the
timed path broken underneath: each fault that these cells can have makes
`correct` come out false. (A matcher has no training step and these cells
no exchange between chips; a stale answer stands for a step that returns
its state unchanged.)"""

import numpy as np
import pytest

import fastest_image_pattern_matching_tpu_torch as fipm
from fastest_image_pattern_matching_tpu_torch.models import (batch,
                                                             template_matcher)

from fipm_bench import run


def run_tiny(root, workload):
    cell = run.find_cell(str(root), workload, str(root / "fipm_bench"))
    result, checks = run.run_cell(cell, 4242, 0.3, False, "cpu")
    return result, checks


def altered_pack(monkeypatch, column, delta):
    real = template_matcher._pack_result

    def pack(out, max_pos):
        packed = real(out, max_pos).clone()
        packed[:, 0, column] += delta
        return packed
    monkeypatch.setattr(template_matcher, "_pack_result", pack)


@pytest.mark.parametrize("column,delta,number", [
    (0, 1e-3, "score_gap"), (2, 0.25, "centre_gap_px"),
    (1, 0.05, "angle_gap_deg")])
@pytest.mark.parametrize("workload", ["tiny.one", "tiny.batch8"])
def test_an_answer_altered_where_it_is_made(tiny_root, monkeypatch,
                                            workload, column, delta,
                                            number):
    altered_pack(monkeypatch, column, delta)
    result, checks = run_tiny(tiny_root, workload)
    assert not result["correct"] and result["failed"] > 0
    assert checks[number]["value"] > checks[number]["limit"]


@pytest.mark.parametrize("column,delta,number", [
    (0, 1e-3, "score_gap"), (2, 1e-3, "centre_gap_px"),
    (1, 1e-3, "angle_gap_deg")])
def test_a_washer_answer_altered(tiny_root, monkeypatch, column, delta,
                                number):
    """At tolerance 0 the washers' centres and angles are exact (limit
    0): a thousandth of a pixel or a degree fails."""
    altered_pack(monkeypatch, column, delta)
    result, checks = run_tiny(tiny_root, "tiny_washers.one")
    assert not result["correct"]
    assert checks[number]["value"] > checks[number]["limit"]


def test_half_the_batch_left_out(tiny_root, monkeypatch):
    real = batch._dispatch

    def half(st, args, cfg, nms_cap=None):
        n = args[0].shape[0]
        out = real(st, (args[0][:n // 2],) + tuple(args[1:]), cfg, nms_cap)
        return np.concatenate([out, out])[:n]
    monkeypatch.setattr(batch, "_dispatch", half)
    for workload in ("tiny.batch8", "tiny.png8"):
        result, checks = run_tiny(tiny_root, workload)
        assert not result["correct"], workload


def test_a_stale_answer(tiny_root, monkeypatch):
    real = fipm.match
    first = {}

    def stale(src, pattern, cfg=None, device=None):
        if "res" not in first:
            first["res"] = real(src, pattern, cfg, device=device)
        return first["res"]
    monkeypatch.setattr(fipm, "match", stale)
    result, checks = run_tiny(tiny_root, "tiny.one")
    assert not result["correct"]
