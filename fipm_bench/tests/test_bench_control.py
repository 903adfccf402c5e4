"""The control of `correct`: the reference with its NCC scores kept in
bfloat16, put in the program's place, fails the limits that the port's
answers pass."""

import pytest
import torch

from fipm_bench import control, run


@pytest.mark.parametrize("workload", ["tiny.one", "tiny_washers.one"])
def test_control_fails_where_the_program_passes(tiny_root, workload):
    cell = run.find_cell(str(tiny_root), workload,
                         str(tiny_root / "fipm_bench"))
    got = {kind: v for kind, _, v in
           control.readings(cell, 31, "cpu", ("bf16_scores",))}
    assert got["program"]["correct"]
    assert not got["bf16_scores"]["correct"]
    assert got["bf16_scores"]["numbers"]["score_gap"] > \
        cell.config["limits"]["score_gap"]
    assert got["program"]["numbers"]["score_gap"] == 0.0


def test_bf16_scores_round_the_score_maps():
    from fipm_bench.reference import ops
    canv = torch.randint(0, 256, (1, 20, 20)).float()
    templ = torch.randint(0, 256, (5, 5)).float()
    stats = (float(templ.double().mean()),
             float(templ.double().std(unbiased=False)) * 5.0, 1 / 25.0,
             False)
    a = ops.ncc_map(canv, templ, stats)
    b = ops.ncc_map(canv, templ, stats, torch.bfloat16)
    assert torch.equal(b, a.to(torch.bfloat16).float())
    assert not torch.equal(a, b)
