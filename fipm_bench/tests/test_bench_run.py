"""Whole runs of the harness on the CPU at tiny sizes: the port's
answers judged correct against the reference, and the metrics of an
untraced run read."""

import pytest

from fipm_bench import run


@pytest.mark.parametrize("workload", ["tiny.one", "tiny_washers.one",
                                      "tiny.batch8", "tiny.png8"])
def test_tiny_cell_is_correct(tiny_root, workload):
    cell = run.find_cell(str(tiny_root), workload,
                         str(tiny_root / "fipm_bench"))
    result, checks = run.run_cell(cell, 2**31 + 7, 0.5, False, "cpu")
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 1
    names = {m["name"] for m in cell.end_to_end}
    assert set(result["metrics"]) == names
    assert list(result) [-1] == "checks"
    for m in result["metrics"].values():
        assert m["value"] > 0
