"""BENCHMARK.json against the benchmark's contract: its keys, the name,
unit and text rules, the metrics each cell reports, the bounds and the
time a full check takes."""

import json
import os
import re

import pytest

from fipm_bench import run

ROOT = os.path.dirname(run.BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(man["command"]) <= 32
    assert all(text_ok(w) for w in man["command"])
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_their_keys(man, section):
    for e in man[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]


def test_names_units_and_texts(man):
    names = [e["name"] for s in KEYS for e in man[s]]
    assert all(NAME.match(n) for n in names)
    for s in KEYS:
        assert len({e["name"] for e in man[s]}) == len(man[s])
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert text_ok(w["why"]) and w["chips"] in (1, 4)
    for c in man["configs"]:
        assert text_ok(c["why"]) and text_ok(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in man["per_layer"]:
        assert text_ok(m["layer"])


def test_configs_files_and_use(man):
    files = [c["file"] for c in man["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p.rstrip("/") + "/")
                   for p in man["paths"])
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
        assert set(conf["limits"]) == {"count_diff", "score_gap",
                                       "centre_gap_px", "angle_gap_deg"}
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)


def test_bounds(man):
    by = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in by and by["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_enough(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for w in man["workloads"]:
        cell = run.find_cell(ROOT, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        cells = m.get("workloads", [w["name"] for w in man["workloads"]])
        for c in cells:
            reported = {x["name"] for x in run.find_cell(ROOT, c).end_to_end}
            assert m["moves"] in reported, (m["name"], c)


def test_a_full_check_fits():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        rs = json.load(f)["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
