"""BENCHMARK.json against the contract it is checked by, and against the
files it names."""

import json
import re

import pytest

from gsbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "gsbench/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51
    n_cells = 24
    total = ((2 + 14 * n_cells) * (BENCH["run_seconds"] + 60)
             + n_cells * 2 * 90 + 1200)
    assert total <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    seen = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            assert NAME.match(e["name"]), e["name"]
            assert (kind, e["name"]) not in seen
            seen.add((kind, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert one_line(w["why"]) and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configs_name_their_files():
    for c in BENCH["configs"]:
        assert c["file"].startswith("gsbench/configs/")
        cfg = json.loads((harness.repo_root() / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert one_line(c["source"]) and one_line(c["why"])
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_cells_and_their_metrics():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        wl = harness.load_workload(w["name"])
        assert wl["config"] == w["config"]
        got = {m["name"] for m in harness.cell_metrics(BENCH, w["name"],
                                                       "end_to_end")}
        assert "setup_s" in got and len(got) >= 2
        layer = harness.cell_metrics(BENCH, w["name"], "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in got, (w["name"], m["name"])


def test_per_layer_entries_match_their_readers():
    layers = {}
    for m in BENCH["per_layer"]:
        assert "workloads" in m and m["workloads"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        r = harness.load_metric(m["name"])
        assert (r.LAYER, r.UNIT) == (m["layer"], m["unit"])
        assert one_line(m["layer"])
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["name"].endswith("roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    # one layer, one spelling
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_has_limits(cell):
    wl = harness.load_workload(cell)
    assert wl["limits"] and all(v >= 0 for v in wl["limits"].values())


def test_cell_files_name_their_traffic():
    for w in BENCH["workloads"]:
        wl = harness.load_workload(w["name"])
        assert (wl["name"], wl["traffic"]) == (w["name"], w["traffic"])
