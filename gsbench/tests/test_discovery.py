"""A configuration, a cell and a per-layer metric are added as new files
and new entries of BENCHMARK.json; no file of the benchmark is edited."""

import hashlib
import json
import time

import torch

from gsbench import harness, run
from gsbench.tests.tiny import tiny_copy

METRIC = '''"""Frames of a traced window (a test metric)."""

LAYER = "render"
UNIT = "count"


def read(ev):
    return ev.get("units")
'''


def digests(base):
    return {p.relative_to(base): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(base.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    base = tiny_copy(tmp_path)
    before = digests(base)
    cfg = harness.load_config("mip360_garden_4k", base)
    cfg.update(name="garden_small", n_live=300, capacity=512)
    (base / "configs" / "garden_small.json").write_text(json.dumps(cfg))
    wl = harness.load_workload("garden4k-render", base)
    wl.update(name="small-render", config="garden_small")
    (base / "workloads" / "small-render.json").write_text(json.dumps(wl))
    (base / "metrics" / "frames_traced.py").write_text(METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="garden_small",
                                 file="gsbench/configs/garden_small.json"))
    bench["workloads"].append({
        "name": "small-render", "config": "garden_small",
        "traffic": "viewer_orbit", "chips": 1, "why": "a test viewer"})
    bench["end_to_end"].append({
        "name": "render_ms_p95", "unit": "ms", "better": "lower",
        "bound": 0.1, "source": "host_clock", "workloads": ["small-render"]})
    bench["per_layer"].append({
        "name": "frames_traced", "unit": "count", "better": "higher",
        "source": "device_trace", "layer": "render",
        "moves": "render_ms_p95", "workloads": ["small-render"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    assert harness.load_config("garden_small", base)["n_live"] == 300
    assert harness.load_workload("small-render", base)["config"] == \
        "garden_small"
    names = [m["name"] for m in harness.cell_metrics(
        harness.load_benchmark(base), "small-render", "per_layer")]
    assert "frames_traced" in names
    assert harness.load_metric("frames_traced", base).read(
        {"units": 7}) == 7
    res = run.run_cell("small-render", 5, 2.0, False, torch.device("cpu"),
                       time.perf_counter(), base=base)
    assert res["correct"] and "render_ms_p95" in res["metrics"]
    after = digests(base)
    assert all(after[p] == d for p, d in before.items())
