"""The metric arithmetic on made-up inputs."""

import time

import pytest
import torch

from gsbench import counts, harness, trace
from gsbench.entries import train_step


def ev(**kw):
    base = dict(kind="train", units=4, window_s=2.0, busy_s=1.5,
                device_s=1.8, launches=400, kernel_s={})
    base.update(kw)
    return base


def test_union_of_intervals_not_a_sum():
    # two kernels overlap by 1 us, a third stands apart
    iv = [(0.0, 3.0), (2.0, 5.0), (10.0, 12.0)]
    assert trace.union_s(iv) == pytest.approx(7e-6)
    tr = trace.Trace((0.0, 20.0), [trace.Activity("k", s, e, True)
                                   for s, e in iv], [])
    assert [g[1] - g[0] for g in trace.gaps(tr)] == [8.0, 5.0]


def test_idle_share_reads_the_union():
    r = harness.load_metric("device_idle_pct.train")
    assert r.read(ev()) == pytest.approx(25.0)
    assert r.read(ev(window_s=0.0)) is None
    assert harness.load_metric("device_idle_pct.render").read(
        ev(kind="render", busy_s=0.5)) == pytest.approx(75.0)


def test_p95_over_all_frames():
    frames = [10.0] * 95 + [50.0] * 5
    assert harness.percentile(frames, 95) == pytest.approx(12.0)
    assert harness.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)


def test_rate_over_the_whole_window():
    c = train_step.Cell.__new__(train_step.Cell)
    c.state, c.i, c.dev = None, 0, torch.device("cpu")
    c.cfg = {"bsz": 2}

    def advance(state, i):
        time.sleep(0.02)
        return state, i + 1, None

    c._advance = advance
    out = c.window(0.3)
    # every step the window completed, over the window's whole length
    assert out["train_images_per_s"] == pytest.approx(
        2 * c.attempted / (0.02 * c.attempted), rel=0.2)
    assert c.attempted >= 14


def test_roofline_and_mfu():
    k = {"void rasterize_fwd_kernel<4>(...)": 0.004,
         "rasterize_bwd_kernel": 0.006, "segment_sum_kernel": 0.002,
         "elementwise": 1.0}
    e = ev(kernel_s=k, blend_fwd_bound_s=0.001, blend_bwd_bound_s=0.002,
           ops=67e12 * 0.5)
    assert harness.load_metric("blend_fwd_roofline.train").read(e) == \
        pytest.approx(25.0)
    assert harness.load_metric("blend_bwd_roofline.train").read(e) == \
        pytest.approx(25.0)
    assert harness.load_metric("step_mfu.train").read(e) == \
        pytest.approx(25.0)
    # no K1 in the trace: nothing to read, never 0
    assert harness.load_metric("blend_fwd_roofline.train").read(
        ev(kernel_s={}, blend_fwd_bound_s=0.001)) is None


def test_bounds_take_the_larger_side():
    ops, nbytes = counts.blend_fwd_cost(walked=10 ** 9, entries=10 ** 6,
                                        pixels=10 ** 6, n_splats=10 ** 5)
    assert counts.bound_s(ops, nbytes) == pytest.approx(
        16e9 / counts.FP32_OPS_PER_S)
    assert counts.bound_s(0, 3.35e9) == pytest.approx(1e-3)


def test_per_step_readers():
    e = ev(entries_per_view=1234.5, syncs_per_step=7.0, scene_load_s=1.5)
    assert harness.load_metric("step_device_ms.train").read(e) == \
        pytest.approx(450.0)
    assert harness.load_metric("launches_per_step.train").read(e) == 100
    assert harness.load_metric("entries_per_view.train").read(e) == 1234.5
    assert harness.load_metric("syncs_per_step.loop").read(e) == 7.0
    assert harness.load_metric("scene_load_s").read(e) == 1.5
    assert harness.load_metric("syncs_per_step.loop").read(ev()) is None


def test_loop_readers_read_only_the_loop():
    # one reader serves every cell kind; BENCHMARK.json says which cells
    # report which of its names
    e = ev(kind="loop", entries_per_view=10.0)
    assert harness.load_metric("device_idle_pct.loop").read(e) == \
        pytest.approx(25.0)
    assert harness.load_metric("entries_per_view.loop").read(e) == 10.0
    assert harness.metric_file("device_idle_pct.loop") == \
        harness.metric_file("device_idle_pct.train") == \
        harness.HERE / "metrics" / "device_idle_pct.py"
    bench = harness.load_benchmark()
    loop = {m["name"] for m in harness.cell_metrics(bench, "truck1k-loop",
                                                    "per_layer")}
    assert "device_idle_pct.loop" in loop
    assert "device_idle_pct.train" not in loop
    assert harness.load_metric("step_mfu.loop").read(ev()) is None
