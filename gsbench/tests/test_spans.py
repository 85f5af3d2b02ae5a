"""The traced window put down to the program's spans (gsbench/spans.py),
on made-up traces."""

import pytest

from gsbench import harness, spans, trace
from gsbench.entries import common

E = spans.Event
NAMES = ("iteration", "50 step", "80 densify", "projection", "loss",
         "backward", "optimizer")
MAIN, AUTOGRAD = 1, 2


def host_span(name, s, e, thread=MAIN, id_=0):
    return E(name, s, e, False, thread, -1, 0, id_, 0)


def op(name, s, e, id_, thread=MAIN, seq=-1, fwd_thread=0):
    return E(name, s, e, False, thread, seq, fwd_thread, id_, 0)


def kernel(s, e, call, name="k"):
    """A device activity of the runtime call ``call`` (see launch)."""
    return E(name, s, e, True, id=call, link=1)


def launch(t, call, op_id, thread=MAIN):
    """The runtime call ``call`` at ``t``, made inside the op ``op_id``."""
    return E("cudaLaunchKernel", t, t + 0.5, False, thread, -1, 0, call,
             op_id)


def step_trace():
    """One step: a forward op under ``projection`` and one under ``loss``,
    the backward on the autograd thread (a node of each forward op, the
    gradients' accumulation, the seed outside any node), ``optimizer``."""
    host = [
        host_span("iteration #600", 0, 100, id_=1),
        host_span("50 step", 2, 90, id_=2),
        host_span("projection", 4, 20, id_=3),
        op("aten::exp", 5, 9, 10, seq=7),
        # an op that makes no node records the number the next node takes
        op("aten::detach", 12, 13, 20, seq=8),
        host_span("loss", 22, 40, id_=4),
        op("aten::mul", 23, 30, 11, seq=8),
        host_span("backward", 42, 70, id_=5),
        op("aten::ones_like", 43, 44, 12, thread=AUTOGRAD),
        op(spans.NODE + "MulBackward0", 45, 50, 13, AUTOGRAD, 8, MAIN),
        op("aten::mul", 46, 48, 14, thread=AUTOGRAD),
        op(spans.NODE + "ExpBackward0", 51, 56, 15, AUTOGRAD, 7, MAIN),
        op("aten::mul", 52, 54, 16, thread=AUTOGRAD),
        op(spans.NODE + "torch::autograd::AccumulateGrad", 57, 60, 17,
           AUTOGRAD, -1, MAIN),
        op("aten::copy_", 58, 59, 18, thread=AUTOGRAD),
        host_span("optimizer", 72, 88, id_=6),
        op("aten::add_", 73, 80, 19),
        # the profiler's bookkeeping reuses an op's id (aten::exp's)
        op("Activity Buffer Request", 81, 82, 10),
        launch(6, 900, 10), launch(24, 901, 11),
        launch(43.2, 902, 12, AUTOGRAD), launch(47, 903, 14, AUTOGRAD),
        launch(53, 904, 16, AUTOGRAD), launch(58.2, 905, 18, AUTOGRAD),
        launch(74, 906, 19),
    ]
    device = [kernel(6, 8, 900), kernel(24, 33, 901), kernel(44, 45, 902),
              kernel(47, 50, 903), kernel(53, 55, 904), kernel(58, 60, 905),
              kernel(76, 86, 906), kernel(91, 92, 907)]
    return spans.SpanTrace((0.0, 100.0), device, host, MAIN)


def test_innermost_span_takes_the_launch():
    tr = step_trace()
    got = spans.attribute(tr, NAMES)
    assert got[0] == "projection" and got[1] == "loss"
    assert got[6] == "optimizer"
    # a span that is not the program's does not take it
    assert spans.attribute(tr, ("iteration", "50 step"))[0] == "50 step"
    # no runtime call of the activity in the window
    assert got[7] == spans.OUTSIDE


def test_backward_launches_go_to_their_forward_span():
    got = spans.attribute(step_trace(), NAMES)
    assert got[3] == "loss"          # MulBackward0 -> aten::mul, seq 8
    assert got[4] == "projection"    # ExpBackward0 -> aten::exp, seq 7
    # the seed and the accumulation have no forward op: the span open on
    # the loop's thread
    assert got[2] == "backward" and got[5] == "backward"


def test_table_counts_host_and_device_time():
    t = spans.table(step_trace(), NAMES)
    assert t["iteration"]["count"] == 1
    assert t["iteration"]["host_s"] == pytest.approx(100e-6)
    assert t["50 step"]["self_host_s"] == pytest.approx(
        (88 - 16 - 18 - 28 - 16) * 1e-6)
    assert t["iteration"]["self_host_s"] == pytest.approx(12e-6)
    assert t["loss"]["device_s"] == pytest.approx(12e-6)
    assert t["projection"]["device_s"] == pytest.approx(4e-6)
    assert t["backward"]["device_s"] == pytest.approx(3e-6)
    assert t["optimizer"]["device_s"] == pytest.approx(10e-6)
    assert t[spans.OUTSIDE]["device_s"] == pytest.approx(1e-6)
    device_s = sum(v["device_s"] for v in t.values())
    assert device_s == pytest.approx(common.evidence(
        step_trace(), "train", 1)["device_s"])


def test_idle_is_split_at_span_edges():
    host = [host_span("iteration #0", 0, 100), host_span("50 step", 5, 20),
            host_span("80 densify", 20, 35),
            op("Activity Buffer Request", 42, 45, 30, thread=9)]
    tr = spans.SpanTrace((0.0, 50.0), [kernel(0, 10, 0), kernel(30, 40, 0)],
                         host, MAIN)
    idle = dict(spans.idle_by_span(tr, NAMES))
    assert idle == pytest.approx({"50 step": 10e-6, "80 densify": 10e-6,
                                  "iteration": 7e-6,
                                  "Activity Buffer Request": 3e-6})
    # spans on another thread than the loop's name no idle time
    tr = tr._replace(thread=3)
    idle = dict(spans.idle_by_span(tr, NAMES))
    assert idle == pytest.approx({spans.OUTSIDE: 27e-6,
                                  "Activity Buffer Request": 3e-6})
    assert spans.table(tr._replace(thread=MAIN), NAMES)[
        "50 step"]["idle_s"] == pytest.approx(10e-6)


def test_a_span_trace_leaves_the_evidence_as_it_was():
    """Every key and list the readers and the result line read, equal on
    the same trace with and without what attribution keeps."""
    tr = step_trace()
    plain = trace.Trace(tr.window, [trace.Activity(*a[:4]) for a in
                                    tr.device],
                        [trace.Activity(*a[:4]) for a in tr.host])
    assert common.evidence(tr, "train", 2) == \
        common.evidence(plain, "train", 2)


SPAN_EV = dict(kind="loop", units=4, spans={
    "projection": dict(count=8, host_s=0.01, self_host_s=0.01,
                       device_s=0.008, idle_s=0.0),
    "tile lists": dict(count=4, host_s=0.01, self_host_s=0.01,
                       device_s=0.004, idle_s=0.0),
    "loss": dict(count=4, host_s=0.01, self_host_s=0.01, device_s=0.2,
                 idle_s=0.0),
    "optimizer": dict(count=4, host_s=0.01, self_host_s=0.01,
                      device_s=0.02, idle_s=0.0),
    "iteration": dict(count=4, host_s=0.6, self_host_s=0.01, device_s=0.0,
                      idle_s=0.0),
    "50 step": dict(count=4, host_s=0.4, self_host_s=0.3, device_s=0.0,
                    idle_s=0.0),
    "80 densify": dict(count=1, host_s=0.06, self_host_s=0.01,
                       device_s=0.0, idle_s=0.0),
    "save": dict(count=1, host_s=0.02, self_host_s=0.02, device_s=0.0,
                 idle_s=0.0)})


@pytest.mark.parametrize("name, want", [
    ("projection_device_ms.train", 2.0), ("tile_lists_device_ms.train", 1.0),
    ("loss_device_ms.train", 50.0), ("optimizer_device_ms.train", 5.0),
    ("step_host_ms.loop", 100.0), ("loop_host_ms.loop", 30.0),
    ("densify_ms.loop", 60.0)])
def test_span_readers(name, want):
    r = harness.load_metric(name)
    assert r.read(SPAN_EV) == pytest.approx(want)
    assert r.read(dict(SPAN_EV, spans={})) is None
    assert r.read({k: v for k, v in SPAN_EV.items() if k != "spans"}) is None
    assert r.LAYER and r.UNIT == "ms"
    assert name in spans.SPAN_METRICS
