"""The port's spans (grendel_tpu_torch/utils/timer.py ``span``) on the CPU:
free when nothing reads them, the stage timer's report built on them,
every operation of a training step under one layer's span, and the loop's
stages nested in the iteration they belong to."""

import io

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from grendel_tpu_torch import testing as TT
from grendel_tpu_torch.utils import timer as T

STEP_SPANS = ("projection", "tile lists", "blend", "loss", "backward",
              "optimizer")
LOOP_STAGES = ("10 batch", "20 ground truth", "50 step", "capacity check",
               "log", "80 densify")
TIMER_KEYS = ("10 batch", "20 ground truth", "50 step", "80 densify",
              "90 eval")
NODE = "autograd::engine::evaluate_function: "


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """Parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]


def _within(inner, outer) -> bool:
    return (inner.thread == outer.thread and inner is not outer
            and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def _innermost(e, candidates):
    around = [c for c in candidates if _within(e, c)]
    return min(around, key=lambda c: c.time_range.elapsed_us()) \
        if around else None


def _span_name(e) -> str:
    return e.name.split(" #")[0]


def test_span_off_is_the_shared_null_context(monkeypatch):
    made = []
    monkeypatch.setattr(T, "_RANGE", lambda label: made.append(label))
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: made.append(kw))
    off = T.Timer(enabled=False, device="cuda")
    assert T.span("loss") is T._NULL
    assert T.span("iteration", 8) is T._NULL
    assert T.span("50 step", timer=off) is T._NULL
    with T.span("50 step", timer=off):
        pass
    assert made == [] and off.report() == ""


def test_span_under_a_profiler_and_on_the_timer():
    t = T.Timer(device="cpu")
    with T.span("50 step", timer=t):
        pass
    assert T.span("loss") is T._NULL
    assert t.report().startswith("50 step: ")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with T.span("iteration", 600):
            with T.span("50 step", timer=t):
                torch.ones(3).sum()
    names = [e.name for e in _host(prof)]
    assert "iteration #600" in names and "50 step" in names
    assert "(x1, avg" in t.report()


def _attribution(prof):
    """Each aten op of a profiled step -> (op, the step span it belongs
    to, whether it ran in an autograd node): its own innermost span, or,
    inside a node, the span of the forward op whose sequence number the
    node carries. Also the names of the nodes with no forward op."""
    host = _host(prof)
    spans = [e for e in host if _span_name(e) in STEP_SPANS]
    nodes = [e for e in host if e.name.startswith(NODE)]

    def fwd_of(node):
        # ops called in grad mode record the number the next node takes:
        # the node's maker is the last of them before the node runs
        made = [e for e in host if e.thread == node.fwd_thread
                and e.sequence_nr == node.sequence_nr
                and not e.name.startswith(NODE)
                and e.time_range.end <= node.time_range.start]
        return max(made, key=lambda e: e.time_range.start) if made else None

    orphans = {n.name[len(NODE):] for n in nodes if fwd_of(n) is None}
    out = []
    for op in host:
        if not op.name.startswith("aten::"):
            continue
        node = _innermost(op, nodes)
        anchor = fwd_of(node) if node is not None else None
        s = _innermost(anchor or op, spans)
        out.append((op.name, _span_name(s) if s is not None else None,
                    node.name[len(NODE):] if node is not None else None))
    return out, orphans


def test_every_op_of_a_step_falls_under_one_layer_span():
    tr = TT.flagship_training(TT.flagship_inputs(0), "cpu")
    tr.step(tr.state)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step(tr.state)
    got, orphans = _attribution(prof)
    assert got and all(s in STEP_SPANS for _, s, _ in got), \
        sorted({op for op, s, _ in got if s not in STEP_SPANS})
    assert {s for _, s, _ in got} == set(STEP_SPANS)
    # the backward's work goes to the layers whose forward ops made it;
    # only the gradients' accumulation into the leaves has no forward op,
    # and only the loss's seed gradient runs outside any node
    assert orphans == {"torch::autograd::AccumulateGrad"}
    left = [(op, node) for op, s, node in got if s == "backward"]
    assert ("aten::ones_like", None) in left
    assert all(node is None for _, node in left)
    # the blend's own backward (kernel K2 on the card) is the blend's
    assert {s for _, s, node in got if node == "_BlendBackward"} == {"blend"}


def _small_trainer(log, **opt):
    from grendel_tpu_torch.config import TrainConfig
    from grendel_tpu_torch.engine.trainer import Trainer

    scene = TT.SyntheticScene(n_cams=4, n_test=1, width=48, height=32,
                              n_gaussians=60, n_init_points=80, seed=4,
                              device="cpu")
    cfg = TrainConfig()
    cfg.model.sh_degree = 1
    cfg.dist.bsz = 2
    cfg.opt.iterations = 8
    cfg.opt.densify_from_iter = 2
    cfg.opt.densification_interval = 4
    cfg.opt.densify_until_iter = 4
    # every round grows the capacity after it
    cfg.opt.capacity_growth_trigger = 0.01
    for k, v in opt.items():
        setattr(cfg.opt if hasattr(cfg.opt, k) else cfg, k, v)
    cfg.test_iterations, cfg.save_iterations = [4], []
    cfg.log_interval = 2
    cfg.quiet = True
    return Trainer(cfg.finalize(), scene, device="cpu", log_file=log)


def test_enable_timer_reports_the_five_keyed_stages():
    from grendel_tpu_torch.scripts.analyze import STAGE

    log = io.StringIO()
    tr = _small_trainer(log, enable_timer=True)
    tr.train()
    lines = [ln.split("timers: ", 1)[1] for ln in log.getvalue().splitlines()
             if "timers: " in ln]
    keys = {m.group(1).strip() for ln in lines for m in STAGE.finditer(ln)}
    assert keys == set(TIMER_KEYS)
    assert len(tr.densify_history) == 1


def test_iteration_spans_nest_the_loop_stages():
    log = io.StringIO()
    tr = _small_trainer(log)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train()
    host = _host(prof)
    spans = [e for e in host if _span_name(e) in T.SPANS]
    assert {_span_name(e) for e in spans} <= set(T.SPANS)
    iters = [e for e in spans if _span_name(e) == "iteration"]
    assert [e.name for e in iters] == [f"iteration #{i}"
                                      for i in range(0, 8, 2)]
    loop = [e for e in spans if _span_name(e) in LOOP_STAGES + ("90 eval",)]
    assert {_span_name(e) for e in loop} == set(LOOP_STAGES + ("90 eval",))
    for e in loop:
        assert _innermost(e, iters) is not None, e.name
    # one round, in the pass of the iteration the schedule fired at
    (densify,) = [e for e in spans if e.name == "80 densify"]
    sched_it = tr.densify_history[0]["iter"]
    assert _innermost(densify, iters).name == f"iteration #{sched_it - 1}"
    inside = {_span_name(e) for e in spans if _within(e, densify)}
    assert inside == {"grow", "densify round"}
    grows = [e for e in spans if e.name == "grow"]
    assert grows and all(_within(g, densify) for g in grows)
    for e in spans:
        if _span_name(e) in STEP_SPANS:
            assert _innermost(e, [s for s in spans
                                  if s.name == "50 step"]) is not None \
                or _innermost(e, [s for s in spans
                                  if s.name == "90 eval"]) is not None
