"""The traced window put down to the program's spans.

The program marks its layers and loop stages with spans
(``grendel_tpu_torch/utils/timer.py span``): under the profiler each is an
operator-scope range on the host, on the profiler's clock. Here a device
activity belongs to the innermost span around the runtime call that
launched it (the profiler gives the two one correlation id). A launch
made inside an autograd backward node belongs to the span of the forward
operation that made the node (the node carries its sequence number, the
last forward operation to record it made the node); a
node with no forward operation (the gradients' accumulation into the
leaves) and a launch on a thread that opens no span belong to the span
open on the loop's thread at that time: ``backward``.

For each span name, :func:`table` gives its count, its host seconds (the
union of its intervals), its self host seconds (less its child spans), its
device seconds (kernels, copies and fills, summed as ``step_device_ms``
sums them) and the device's idle seconds while it was the innermost span
open on the loop's thread, idle time split at span edges.

    python3 gsbench/spans.py --workload truck1k-loop --seed 7

runs a cell's traced window under this profile and prints the table, the
idle time by span, and the span metrics of ``gsbench/metrics/`` beside the
cell's per-layer metrics, as one JSON line.
"""

from __future__ import annotations

import bisect
import collections
import sys
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    __package__ = "gsbench"

from . import trace as T

OUTSIDE = "outside any span"
NODE = "autograd::engine::evaluate_function: "
# the profiler's own host work, reported as it is
PROFILER_OWN = ("Activity Buffer Request", "Activity_Buffer_Request")


class Event(NamedTuple):
    """A host operation or a device activity: ``trace.Activity``'s fields,
    then what attribution needs."""

    name: str
    start: float     # microseconds, on the profiler's clock
    end: float
    kernel: bool     # device: a kernel launch, not a copy or a fill
    thread: int = 0
    seq: int = -1    # host: the autograd sequence number (a backward node's
    #                  is its forward operation's)
    fwd_thread: int = 0   # host, a backward node: its forward op's thread
    id: int = 0      # the profiler's correlation id: a launch's runtime
    #                  call and its device activity share one
    link: int = 0    # a runtime call or a device activity: the correlation
    #                  id of the host operation open at the launch; 0 for
    #                  an operation


class SpanTrace(NamedTuple):
    """``trace.Trace`` with Events, and the thread of the window's span."""

    window: tuple
    device: List[Event]
    host: List[Event]
    thread: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6


def profile_window(fn: Callable[[], None]) -> SpanTrace:
    """``trace.profile_window`` keeping each event's thread, sequence
    number and links."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(T.WINDOW):
            fn()
            torch.cuda.synchronize()
    links = _links(prof)
    dev, host, window, thread = [], [], None, 0
    for e in prof.events():
        on_card = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name == T.WINDOW:
            if not on_card:
                window, thread = (e.time_range.start, e.time_range.end), \
                    e.thread
            continue
        low = e.name.lower()
        ev = Event(e.name, e.time_range.start, e.time_range.end,
                   on_card and not (low.startswith("memcpy")
                                    or low.startswith("memset")),
                   e.thread, e.sequence_nr, e.fwd_thread or 0, e.id,
                   links.get((on_card, e.id, e.time_range.start), 0))
        (dev if on_card else host).append(ev)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    host = [a for a in host if a.start >= window[0] and a.end <= window[1]]
    return SpanTrace(window, dev, host, thread)


def _links(prof) -> dict:
    """(on the card, correlation id, start) of each event -> the
    correlation id of the host operation open at its launch, from the
    profiler's own results (its events do not carry the link in every
    release of torch)."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    return {(k.device_type() == torch.autograd.DeviceType.CUDA,
             k.correlation_id(), (k.start_ns() - t0) / 1000):
            k.linked_correlation_id() for k in res.events()}


def base_name(name: str) -> str:
    """A span's name without its argument (``"iteration #600"``)."""
    return name.split(" #", 1)[0]


class _Innermost:
    """The innermost of nested intervals at a time, on one thread: the
    timeline cut where any of them starts or ends."""

    def __init__(self, events: Sequence[Event]):
        self.cuts = sorted({t for e in events for t in (e.start, e.end)})
        self.at: List[Optional[Event]] = [None] * len(self.cuts)
        # longer first, so that a nested interval overwrites its parent
        for e in sorted(events, key=lambda e: e.start - e.end):
            lo = bisect.bisect_left(self.cuts, e.start)
            for i in range(lo, bisect.bisect_left(self.cuts, e.end)):
                self.at[i] = e

    def __call__(self, t: float) -> Optional[Event]:
        i = bisect.bisect_right(self.cuts, t) - 1
        return self.at[i] if i >= 0 else None

    def pieces(self, lo: float, hi: float):
        """(start, end, innermost) pieces of [lo, hi), cut at every edge."""
        i = bisect.bisect_right(self.cuts, lo)
        while lo < hi:
            end = min(self.cuts[i], hi) if i < len(self.cuts) else hi
            yield lo, end, self(lo)
            lo, i = end, i + 1


def _by_thread(events):
    out = collections.defaultdict(list)
    for e in events:
        out[e.thread].append(e)
    return {k: _Innermost(v) for k, v in out.items()}


def attribute(tr: SpanTrace, names: Sequence[str]) -> List[str]:
    """The span name each device activity of ``tr`` belongs to (OUTSIDE
    where none), in the order of ``tr.device``."""
    names = set(names)
    spans = _by_thread(e for e in tr.host if base_name(e.name) in names)
    nodes = _by_thread(e for e in tr.host if e.name.startswith(NODE))
    # the runtime calls, by the correlation id they share with what they
    # launched (an operation's own id may be reused by the profiler's
    # bookkeeping, a launch's is not)
    calls = {e.id: e for e in tr.host if e.link}
    # every operation called in grad mode records the sequence number the
    # next node will take, so the node's maker is the last of them
    forward: Dict[tuple, List[Event]] = collections.defaultdict(list)
    for e in sorted(tr.host, key=lambda e: e.start):
        if e.seq >= 0 and not e.name.startswith(NODE):
            forward[e.thread, e.seq].append(e)
    loop = spans.get(tr.thread)

    def maker(node):
        made = [e for e in forward.get((node.fwd_thread, node.seq), ())
                if e.end <= node.start]
        return made[-1] if made else None

    def span_at(thread, t):
        inner = spans.get(thread)
        if inner is None:           # a thread that opens no span
            inner = loop
        s = inner(t) if inner is not None else None
        return base_name(s.name) if s is not None else OUTSIDE

    out = []
    for d in tr.device:
        call = calls.get(d.id) if d.link else None
        if call is None:
            out.append(OUTSIDE)
            continue
        node = nodes[call.thread](call.start) if call.thread in nodes \
            else None
        if node is None:
            out.append(span_at(call.thread, call.start))
            continue
        fwd = maker(node)
        if fwd is not None:
            out.append(span_at(fwd.thread, fwd.start))
        else:
            out.append(span_at(tr.thread, node.start))
    return out


def table(tr: SpanTrace, names: Sequence[str]) -> dict:
    """Per span name: ``count``, ``host_s``, ``self_host_s``,
    ``device_s`` and ``idle_s`` (see the module's docstring); OUTSIDE
    holds the device and idle seconds of no span."""
    names = set(names)
    events = [e for e in tr.host if base_name(e.name) in names]
    out = collections.defaultdict(lambda: dict(
        count=0, host_s=0.0, self_host_s=0.0, device_s=0.0, idle_s=0.0))
    by_name = collections.defaultdict(list)
    for e in events:
        by_name[base_name(e.name)].append((e.start, e.end))
    for name, iv in by_name.items():
        out[name]["count"] = len(iv)
        out[name]["host_s"] = T.union_s(iv)
    for inner in _by_thread(events).values():
        for i in range(len(inner.cuts) - 1):
            s = inner.at[i]
            if s is not None:
                out[base_name(s.name)]["self_host_s"] += \
                    (inner.cuts[i + 1] - inner.cuts[i]) / 1e6
    lo, hi = tr.window
    for d, name in zip(tr.device, attribute(tr, names)):
        s, e = max(d.start, lo), min(d.end, hi)
        if e > s:
            out[name]["device_s"] += (e - s) / 1e6
    for name, s in idle_by_span(tr, names):
        out[name]["idle_s"] += s
    return {k: dict(v) for k, v in out.items()}


def idle_by_span(tr: SpanTrace, names: Sequence[str]) -> list:
    """The device's idle seconds by the innermost span open on the loop's
    thread, split at span edges, longest first; the profiler's own host
    work under its own name."""
    names = set(names)
    loop = [e for e in tr.host
            if e.thread == tr.thread and base_name(e.name) in names]
    inner = _Innermost(loop)
    own = _Innermost([e for e in tr.host if e.name in PROFILER_OWN])
    idle = collections.Counter()
    for g0, g1 in T.gaps(tr):
        for a, b, p in own.pieces(g0, g1):
            if p is not None:
                idle[p.name] += (b - a) / 1e6
                continue
            for c, d, s in inner.pieces(a, b):
                idle[base_name(s.name) if s is not None else OUTSIDE] += \
                    (d - c) / 1e6
    return [[k, v] for k, v in idle.most_common()]


# -- the command --------------------------------------------------------------

# the readers in gsbench/metrics/ of what this module adds to the evidence
SPAN_METRICS = ("projection_device_ms.train", "tile_lists_device_ms.train",
                "loss_device_ms.train", "optimizer_device_ms.train",
                "step_host_ms.loop", "loop_host_ms.loop", "densify_ms.loop")


def main(argv=None) -> int:
    import argparse
    import json
    import time

    from . import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gsbench: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.set_num_threads(1)
    try:
        from grendel_tpu_torch.utils.timer import SPANS as names
    except ImportError:
        names = ()
    bench = harness.load_benchmark()
    wl = harness.load_workload(a.workload)
    cfg = harness.load_config(wl["config"])
    kept = []

    def profiled(fn):
        tr = profile_window(fn)
        kept.append(tr)
        return tr

    T.profile_window = profiled
    t0 = time.perf_counter()
    c = harness.load_entry(wl["entry"]).Cell(cfg, wl, a.seed, dev)
    setup_s = time.perf_counter() - t0
    ev = c.traced()
    tr = kept[0]
    ev["spans"] = table(tr, names)
    metrics = {}
    for name in [m["name"] for m in harness.cell_metrics(
            bench, a.workload, "per_layer")] + \
            [m for m in SPAN_METRICS if m.endswith("." + ev["kind"])]:
        v = harness.load_metric(name).read(ev)
        if v is not None:
            metrics[name] = v
    by_kernel = collections.Counter()
    for d, name in zip(tr.device, attribute(tr, names)):
        by_kernel[name, d.name[:80]] += (d.end - d.start) / 1e6
    print(json.dumps(dict(
        workload=a.workload, seed=a.seed, setup_s=setup_s,
        device=torch.cuda.get_device_name(dev), units=ev["units"],
        images=ev.get("images"), window_s=ev["window_s"],
        busy_s=ev["busy_s"], device_s=ev["device_s"], metrics=metrics,
        spans=ev["spans"], idle_by_span=idle_by_span(tr, names)[:16],
        kernels=[[*k, v] for k, v in by_kernel.most_common(40)])),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
