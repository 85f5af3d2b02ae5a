"""Spans of the port's work, the keyed stage timer built on them, the
end-to-end timer of the training loop and the profiler window.

Counterpart of grendel_tpu/utils/timer.py. :func:`span` marks one stage of
the work (a loop stage, a layer of the step); with ``torch.profiler``
running it is a range on the profiler's clock, the clock of the card's
activities. ``Timer`` times the stages whose spans are given it
("10 division+pack", "50 step", "80 densify", ...) and reports their sums
every log interval; on a CUDA device each start and stop records a CUDA
event on the current stream, so a stage's time is the stream's time
between the two events, and only :meth:`Timer.report` waits for the
device. A disabled timer records nothing and never synchronises.
``End2endTimer`` adds up training wall time with eval and save paused.
``Tracer`` records a ``torch.profiler`` trace of a span of iterations.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

_PROFILER = torch.autograd.profiler
_NULL = contextlib.nullcontext()
# The profiler's range of a span: operator-scope. A user-scope range
# (``torch.profiler.record_function``) also adds a copy of itself to the
# card's activities, which readers of the trace would count as device work.
_RANGE = torch._C._profiler._RecordFunctionFast

# Every span the port opens, by layer.
SPANS = (
    # the training loop (engine/trainer.py, engine/trainer_dist.py)
    "iteration", "10 batch", "10 division+pack", "20 ground truth",
    "50 step", "capacity check", "log", "80 densify", "opacity reset",
    "90 eval", "save",
    # densify (engine/trainer.py Trainer._densify)
    "grow", "densify round",
    # the training step (engine/train.py, engine/render.py)
    "projection", "tile lists", "blend", "loss", "backward", "optimizer",
    # the sparse exchange (parallel/comm.py)
    "exchange",
)


class _Span:
    """An open span: the profiler's range, the timer's stage, or both."""

    __slots__ = ("_range", "_timer", "_key")

    def __init__(self, label: str, key: str, timer, profiled: bool):
        self._range = _RANGE(label) if profiled else None
        self._timer, self._key = timer, key

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        if self._timer is not None:
            self._timer.start(self._key)
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.stop(self._key)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str, arg=None, timer: Optional["Timer"] = None):
    """A span of the port's work: ``with span("loss"): ...``.

    With a profiler running, a range named ``name`` (``"name #arg"`` where
    ``arg`` is given: the iteration of a loop pass, which the spans nested
    in it share). With ``timer`` enabled, the timer's stage ``name``
    too. Otherwise one shared null context, so a span costs a check of
    the profiler's flag."""
    profiled = _PROFILER._is_profiler_enabled
    if timer is not None and not timer.enabled:
        timer = None
    if not profiled and timer is None:
        return _NULL
    return _Span(name if arg is None else f"{name} #{arg}", name, timer,
                 profiled)


class Timer:
    """Keyed stage timer of the spans given it: CUDA events on a CUDA
    device, the host clock on the CPU.

    On the card a stage's time is the stream's between its two events.
    For a stage that only enqueues work or waits on the host (``10
    batch``, ``20 ground truth``) that is the stream's queue, not the
    host's work; the span's host time, in a profiler's trace, is the
    host's."""

    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._start: Dict[str, object] = {}
        # key -> finished (start, end) pairs not reported yet
        self._pairs: Dict[str, List[Tuple[object, object]]] = {}

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self, key: str) -> None:
        if self.enabled:
            self._start[key] = self._mark()

    def stop(self, key: str) -> None:
        if not self.enabled or key not in self._start:
            return
        self._pairs.setdefault(key, []).append(
            (self._start.pop(key), self._mark()))

    def _ms(self, pair) -> float:
        a, b = pair
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def elapsed_ms(self, key: str) -> float:
        """Total ms of ``key``'s finished stages (waits for the device)."""
        pairs = self._pairs.get(key, [])
        if self.cuda and pairs:
            pairs[-1][1].synchronize()
        return sum(self._ms(p) for p in pairs)

    def report(self, reset: bool = True) -> str:
        parts = []
        for key in sorted(self._pairs):
            n = len(self._pairs[key])
            total = self.elapsed_ms(key)
            parts.append(f"{key}: {total:.2f} ms (x{n}, avg "
                         f"{total / max(n, 1):.2f} ms)")
        if reset:
            self._pairs.clear()
        return "; ".join(parts)


class End2endTimer:
    """Total training time with eval and save paused."""

    def __init__(self):
        self._total = 0.0
        self._since: Optional[float] = None

    def start(self) -> None:
        if self._since is None:
            self._since = time.perf_counter()

    def pause(self) -> None:
        if self._since is not None:
            self._total += time.perf_counter() - self._since
            self._since = None

    def total_seconds(self) -> float:
        extra = (time.perf_counter() - self._since) if self._since else 0.0
        return self._total + extra


class Tracer:
    """A ``torch.profiler`` trace (host, and the card's kernels on a CUDA
    device) of the iterations from ``start`` until ``length`` more have
    begun, written as ``trace_rk{rank}.json`` (Chrome trace format) in
    ``directory``. ``start`` None traces nothing."""

    def __init__(self, directory: str, rank: int, device,
                 start: Optional[int], length: int):
        self.directory = directory
        self.path = os.path.join(directory, f"trace_rk{rank}.json")
        self._cuda = torch.device(device).type == "cuda"
        self._start, self._length = start, length
        self._stop: Optional[int] = None
        self._prof = None

    def at(self, it: int) -> bool:
        """Call before the step of iteration ``it``: starts the trace when
        ``it`` reaches the start, stops it ``length`` iterations later.
        True when this call wrote the trace."""
        if self._start is not None and it >= self._start:
            self.begin()
            self._start, self._stop = None, it + self._length
        elif self._stop is not None and it >= self._stop:
            return self.stop()
        return False

    def begin(self) -> None:
        """Start the trace now; ``stop`` ends and writes it."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self._cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> bool:
        """Stop a running trace and write it; True if one was running."""
        if self._prof is None:
            return False
        if self._cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.directory, exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        self._prof, self._stop = None, None
        return True
