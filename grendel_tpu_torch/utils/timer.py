"""Keyed stage timers and the end-to-end timer of the training loop.

Counterpart of grendel_tpu/utils/timer.py. ``Timer`` times keyed stages
("10 division+pack", "50 step", "80 densify", ...) and reports their sums
every log interval; on a CUDA device each start and stop records a CUDA
event on the current stream, and only :meth:`Timer.report` waits for the
device. A disabled timer records nothing and never synchronises.
``End2endTimer`` adds up training wall time with eval and save paused.
``Tracer`` records a ``torch.profiler`` trace of a span of iterations.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import torch


class Timer:
    """Keyed stage timer: CUDA events on a CUDA device, the host clock on
    the CPU."""

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
