"""Keyed stage timers and the end-to-end timer of the training loop.

Counterpart of grendel_tpu/utils/timer.py. ``Timer`` times keyed stages
("10 division+pack", "50 step", "80 densify", ...) and reports their sums
every log interval; on a CUDA device each start and stop records a CUDA
event on the current stream, and only :meth:`Timer.report` waits for the
device. A disabled timer records nothing and never synchronises.
``End2endTimer`` adds up training wall time with eval and save paused.
"""

from __future__ import annotations

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
