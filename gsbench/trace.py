"""What a traced window leaves for the per-layer readers: the device's
activities from ``torch.profiler``, the host's operations beside them,
and the counts of synchronizing calls.

The window is marked by a span of the benchmark's own, and a device
activity counts where it overlaps that span. Busy time is the union of
the device's intervals (kernels, copies and fills), not their sum.
"""

from __future__ import annotations

import bisect
import collections
import warnings
from typing import Callable, List, NamedTuple

import torch

WINDOW = "gsbench.window"


class Activity(NamedTuple):
    name: str
    start: float     # microseconds, on the profiler's clock
    end: float
    kernel: bool     # a kernel launch, not a copy or a fill


class Trace(NamedTuple):
    window: tuple            # (start, end) of the window span
    device: List[Activity]
    host: List[Activity]     # host operations inside the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6


def profile_window(fn: Callable[[], None]) -> Trace:
    """Run ``fn`` under the profiler inside the window span, the card idle
    at both ends."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    dev, host, window = [], [], None
    for e in prof.events():
        iv = (e.time_range.start, e.time_range.end)
        if e.name == WINDOW:
            if e.device_type == torch.autograd.DeviceType.CPU:
                window = iv
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            low = e.name.lower()
            dev.append(Activity(e.name, *iv, not (
                low.startswith("memcpy") or low.startswith("memset"))))
        else:
            host.append(Activity(e.name, *iv, False))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    host = [a for a in host if a.start >= window[0] and a.end <= window[1]]
    return Trace(window, dev, host)


def clip(acts, window):
    lo, hi = window
    return [(max(a.start, lo), min(a.end, hi)) for a in acts
            if a.end > lo and a.start < hi]


def union_s(intervals) -> float:
    """Length of the union of (start, end) microsecond intervals, in s."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def gaps(tr: Trace):
    """Idle intervals of the device inside the window, longest first."""
    iv = sorted(clip(tr.device, tr.window))
    out, t = [], tr.window[0]
    for s, e in iv:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if tr.window[1] > t:
        out.append((t, tr.window[1]))
    return sorted(out, key=lambda g: g[0] - g[1])


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the innermost host operation under its middle."""
    by = collections.Counter()
    for a in tr.device:
        by[a.name[:160]] += (a.end - a.start) / 1e6
    host = sorted(tr.host, key=lambda a: a.start)
    starts = [a.start for a in host]
    named = []
    for s, e in gaps(tr)[:top]:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid)
        under = [a for a in host[max(0, i - 4096):i] if a.end >= mid]
        name = min(under, key=lambda a: a.end - a.start).name if under \
            else "host outside any operation"
        named.append([name[:160], (e - s) / 1e6])
    return {"device_ops": [[n, s] for n, s in by.most_common(top)],
            "idle_gaps": named}


def count_syncs(fn: Callable[[], None]) -> int:
    """Synchronizing calls (an ``item``, a blocking copy) that ``fn`` makes,
    under torch's CUDA sync debug mode; waits on events are not counted."""
    n = [0]

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            n[0] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return n[0]
