"""The device trace of a traced run and what is read from it.

``DeviceTrace`` wraps ``torch.profiler`` with device activity only (the
host's aten events of a host-bound step would be most of a trace) and
reads the raw events, not ``key_averages()``, which builds the tree of
every event first. Spin kernels open the trace: the profiler on the card
drops the first events of a trace at times, and the spin kernels take
that loss; the first one seen also ties the device's clock to the host's
(``time.perf_counter_ns`` at its launch, after a synchronize).

The arithmetic is plain functions on intervals, so that the tests check it
on synthetic ones.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

#: spin kernels that open a trace (see the module's docstring)
PAD_SPINS = 16
SPIN_CYCLES = 1000


def union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of the intervals [(start, end)] (seconds)."""
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
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]], start: float,
              end: float) -> List[Tuple[float, float]]:
    """The gaps [(start, end)] of [start, end] that no interval covers."""
    gaps, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        gaps.append((t, end))
    return [(a, b) for a, b in gaps if b > a]


def label_at(spans: Sequence[Tuple[str, float, float]], t: float,
             default: str = "driver") -> str:
    """The innermost (shortest) host span [(name, start, end)] that holds
    the time ``t``; ``default`` where none does."""
    best, best_len = default, None
    for name, s, e in spans:
        if s <= t <= e and (best_len is None or e - s < best_len):
            best, best_len = name, e - s
    return best


def idle_by_label(gaps, spans, top: int = 10):
    """Idle seconds summed by what the host was doing at each gap's middle
    (the innermost span of ``spans`` there), largest first."""
    out: Dict[str, float] = {}
    for a, b in gaps:
        lab = label_at(spans, 0.5 * (a + b))
        out[lab] = out.get(lab, 0.0) + (b - a)
    return sorted(out.items(), key=lambda kv: -kv[1])[:top]


def top_ops(events, top: int = 10):
    """Device seconds summed by operation name, largest first; ``events``
    holds (name, start, end)."""
    out: Dict[str, float] = {}
    for name, s, e in events:
        out[name] = out.get(name, 0.0) + (e - s)
    return sorted(out.items(), key=lambda kv: -kv[1])[:top]


def short_name(name: str, limit: int = 96) -> str:
    """A device operation's name without its argument list, return type
    and anonymous namespace."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    if head.startswith("void "):
        head = head[5:]
    return (head or name)[:limit]


class DeviceTrace:
    """Device activity between ``start()`` and ``stop()``; ``events`` then
    holds (name, start, end) on the host's clock in seconds (spin kernels
    left out), ``window`` the traced window on the same clock."""

    def __init__(self, torch):
        self.torch = torch
        self.events: List[Tuple[str, float, float]] = []
        self.window = (0.0, 0.0)
        self._prof = None
        self._mark_ns = 0

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        self._mark_ns = time.perf_counter_ns()
        for _ in range(PAD_SPINS):
            torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        self._t0 = time.perf_counter_ns()

    def stop(self):
        torch = self.torch
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        self._prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        raw = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
        spins = [s for name, s, _e in raw if "spin_kernel" in name]
        if not spins:
            raise RuntimeError("the device trace holds none of its spin "
                               "kernels: the profiler saw no device work")
        offset = min(spins) - self._mark_ns  # device clock minus host's
        self.window = (1e-9 * self._t0, 1e-9 * t1)
        self.events = [(name, 1e-9 * (s - offset), 1e-9 * (e - offset))
                       for name, s, e in raw if "spin_kernel" not in name]
        self.events = [(n, max(s, self.window[0]), min(e, self.window[1]))
                       for n, s, e in self.events if e > self.window[0]]
        self._prof = None
