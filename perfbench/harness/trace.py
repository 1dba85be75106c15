"""One profiled span of the timed path and the arithmetic on its device intervals.

``profile_span(fn)`` runs ``fn`` under ``torch.profiler`` (host and device activity), times the
span on the host clock from before ``fn`` to after a synchronise, and keeps the device operations
(kernels, copies, sets) and the host operations as plain tuples. Busy time and wall time come
from this one span.

``union_us`` is the busy time of a set of intervals: kernels on several streams overlap, so their
durations can sum to more than the span; the union counts each microsecond once.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Tuple

import torch

from perfbench.harness.registry import KernelClass, classify

Interval = Tuple[float, float]
SPAN = "perfbench.span"


def union_us(intervals: Iterable[Interval]) -> float:
    """Microseconds covered by at least one of ``intervals`` (start, end)."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        busy += max(stop - max(start, end), 0.0)
        end = max(end, stop)
    return busy


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for start, stop in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return [(a, b) for a, b in out]


@dataclass
class Span:
    """A profiled span: ``device`` (name, start_us, end_us) operations, ``host`` (name, start_us,
    end_us) operations, the host wall in seconds and the units of work it held."""

    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    wall_s: float
    units: int
    classes: Dict[str, str] = field(default_factory=dict)

    def classify(self, kernel_classes: List[KernelClass]) -> None:
        self.classes = {name: classify(name, kernel_classes) for name, _, _ in self.device}

    def busy_s(self, cls: str = None) -> float:
        return union_us((a, b) for n, a, b in self.device if cls is None or self.classes.get(n) == cls) / 1e6

    def device_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, float] = {}
        for name, a, b in self.device:
            total[name] = total.get(name, 0.0) + (b - a) / 1e6
        return [[k[:160], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The idle gaps between device operations, summed by the innermost host operation that was
        running at each gap's midpoint, longest first."""
        busy = merged((a, b) for _, a, b in self.device)
        bounds = [(a, b) for n, a, b in self.host if n == SPAN]
        if bounds:  # the idle time before the first and after the last device operation
            busy = [(bounds[0][0], bounds[0][0])] + busy + [(bounds[0][1], bounds[0][1])]
        by_host: Dict[str, float] = {}
        hosts = sorted((h for h in self.host if h[0] != SPAN and not h[0].startswith("cuda")), key=lambda h: h[1])
        starts = [h[1] for h in hosts]
        for (_, end), (start, _) in zip(busy, busy[1:]):
            mid = (end + start) / 2
            name = "host work outside torch operations"
            # the latest-started operation still running at the midpoint is the innermost one
            for h in reversed(hosts[max(0, bisect.bisect_right(starts, mid) - 4000):bisect.bisect_right(starts, mid)]):
                if h[2] >= mid:
                    name = h[0]
                    break
            by_host[name[:160]] = by_host.get(name[:160], 0.0) + (start - end) / 1e6
        return [[k, v] for k, v in sorted(by_host.items(), key=lambda kv: -kv[1])[:n]]


def profile_span(fn: Callable[[], int], host_ops: bool = False) -> Span:
    """Profile one call of ``fn``, which returns the units of work it did.

    By default only the device's activity is traced (and the CUDA runtime's calls with it): recording
    every host operation costs the host some tens of microseconds each, which would lengthen a
    host-bound step by a third. ``host_ops`` records them too, for naming idle gaps."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(SPAN):
            t0 = time.perf_counter()
            units = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        rng = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name != SPAN:  # the span's own annotation, which the device timeline repeats
                device.append(rng)
        else:
            host.append(rng)
    if not device:
        raise RuntimeError("The profiler recorded no device operation in the traced span.")
    return Span(device=device, host=host, wall_s=wall, units=units)
