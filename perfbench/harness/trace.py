"""The device trace of a traced run: ``torch.profiler`` over the window,
CUDA activity only, read into kernel intervals on the host clock.

Alignment: after the profiler starts and the card is idle, one small
kernel is launched at a known host time; it is the trace's first device
event, and its start less that time is the offset from device to host
clock (good to the launch latency, some microseconds). The traced window
is [t0, t1] on the host clock: from after the marker to the stop, both
at a synchronised step boundary.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

import torch

Kernel = Tuple[str, float, float]  # (name, host start s, seconds)


def _device_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start s, seconds) of every device event, on the profiler's
    clock."""
    out = []
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        events = None
    if events is not None:
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                start, dur = e.start_us() * 1e-6, e.duration_us() * 1e-6
            out.append((e.name(), start, dur))
        return out
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start * 1e-6,
                        e.time_range.elapsed_us() * 1e-6))
    return out


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged (start, end) intervals, sorted."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class DeviceTrace:
    """Start at a step boundary, stop at a later one; then ``kernels``
    holds every device kernel that started inside [t0, t1]."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.stopped = False
        self.kernels: List[Kernel] = []
        self._t_marker = 0.0

    @staticmethod
    def prime(device) -> None:
        """One short profiling session, so that the profiler's first
        start-up (CUPTI's, seconds long) falls outside the window."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device=device)
            torch.cuda.synchronize(device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize(self.device)
        self._t_marker = time.perf_counter()
        torch.ones(1, device=self.device)
        torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.stopped = True
        events = sorted(_device_events(self.prof), key=lambda e: e[1])
        if not events:
            return
        offset = events[0][1] - self._t_marker
        self.kernels = [(n, s - offset, d) for n, s, d in events[1:]
                        if self.t0 <= s - offset <= self.t1]
        self.prof = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> List[Tuple[float, float]]:
        return union([(s, min(s + d, self.t1)) for _, s, d in self.kernels])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def seconds_matching(self, patterns: List[str]) -> float:
        """Device seconds of the kernels whose lower-cased name holds one
        of ``patterns``."""
        return sum(d for n, _, d in self.kernels
                   if any(p in n.lower() for p in patterns))

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for n, _, d in self.kernels:
            by[n] = by.get(n, 0.0) + d
        return [[n[:96], s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_by_host(self, spans: List[tuple], k: int = 10) -> List[list]:
        """Idle device seconds in the window, summed by what the host was
        doing at the middle of each gap: the model forward there, else
        the engine call or harness wait there, else ``harness``."""
        levels = []
        for inner in (True, False):
            lv = sorted((s0, s1, n) for n, s0, s1 in spans
                        if n.startswith("model.") == inner)
            levels.append(([s[0] for s in lv], lv))
        edges = [self.t0]
        for a, b in self.busy():
            edges += [a, b]
        edges.append(self.t1)
        by: Dict[str, float] = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            name = "harness"
            for starts, lv in levels:
                j = bisect.bisect_right(starts, mid) - 1
                if j >= 0 and lv[j][1] >= mid:
                    name = lv[j][2]
                    break
            by[name] = by.get(name, 0.0) + (b - a)
        return [[n, s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

