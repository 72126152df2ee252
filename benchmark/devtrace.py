"""A traced sub-window: the card's busy time, its operations by name and
its idle gaps by what the host was doing, from `torch.profiler`.

Used only in `--trace 1` runs.  Device time is the union of the device
events' intervals (kernels, copies, sets), so overlapping events count
once.  An idle gap is named after the shortest host event that covers
its midpoint (the most specific torch op or `record_function` span the
benchmark opened), or "host python" where no host event covers it.
"""
from __future__ import annotations

import collections
import heapq
import re
import time
from typing import Dict, List, Optional


class DeviceTrace:
    def __init__(self, device: str):
        self.device = device
        self.prof = None
        self.window_s = 0.0
        self.summary: Optional[Dict] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(*exc)
        return False

    def summarize(self) -> Dict:
        """Read the trace: after the run's window, since it takes
        seconds of host time."""
        if self.summary is None:
            self.summary = summarize(self.prof, self.window_s)
            self.prof = None
        return self.summary


def _merge(iv: List[tuple]) -> List[list]:
    out: List[list] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof, window_s: float) -> Dict:
    """busy_s, device seconds by op name, and idle seconds by host
    activity, from a finished profiler."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, ev.name))
        elif ev.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, ev.name))
    by_name: Dict[str, float] = collections.Counter()
    for a, b, name in dev:
        by_name[name[:100]] += (b - a) / 1e6
    busy = _merge([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps = collections.Counter()
    host.sort()
    active: list = []           # (duration, end, name): shortest first
    j = 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        while j < len(host) and host[j][0] <= mid:
            a, b, name = host[j]
            heapq.heappush(active, (b - a, b, name))
            j += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)    # gaps come in order: ended for good
        label = f"host: {active[0][2][:90]}" if active else "host python"
        gaps[label] += (s1 - e0) / 1e6
    return {"busy_s": busy_s, "window_s": window_s,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1]),
            "dev_events": dev}


def kernel_seconds(summary: Dict, pattern: str) -> float:
    """Device seconds of the events whose name matches `pattern`."""
    rx = re.compile(pattern)
    return sum((b - a) / 1e6 for a, b, name in summary["dev_events"]
               if rx.search(name))
