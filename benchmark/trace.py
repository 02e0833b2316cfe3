"""A traced stretch of the window: torch.profiler with CPU and CUDA
activities, read back into device busy time, kernels by name, the top
device operations and the idle gaps by what the host was doing.

Busy time is the union of the device's kernel and copy intervals inside
the stretch (overlapping work counts once). An idle gap is labelled by the
innermost `bench:<span>` range (harness.Spans) open at its midpoint.
"""

from __future__ import annotations

import re

WINDOW = "bench:window"


def _is_device(e, DeviceType) -> bool:
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench:"))


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Trace:
    """start() ... stop() around a stretch; stop() returns its summary."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.rf = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.rf = torch.profiler.record_function(WINDOW)
        self.rf.__enter__()

    def stop(self) -> dict:
        import torch
        torch.cuda.synchronize(self.device)
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        out = summarize(self.prof.events())
        self.prof = self.rf = None
        return out


def summarize(events) -> dict:
    from torch.autograd import DeviceType
    win = [e for e in events if e.name == WINDOW
           and e.device_type == DeviceType.CPU]
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if _is_device(e, DeviceType)]
    busy = _union([(max(s, w0), min(t, w1)) for s, t, _ in dev
                   if t > w0 and s < w1])
    busy_us = sum(t - s for s, t in busy)
    by_name: dict = {}
    for s, t, name in dev:
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + (t - s))
    ranges = sorted(((e.time_range.start, e.time_range.end, e.name[6:])
                     for e in events if e.device_type == DeviceType.CPU
                     and e.name.startswith("bench:") and e.name != WINDOW),
                    key=lambda r: r[1] - r[0])
    gaps: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for i in range(0, len(edges), 2):
        g0, g1 = edges[i], edges[i + 1]
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        label = next((r[2] for r in ranges if r[0] <= mid <= r[1]),
                     "outside the spans")
        gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernels": {name: (n, us * 1e-6) for name, (n, us) in by_name.items()},
        "device_ops": [[name[:120], us * 1e-6] for name, (_, us) in top],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:10],
    }


def kernel(summary: dict, name: str):
    """(launches, device seconds) of the kernels whose name is `name`."""
    pat = re.compile(r"(^|::)" + re.escape(name) + r"($|[(<])")
    n, s = 0, 0.0
    for full, (k, sec) in summary["kernels"].items():
        if pat.search(full):
            n += k
            s += sec
    return n, s

