"""Lightweight stage timing (counterpart of otslam_tpu/utils/profiling.py).

Every pipeline stage can be timed and annotated for the profiler:

    with StageTimer() as t:
        with t.stage("fuse", sync=True):
            vol = integrate_frames_sparse(...)
    print(t.report())

Stages run inside ``torch.profiler.record_function`` ranges, so a
torch.profiler trace carries the same labels; ``sync=True`` waits for the
card's queued work (``torch.cuda.synchronize``) before the stage's clock
stops.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @contextmanager
    def stage(self, name: str, sync: bool = False):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync and torch.cuda.is_available():
                    # the device work this stage queued counts toward it
                    torch.cuda.synchronize()
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def report(self) -> str:
        rows = [f"{'stage':<24} {'calls':>6} {'total_s':>9} {'mean_ms':>9}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            n = self.counts[name]
            rows.append(f"{name:<24} {n:>6} {tot:>9.3f} {tot / n * 1e3:>9.2f}")
        return "\n".join(rows)

    def rates(self, name: str, items: int) -> float:
        """items/sec for a stage (e.g. frames fused per second)."""
        tot = self.totals.get(name, 0.0)
        return items / tot if tot > 0 else 0.0
