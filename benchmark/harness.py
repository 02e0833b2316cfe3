"""What every cell shares: the spec and its files, the card's record, the
module check, seeded reservoirs, spans and the judge's checks.

Files are found by the names `BENCHMARK.json` gives: a cell's entry names
its configuration (`configs/<config>.json`) and its traffic
(`traffic/<traffic>.json`, which names its driver, `drivers/<driver>.py`),
and every metric has a reader `metrics/<metric>.py`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "otslam_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(spec: dict, cell: str, base: Path):
    """(entry, configuration, traffic) of a cell, each from its own file."""
    entry = next((w for w in spec["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    cfg = load_json(base / "configs" / f"{entry['config']}.json")
    traffic = load_json(base / "traffic" / f"{entry['traffic']}.json")
    return entry, cfg, traffic


def metrics_for(spec: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end ones untraced,
    its per-layer ones traced (an entry without `workloads` is every
    cell's)."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, base: Path):
    """The `read(ctx)` of metric `name` (metrics/<name>.py)."""
    path = base / "metrics" / f"{name}.py"
    return load_module(path, "bench_metric_" + name.replace(".", "_")).read


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a JAX one or the JAX
    package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def power_limit(index: int = 0):
    """The card's power limit in W from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(index)], capture_output=True, text=True, timeout=30,
            check=True).stdout
        return float(out.strip().split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_record(device, chips: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit_w": power_limit(device.index or 0)}


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rounds(rng, items):
    """Endless rounds, each every item once in a seeded order: a window
    takes whole rounds until its deadline, so every seed asks for the same
    work."""
    while True:
        yield [items[i] for i in rng.permutation(len(items))]


class Reservoir:
    """A seeded uniform sample of k items per key from a stream (Algorithm
    R), plus the first item of the stream kept apart."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.seen: dict = {}
        self.kept: dict = {}
        self.first = None

    def slot(self, key):
        """Where the next item of `key` goes: a `put(item)` when the sample
        keeps it, else None, so a caller copies only what is kept."""
        if self.first is None:
            def put_first(item):
                self.first = (key, item)
            self.first = (key, None)
            return put_first
        n = self.seen.get(key, 0)
        self.seen[key] = n + 1
        bucket = self.kept.setdefault(key, [])
        if n < self.k:
            bucket.append(None)
            j = n
        else:
            j = int(self.rng.integers(0, n + 1))
            if j >= self.k:
                return None

        def put(item):
            bucket[j] = item
        return put

    def offer(self, key, item_fn):
        """item_fn() makes the item, only when it is kept."""
        put = self.slot(key)
        if put is not None:
            put(item_fn())

    def items(self):
        out = [] if self.first is None else [self.first]
        for key, bucket in self.kept.items():
            out.extend((key, it) for it in bucket)
        return [(k, it) for k, it in out if it is not None]


class Spans:
    """Host-clock spans by name that end in a device sync, and profiler
    ranges around them; on only in a traced run."""

    def __init__(self, device, enabled: bool):
        self.device = device
        self.enabled = enabled
        self.total: dict = {}
        self.calls: dict = {}

    def wrap(self, name: str, fn):
        if not self.enabled:
            return fn
        import torch

        def spanned(*a, **kw):
            sync(self.device)
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench:" + name):
                out = fn(*a, **kw)
                sync(self.device)
            dt = time.perf_counter() - t0
            self.total[name] = self.total.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1
            return out
        return spanned


class Checks:
    """Numbers compared with their limits: each keeps its worst reading.
    `at_most` limits fail above, `at_least` limits below."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.values: dict = {}

    def add(self, name: str, value) -> None:
        lim = self.limits[name]
        v = float(value)
        old = self.values.get(name)
        if old is None:
            self.values[name] = v
        elif "at_least" in lim:
            self.values[name] = min(old, v)
        else:
            self.values[name] = max(old, v)

    def ok(self, name: str) -> bool:
        lim = self.limits[name]
        v = self.values[name]
        if not np.isfinite(v):
            return False
        if "at_least" in lim:
            return v >= lim["at_least"]
        return v <= lim["at_most"]

    def missing(self) -> list:
        return [n for n in self.limits if n not in self.values]

    def correct(self) -> bool:
        return not self.missing() and all(self.ok(n) for n in self.values)

    def record(self) -> dict:
        out = {}
        for name, lim in self.limits.items():
            v = self.values.get(name)
            side = "at_least" if "at_least" in lim else "at_most"
            out[name] = {"value": v, side: lim[side]}
        return out
