"""The port's tracing: process-wide counters, spans kept by a per-call
recorder, and stage timing (counterpart of otslam_tpu/utils/profiling.py,
extended).

Counters (`COUNTS`, always on, one integer add each):

* ``h2d_bytes`` / ``d2h_bytes``: bytes copied from host memory to the card
  and back (`device.to_f32`, `device.to_device`, `device.to_host`);
* ``syncs``: the host waits the port makes on the card (`waited`, and
  every counted copy);
* ``launches.<C entry point>``: one per kernel launch
  (`kernels/_build.check`);
* ``k1_blocks`` / ``k1_pairs``: the listed blocks and the (block, frame)
  pairs of each K1 work list (`tsdf_cuda.fuse_blocks`);
* ``recon.objects``: `reconstruct_frames` calls;
* ``icp.graph_captures`` / ``icp.graph_replays``: the CUDA graphs pair ICP
  captured of its iteration (one a key of pair shapes and settings) and
  their launches (one an iteration; over ``icp.iterations``, the share of
  iterations a graph carried), in `kernels/icp.icp_plane_annealed`;
* ``weld.packed`` / ``weld.lexsort``: card welds that sorted one packed
  key, or three chained keys (`kernels/marching._weld_device`);
* ``load.bytes`` / ``load.frames`` / ``load.pooled``: the bytes of the
  colour, depth and pose files `CaptureDataset.load_object` read, the
  frames it loaded, and those of them loaded on its pool of host threads
  (over ``load.frames``, how often the pool engaged);
* ``track.frames`` / ``track.iterations``: the frames the frame-to-model
  tracker solved and its Gauss-Newton iterations (a fixed number a
  frame), in `pipeline/refine.refine_trajectory_f2m`;
* ``pgo.loop_candidates`` / ``pgo.loop_edges``: the frame pairs near
  enough to be loop closures and those that pair ICP verified
  (`refine.detect_loop_closures`); ``pgo.edges`` / ``pgo.iterations``:
  the chain and loop edges of a pose graph and its Gauss-Newton
  iterations (`refine._pgo_poses`).

Spans (`span(name)`) are kept only while a `recording()` is open: each
keeps ``[name, parent, t0_ns, t1_ns]``, its parent being the innermost
span open when it started, on the clock torch.profiler stamps its events
with (`time.time_ns`, nanoseconds since the epoch), and, while a profiler
records, opens a ``torch.profiler.record_function`` range of the same name
around its interval (outside a profile a range is never seen, and opening
one takes ~10 us, time no span would cover). A span adds no device sync. Outside a recorder a span is one
module-global check that returns a shared null context. Counters and the
recorder are process-wide: a recorder keeps the spans of every thread,
so open one at a time, around work on one thread, and read counters
made on several threads at once as approximate (an add is not atomic).

`StageTimer` times named stages on the same span, recorder or not:

    with StageTimer() as t:
        with t.stage("fuse", sync=True):
            vol = integrate_frames_sparse(...)
    t.totals["fuse"], t.counts["fuse"]

``sync=True`` waits for the card's queued work
(``torch.cuda.synchronize``) before the stage's clock stops.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

COUNTS: dict = defaultdict(int)

_NULL = contextlib.nullcontext()
_REC: Recorder | None = None


def count(name: str, n: int = 1) -> None:
    """Add n to the process counter `name`."""
    COUNTS[name] += n


def waited(t: torch.Tensor) -> None:
    """Count one host wait on the card when `t` lives there (a `.item()`,
    `bool()`, `.tolist()` or `nonzero` of a card tensor)."""
    if t.is_cuda:
        COUNTS["syncs"] += 1


def drain(dev: torch.device) -> None:
    """While a recorder is open, wait for the work queued on the card
    `dev`, so that the open span holds it; otherwise nothing."""
    if _REC is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Span:
    """A host-clock interval named `name`, handed to `sink.end` when it
    closes, inside a profiler range of its name while a profiler records."""

    __slots__ = ("name", "sink", "parent", "rf", "t0")

    def __init__(self, name: str, sink):
        self.name = name
        self.sink = sink

    def __enter__(self):
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.parent = self.sink.begin(self.name)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.sink.end(self.name, self.parent, self.t0, t1)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class Recorder:
    """The spans and the counter changes of one call (see `recording`).

    `spans` lists ``[name, parent, t0_ns, t1_ns]`` in the order they
    closed; `counts()` is the change of every process counter since the
    recorder opened (counters that did not move left out)."""

    def __init__(self):
        self.spans: list = []
        self._open: list = []
        self._counts0 = dict(COUNTS)

    def begin(self, name: str):
        parent = self._open[-1] if self._open else None
        self._open.append(name)
        return parent

    def end(self, name: str, parent, t0: int, t1: int) -> None:
        self._open.pop()
        self.spans.append([name, parent, t0, t1])

    def seconds(self, name: str) -> float | None:
        """The summed seconds of the spans named `name`, None if none."""
        ns = [s[3] - s[2] for s in self.spans if s[0] == name]
        return 1e-9 * sum(ns) if ns else None

    def counts(self) -> dict:
        return {k: v - self._counts0.get(k, 0) for k, v in COUNTS.items()
                if v != self._counts0.get(k, 0)}


@contextlib.contextmanager
def recording():
    """Keep every span opened in the block in a new `Recorder`, which the
    block receives; the recorder open before it (if any) resumes after."""
    global _REC
    prev, rec = _REC, Recorder()
    _REC = rec
    try:
        yield rec
    finally:
        _REC = prev


def span(name: str):
    """A span named `name` in the open recorder; without one, a shared
    null context (nothing is allocated and no range is opened)."""
    if _REC is None:
        return _NULL
    return _Span(name, _REC)


class StageTimer:
    """Seconds and calls of named stages, each a span (in a profile, a
    range of its name), kept whether or not a recorder is open."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def begin(self, name: str):
        return None

    def end(self, name: str, parent, t0: int, t1: int) -> None:
        self.totals[name] += 1e-9 * (t1 - t0)
        self.counts[name] += 1

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = False):
        with _Span(name, self):
            try:
                yield
            finally:
                if sync and torch.cuda.is_available():
                    # the device work this stage queued counts toward it
                    torch.cuda.synchronize()
