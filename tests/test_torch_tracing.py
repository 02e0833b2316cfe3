"""The port's tracing (otslam_tpu_torch/utils/profiling.py): the span tree
and counter changes of one reconstruct_frames(timings=) call, the null
spans of an untraced call, and results equal either way (CPU); on a CUDA
card, the counters against what PyTorch and the profiler see (tests
marked `cuda`, which skip elsewhere).

This file imports neither jax nor otslam_tpu; on the card run it with

    python -m pytest --noconftest -q tests/test_torch_tracing.py
"""

import warnings
from collections import Counter

import numpy as np
import pytest
import torch

from otslam_tpu_torch.config import (CameraConfig, ReconstructionConfig,
                                     TSDFConfig)
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.device import to_f32, to_host
from otslam_tpu_torch.pipeline import reconstruct as rc
from otslam_tpu_torch.pipeline.dataset import FrameBatch
from otslam_tpu_torch.sim.sensors import look_at_pose, render_rgbd
from otslam_tpu_torch.sim.world import cardboard_room
from otslam_tpu_torch.utils import profiling
from otslam_tpu_torch.utils.profiling import COUNTS

CAM = CameraConfig(width=160, height=120, fx=141.400225, fy=141.400225,
                   cx=80.5, cy=60.5)
INTR = PinholeIntrinsics.from_config(CAM)
CFG = ReconstructionConfig(
    surface_samples=4000, camera=CAM,
    tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, dims=(64, 64, 32),
                    origin=(0.86, -0.14, -0.02)))

TREE = {
    "cloud": {"recon.object": None, "recon.auto_volume": "recon.object",
              "recon.fuse": "recon.object", "recon.extract": "recon.object",
              "fuse.upload": "recon.fuse", "fuse.volume": "recon.fuse",
              "fuse.schedule": "recon.fuse",
              "fuse.pack": "recon.fuse", "fuse.k1": "recon.fuse",
              "extract.surface": "recon.extract",
              "extract.sample": "recon.extract",
              "extract.to_host": "recon.extract",
              "extract.floor": "recon.extract"},
}
TREE["mesh"] = {k: v for k, v in TREE["cloud"].items()
                if k not in ("extract.surface", "extract.sample",
                             "extract.floor")}
TREE["mesh"].update({"extract.march": "recon.extract",
                     "extract.weld": "recon.extract"})
PROGRAM_RANGES = set(TREE["cloud"]) | set(TREE["mesh"])


@pytest.fixture(scope="module")
def batch():
    """8 host frames of a capture circle around the cardboard box, as
    CaptureDataset.load_object returns them."""
    c = np.array([1.5, 0.5, 0.15])
    ds, cs, es = [], [], []
    for i in range(8):
        a = 2 * np.pi * i / 8
        pose = look_at_pose([c[0] + np.cos(a), c[1] + np.sin(a), 0.5], c)
        d, col = render_rgbd(cardboard_room(), pose, INTR, far=5.0,
                             device="cpu")
        ds.append(torch.where(d <= 3.0, d, 0.0).numpy())
        cs.append(col.numpy())
        es.append(np.linalg.inv(pose).astype(np.float32))
    return FrameBatch(np.stack(ds), np.stack(cs), np.stack(es),
                      np.stack(es).astype(np.float64),
                      [f"Object_0_{i + 1}.jpg" for i in range(8)])


def reconstruct(batch, output, device="cpu", timings=None):
    return rc.reconstruct_frames(batch, INTR, CFG, output=output,
                                 auto_origin=True, device=device,
                                 timings=timings)


def same_result(a, b):
    for k in ("points", "colors", "normals", "faces"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert a.raw_surface_count == b.raw_surface_count


def check_tree(spans, output):
    """Each span once, under its parent, inside its parent's interval."""
    by = {s[0]: s for s in spans}
    assert sorted(s[0] for s in spans) == sorted(TREE[output])
    for name, parent, t0, t1 in spans:
        assert parent == TREE[output][name] and t0 <= t1
        if parent is not None:
            assert by[parent][2] <= t0 and t1 <= by[parent][3]


# --- CPU ---------------------------------------------------------------------

@pytest.mark.parametrize("output", ["cloud", "mesh"])
def test_one_call_gives_the_span_tree_and_its_counts(batch, output):
    timings = {}
    res = reconstruct(batch, output, timings=timings)
    assert list(timings) == ["auto_volume", "fuse", "extract", "trace"]
    rec = timings["trace"]
    check_tree(rec["spans"], output)
    assert rec["frames"] == res.num_frames == 8
    assert rec["object"] == COUNTS["recon.objects"]
    by = {s[0]: s for s in rec["spans"]}
    for stage in ("auto_volume", "fuse", "extract"):
        s = by["recon." + stage]
        assert timings[stage] == pytest.approx(1e-9 * (s[3] - s[2]))
    # one K1 work list; the CPU makes no copy to or from a card and waits
    # on none
    counts = rec["counts"]
    assert counts["k1_blocks"] > 0 and counts["k1_pairs"] >= \
        counts["k1_blocks"]
    assert not {"h2d_bytes", "d2h_bytes", "syncs"} & set(counts)
    assert not any(k.startswith("launches.") for k in counts)


def test_untraced_call_opens_no_recorder_and_no_range(batch, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    def refused():
        raise AssertionError("a recorder was opened")
    monkeypatch.setattr(rc, "recording", refused)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for output in ("cloud", "mesh"):
            reconstruct(batch, output)
    assert not PROGRAM_RANGES & {e.name for e in prof.events()}
    assert profiling.span("fuse.upload") is profiling.span("extract.weld")
    # a traced call under the same profile shows each span as a range
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reconstruct(batch, "mesh", timings={})
    assert set(TREE["mesh"]) <= {e.name for e in prof.events()}


@pytest.mark.parametrize("output", ["cloud", "mesh"])
def test_results_are_bit_identical_traced_or_not(batch, output):
    same_result(reconstruct(batch, output),
                reconstruct(batch, output, timings={}))


def test_recorders_nest_and_count_changes():
    before = profiling._REC
    with profiling.recording() as outer:
        with profiling.span("a"):
            profiling.count("test.tracing", 3)
            with profiling.recording() as inner:
                with profiling.span("b"):
                    pass
            with profiling.span("c"):
                pass
    assert profiling._REC is before
    assert [s[:2] for s in outer.spans] == [["c", "a"], ["a", None]]
    assert [s[:2] for s in inner.spans] == [["b", None]]
    assert outer.counts() == {"test.tracing": 3} and inner.counts() == {}
    assert outer.seconds("a") >= outer.seconds("c") >= 0
    assert outer.seconds("b") is None


def test_host_tensors_count_no_copy_or_wait():
    before = dict(COUNTS)
    x = to_f32(np.ones((4, 3)), torch.device("cpu"))
    assert np.array_equal(to_host(x), np.ones((4, 3), np.float32))
    profiling.waited(x)
    assert dict(COUNTS) == before


# --- the card ----------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def frame_bytes(batch) -> int:
    return sum(4 * np.asarray(a).size
               for a in (batch.depths, batch.colors, batch.extrinsics))


@pytest.mark.cuda
@pytest.mark.parametrize("output", ["cloud", "mesh"])
def test_syncs_are_the_waits_pytorch_reports(dev, batch, output):
    """One untraced call: the `syncs` counter equals the synchronizing
    calls torch.cuda.set_sync_debug_mode reports (a pageable upload, a
    nonzero, an item, a copy to the host)."""
    reconstruct(batch, output, dev)                  # builds, warms up
    torch.cuda.synchronize()
    before = COUNTS["syncs"]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        del seen[:]             # the mode's own notice, the first time on
        try:
            reconstruct(batch, output, dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = [w for w in seen if "synchroniz" in str(w.message)]
    where = Counter(f"{w.filename}:{w.lineno}" for w in waits)
    assert COUNTS["syncs"] - before == len(waits), where


@pytest.mark.cuda
@pytest.mark.parametrize("output", ["cloud", "mesh"])
def test_upload_bytes_are_the_frames_float32_bytes(dev, batch, output):
    timings = {}
    reconstruct(batch, output, dev, timings)
    counts = timings["trace"]["counts"]
    if output == "cloud":
        assert counts["h2d_bytes"] == frame_bytes(batch)
    else:                     # and marching's tables, 9 668 bytes
        assert 0 < counts["h2d_bytes"] - frame_bytes(batch) < 16384
    assert counts["d2h_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("output", ["cloud", "mesh"])
def test_span_starts_are_their_profiler_ranges(dev, batch, output):
    """Each span starts within 0.1 ms of its record_function range in a
    profile of the card."""
    from torch.profiler import ProfilerActivity, profile
    reconstruct(batch, output, dev)
    timings = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        reconstruct(batch, output, dev, timings)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = {e.name: t0 + 1e3 * e.time_range.start for e in prof.events()
              if e.name in PROGRAM_RANGES
              and e.device_type == torch.autograd.DeviceType.CPU}
    spans = timings["trace"]["spans"]
    assert set(ranges) == {s[0] for s in spans}
    gaps = {s[0]: abs(s[2] - ranges[s[0]]) for s in spans}
    assert max(gaps.values()) < 1e5, gaps


@pytest.mark.cuda
def test_k1_counts_are_the_work_lists_and_the_launches(dev, batch):
    """The program's K1 counts against the benchmark's K1Counter around
    active_worklist and the profile's fuse_kernel launches."""
    from benchmark.drivers.recon import K1, K1Counter
    from benchmark.trace import Trace, kernel
    reconstruct(batch, "cloud", dev)
    before = dict(COUNTS)
    k1 = K1Counter(CAM.height, CAM.width)
    tracer = Trace(dev)
    try:
        tracer.start()
        for _ in range(3):
            reconstruct(batch, "cloud", dev, {})
        summary = tracer.stop()
    finally:
        k1.close()

    def grew(name):
        return COUNTS[name] - before.get(name, 0)
    assert grew("launches.otslam_fuse") == len(k1.calls) == 3
    assert kernel(summary, K1)[0] == 3
    assert grew("k1_blocks") == sum(c[0] for c in k1.calls)
    assert grew("k1_pairs") == sum(c[1] for c in k1.calls)


@pytest.mark.cuda
def test_the_benchmark_counts_no_program_range_as_device_time(dev, batch):
    from benchmark.trace import Trace
    reconstruct(batch, "mesh", dev)
    tracer = Trace(dev)
    tracer.start()
    reconstruct(batch, "mesh", dev, {})
    summary = tracer.stop()
    assert not PROGRAM_RANGES & set(summary["kernels"])
    assert 0 < summary["busy_s"] <= summary["window_s"]
