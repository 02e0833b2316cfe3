"""Driver of the recon cells: per-object offline reconstruction, one object
after another in a closed loop.

The window calls the program's `reconstruct_frames` on host frame batches
(what `CaptureDataset.load_object` returns) with the configuration's
settings, round after round (every object of the traffic once a round, in
a seeded order), until `seconds` have passed; the round that crosses the
end finishes and counts, so every seed asks for the same work. Each call's latency
runs from the call to its return, with the result on the host.

A traced run passes `timings=` (a device sync after each stage), opens a
profiler range around each stage, counts K1's calls and work lists, and
profiles the first stretch of the window: a stretch whose K1 launch count
differs from the calls counted lost launches and is taken again, up to
six times.
"""

from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace

import numpy as np

from benchmark import harness
from benchmark.inputs.captures import make_captures
from benchmark.reference import recon as reference
from benchmark.trace import Trace, kernel

K1 = "fuse_kernel"       # K1's name in a trace (csrc/tsdf_fuse.cu)
TRACE_TRIES = 6


def program_config(cfg: dict):
    from otslam_tpu_torch.config import (CameraConfig, ReconstructionConfig,
                                         TSDFConfig)
    cam = cfg["camera"]
    t = cfg["tsdf"]
    return ReconstructionConfig(
        z_filter_threshold=cfg["z_filter_threshold"],
        surface_samples=cfg["surface_samples"],
        camera=CameraConfig(**cam),
        tsdf=TSDFConfig(voxel_size=t["voxel_size"], sdf_trunc=t["sdf_trunc"],
                        dims=tuple(t["dims"]), origin=tuple(t["origin"])))


class K1Counter:
    """Counts the fusion schedule's work lists, one K1 launch each, and
    keeps their sizes, around the program's `tsdf_cuda.active_worklist`."""

    def __init__(self, height: int, width: int):
        from otslam_tpu_torch.kernels import tsdf_cuda
        self.mod = tsdf_cuda
        self.orig = tsdf_cuda.active_worklist
        self.calls: list = []

        def counted(active):
            ids, ptr, frames = self.orig(active)
            self.calls.append((int(ids.shape[0]), int(frames.shape[0]),
                               int(active.shape[0]), height, width))
            return ids, ptr, frames
        tsdf_cuda.active_worklist = counted

    def close(self):
        self.mod.active_worklist = self.orig


def compare(prog, ref: dict, output: str) -> dict:
    """The gaps between the program's result and the reference's, row for
    row (both sides sample with the same draws, so a sound run serves the
    reference's rows in its order): the counts' differences, and the
    widest point (or vertex), colour and normal gaps over the rows both
    hold."""
    pts = np.asarray(prog.points, np.float64)
    rpts = np.asarray(ref["vertices" if output == "mesh" else "points"],
                      np.float64)
    n = min(len(pts), len(rpts))

    def widest(a, b):
        a, b = np.asarray(a, np.float64)[:n], np.asarray(b, np.float64)[:n]
        return float(np.abs(a - b).max()) if n else 0.0
    out = {"color_gap": widest(prog.colors, ref["colors"]),
           "normal_gap": widest(prog.normals, ref["normals"])}
    gap = float(np.linalg.norm(pts[:n] - rpts[:n], axis=1).max()) if n \
        else 0.0
    if output == "mesh":
        f, rf = np.asarray(prog.faces), np.asarray(ref["faces"])
        out.update({
            "vertex_count_gap": abs(len(pts) - len(rpts)),
            "face_count_gap": abs(len(f) - len(rf)),
            "faces_differing": (int(np.any(f != rf, axis=1).sum())
                                if f.shape == rf.shape else len(rf)),
            "vertex_gap_m": gap})
    else:
        out.update({"raw_count_gap": abs(prog.raw_surface_count
                                         - ref["raw_surface_count"]),
                    "point_count_gap": abs(len(pts) - len(rpts)),
                    "point_gap_m": gap})
    return out


def run(cfg, traffic, seed, seconds, trace, device, chips, t_start,
        control=False) -> dict:
    import torch
    from otslam_tpu_torch.core.camera import PinholeIntrinsics
    from otslam_tpu_torch.pipeline import reconstruct as prog
    from otslam_tpu_torch.pipeline.dataset import FrameBatch

    output = traffic["output"]
    pcfg = program_config(cfg)
    intr = PinholeIntrinsics.from_config(pcfg.camera)
    caps, rounds = make_captures(traffic, cfg["camera"], seed, device)
    batches = {n: FrameBatch(c.depths, c.colors, c.extrinsics, c.poses,
                             [f"{n}_{i + 1}.jpg" for i in range(len(c.depths))])
               for n, c in caps.items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = torch.rand(pcfg.surface_samples, generator=gen, device=device)
    spans = harness.Spans(device, trace)
    originals = {}
    if trace:
        for name in ("auto_volume_config", "fuse_frames",
                     "extract_filtered_cloud", "extract_mesh"):
            originals[name] = getattr(prog, name)
            setattr(prog, name, spans.wrap(name, originals[name]))
    k1 = (K1Counter(cfg["camera"]["height"], cfg["camera"]["width"])
          if trace else None)

    def call(name, timings=None):
        return prog.reconstruct_frames(
            batches[name], intr, pcfg, backend=cfg["backend"],
            output=output, auto_origin=cfg["auto_origin"], device=device,
            draws=draws, timings=timings)

    failed = 0
    for name in traffic.get("warmup", traffic["objects"]):   # warm-up
        try:
            call(name)
        except Exception as e:         # counts against the run
            failed += 1
            print(f"benchmark: warm-up {name} failed: {e!r}", file=sys.stderr)
    harness.sync(device)
    setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    sample = harness.Reservoir(traffic["judged_per_object"], seed)
    latencies, stages = [], []
    tracer = Trace(device) if trace and device.type == "cuda" else None
    stretch = None          # (start time, K1 work lists counted before it)
    chosen = last = None
    tries = 0
    gc.collect()                       # the window starts from a clean heap
    t0 = time.perf_counter()
    deadline = t0 + seconds
    for rnd in rounds:
        for name in rnd:
            if tracer is not None and stretch is None and chosen is None \
                    and tries < TRACE_TRIES:
                tracer.start()
                stretch = (time.perf_counter(), len(k1.calls))
                tries += 1
            timings = {} if trace else None
            tc = time.perf_counter()
            try:
                res = call(name, timings)
            except Exception as e:     # a failed answer; the window goes on
                failed += 1
                print(f"benchmark: {name} failed: {e!r}", file=sys.stderr)
                res = None
            te = time.perf_counter()
            if res is not None:
                latencies.append(te - tc)
                sample.offer(name, lambda r=res: r)
                if trace:
                    stages.append(timings)
            if stretch is not None and \
                    te - stretch[0] >= traffic["trace_seconds"]:
                summary = tracer.stop()
                calls = k1.calls[stretch[1]:]
                summary["k1_calls"] = calls
                last = summary
                if kernel(summary, K1)[0] == len(calls):
                    chosen = summary
                stretch = None
        if te >= deadline and stretch is None:
            break
    window_s = te - t0
    dev = harness.device_record(device, chips)
    for name, fn in originals.items():
        setattr(prog, name, fn)
    if k1 is not None:
        k1.close()

    # judge the sampled answers against the reference, the program's state
    # freed first
    if device.type == "cuda":
        torch.cuda.empty_cache()
    intr_r, params = reference.params_from_config(cfg)
    checks = harness.Checks(cfg["limits"][output])
    ctl = harness.Checks(cfg["limits"][output]) if control else None
    refs = {}
    for name, res in sample.items():
        if name not in refs:
            refs[name] = reference.reconstruct(caps[name], intr_r, params,
                                               draws, device, output)
            if control:
                c = reference.reconstruct(caps[name], intr_r, params, draws,
                                          device, output,
                                          dtype=torch.bfloat16)
                as_prog = SimpleNamespace(
                    points=c["vertices" if output == "mesh" else "points"],
                    faces=c.get("faces"), colors=c["colors"],
                    normals=c["normals"],
                    raw_surface_count=c.get("raw_surface_count"))
                for k, v in compare(as_prog, refs[name],
                                    output).items():
                    ctl.add(k, v)
        for k, v in compare(res, refs[name], output).items():
            checks.add(k, v)
    return {"setup_s": setup_s, "window_s": window_s,
            "attempted": len(latencies) + failed, "failed": failed,
            "completed": len(latencies), "latencies": latencies,
            "stages": stages, "trace": chosen or last,
            "trace_sound": chosen is not None, "trace_tries": tries,
            "device": dev, "checks": checks, "control": ctl,
            "judged": len(sample.items())}

