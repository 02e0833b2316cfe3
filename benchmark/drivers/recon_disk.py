"""Driver of the on-disk recon cell: the `reconstruct` command's path, from
the scanner's capture folder to each object's cloud on the host, one
object after another in a closed loop.

At set-up the recon cells' captures from the seed (inputs/disk.py) are
written once, with OpenCV, in the scanner's layout into a fresh folder
under $TMPDIR, which the run deletes at its end; one warm-up round then
reads every object once. Every request is the program's

    reconstruct_object(CaptureDataset(folder, camera), label, cfg,
                       save_dir=None, output="cloud", auto_origin=...)

which lists, reads, decodes and stacks the object's frames, then fuses
and extracts them as the recon cells do; no PLY is written. Rounds, the
window and latencies are drivers/recon.py's.

A traced run hands the call `timings=`, so the load's spans and the
stages' land in one record. A program whose `reconstruct_object` takes no
`timings=` is traced through its own composition, `load_object` and then
`reconstruct_frames(timings=)`; its record then holds no load spans, and
their readers report nothing. drivers/recon.py's stage wrappers, K1 count
and profiled stretch are kept, with the load wrapped too, so idle gaps are
labelled by it; a stretch counts only where K1's launches equal the work
lists counted.

The judge reads each sampled object's files again with the plain reader
(reference/disk.py: PIL and NumPy) and fuses them with the plain reference
(reference/recon.py): the cloud row for row under the configuration's
`cloud` limits, and the returned extrinsics against the reader's parse
(`extrinsics_gap`). The program's own load of each judged object is set
against the reader's planes on standard error (`planes ...`).
"""

from __future__ import annotations

import gc
import inspect
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from benchmark import harness
from benchmark.drivers.recon import K1, K1Counter, compare, program_config
from benchmark.inputs import disk
from benchmark.reference import disk as ref_disk
from benchmark.reference import recon as reference
from benchmark.trace import Trace, kernel

STAGE_WRAPS = ("auto_volume_config", "fuse_frames", "extract_filtered_cloud")
TRACE_TRIES = 6


def run(cfg, traffic, seed, seconds, trace, device, chips, t_start,
        control=False) -> dict:
    caps, rounds = disk.scanner_captures(traffic, cfg["camera"], seed,
                                         device)
    root = tempfile.mkdtemp(prefix="recon_disk_")
    try:
        folder = os.path.join(root, "captures")
        disk.write_folder(caps, folder, cfg["camera"]["depth_scale"])
        del caps
        return _run(cfg, traffic, seed, seconds, trace, device, chips,
                    t_start, control, rounds, folder)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def extrinsics_gap(ext, ref_ext) -> float:
    a, b = np.asarray(ext, np.float64), np.asarray(ref_ext, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max())


def plane_gaps(batch, cap) -> dict:
    """The program's loaded planes against the plain reader's: the widest
    depth and colour differences and the share of colour values that
    differ."""
    if batch.depths.shape != cap.depths.shape \
            or batch.colors.shape != cap.colors.shape:
        return {"shapes_differ": True}
    dc = np.abs(batch.colors - cap.colors)
    return {"depth_gap_m": float(np.abs(batch.depths - cap.depths).max()),
            "color_gap": float(dc.max()),
            "color_differing": float((dc > 0).mean())}


def _run(cfg, traffic, seed, seconds, trace, device, chips, t_start,
         control, rounds, folder) -> dict:
    import torch
    from otslam_tpu_torch.core.camera import PinholeIntrinsics
    from otslam_tpu_torch.pipeline import reconstruct as prog
    from otslam_tpu_torch.pipeline.dataset import CaptureDataset

    pcfg = program_config(cfg)
    ds = CaptureDataset(folder, camera=pcfg.camera)
    intr = PinholeIntrinsics.from_config(pcfg.camera)
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = torch.rand(pcfg.surface_samples, generator=gen, device=device)
    whole = "timings" in inspect.signature(prog.reconstruct_object).parameters
    spans = harness.Spans(device, trace)
    originals = {}
    if trace:
        for name in STAGE_WRAPS:
            originals[name] = getattr(prog, name)
            setattr(prog, name, spans.wrap(name, originals[name]))
        ds.load_object = spans.wrap("load_object", ds.load_object)
    k1 = (K1Counter(cfg["camera"]["height"], cfg["camera"]["width"])
          if trace else None)
    kw = dict(output="cloud", auto_origin=cfg["auto_origin"], device=device,
              draws=draws)

    def call(name, timings=None):
        if timings is None or whole:
            extra = {} if timings is None else {"timings": timings}
            return prog.reconstruct_object(ds, name, pcfg, cfg["backend"],
                                           save_dir=None, **kw, **extra)
        return prog.reconstruct_frames(ds.load_object(name), intr, pcfg,
                                       cfg["backend"], timings=timings, **kw)

    failed = 0
    try:
        for name in traffic.get("warmup", traffic["objects"]):   # warm-up
            try:
                call(name)
            except Exception as e:     # counts against the run
                failed += 1
                print(f"benchmark: warm-up {name} failed: {e!r}",
                      file=sys.stderr)
        harness.sync(device)
        setup_s = time.perf_counter() - t_start
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

        sample = harness.Reservoir(traffic["judged_per_object"], seed)
        latencies, stages = [], []
        tracer = Trace(device) if trace and device.type == "cuda" else None
        stretch = None        # (start time, K1 work lists counted before it)
        chosen = last = None
        tries = 0
        gc.collect()                   # the window starts from a clean heap
        t0 = time.perf_counter()
        deadline = t0 + seconds
        for rnd in rounds:
            for name in rnd:
                if tracer is not None and stretch is None \
                        and chosen is None and tries < TRACE_TRIES:
                    tracer.start()
                    stretch = (time.perf_counter(), len(k1.calls))
                    tries += 1
                timings = {} if trace else None
                tc = time.perf_counter()
                try:
                    res = call(name, timings)
                except Exception as e:  # a failed answer; the window goes on
                    failed += 1
                    print(f"benchmark: {name} failed: {e!r}",
                          file=sys.stderr)
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
    finally:
        for name, fn in originals.items():
            setattr(prog, name, fn)
        if k1 is not None:
            k1.close()

    # judge the sampled answers against the plain reader and reference,
    # the program's state freed first
    if device.type == "cuda":
        torch.cuda.empty_cache()
    intr_r, params = reference.params_from_config(cfg)
    limits = {**cfg["limits"]["cloud"], **cfg["limits"]["poses"]}
    checks = harness.Checks(limits)
    ctl = harness.Checks(limits) if control else None
    loader = CaptureDataset(folder, camera=pcfg.camera)   # unwrapped
    refs = {}
    for name, res in sample.items():
        if name not in refs:
            cap = ref_disk.read_object(folder, name, cfg["camera"])
            refs[name] = (cap, reference.reconstruct(
                cap, intr_r, params, draws, device, "cloud"))
            gaps = plane_gaps(loader.load_object(name), cap)
            print(f"planes {name}: {gaps}", file=sys.stderr)
            if control:
                c = reference.reconstruct(cap, intr_r, params, draws, device,
                                          "cloud", dtype=torch.bfloat16)
                as_prog = SimpleNamespace(
                    points=c["points"], colors=c["colors"],
                    normals=c["normals"],
                    raw_surface_count=c["raw_surface_count"])
                for k, v in compare(as_prog, refs[name][1], "cloud").items():
                    ctl.add(k, v)
                ctl.add("extrinsics_gap", extrinsics_gap(
                    [ref_disk.extrinsic(p, torch.bfloat16)
                     for p in cap.poses], cap.extrinsics))
        cap, ref = refs[name]
        for k, v in compare(res, ref, "cloud").items():
            checks.add(k, v)
        checks.add("extrinsics_gap", extrinsics_gap(res.extrinsics,
                                                    cap.extrinsics))
    return {"setup_s": setup_s, "window_s": window_s,
            "attempted": len(latencies) + failed, "failed": failed,
            "completed": len(latencies), "latencies": latencies,
            "stages": stages, "trace": chosen or last,
            "trace_sound": chosen is not None, "trace_tries": tries,
            "device": dev, "checks": checks, "control": ctl,
            "judged": len(sample.items())}

