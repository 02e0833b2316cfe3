"""Driver of the pose-graph recon cell: per-object reconstruction with the
README's `--refine pgo` pose refinement (a frame-to-model tracked chain,
verified loop closures, a pose-graph solve), one object after another in
a closed loop (the cell recon.captures.pgo).

The requests are the estimated-pose cell's (drivers/recon_refine.py's
`requests`: each object's captures with a fresh planar localizer error,
the frames at the true poses). The window calls the program's
`reconstruct_frames(..., refine=cfg["refine"])` round after round; a
traced run also wraps the refiner (`REFINERS[refine]`) in a span, counts
K1's work lists (the tracking model's one-frame fusions among them) and
keeps a profiled stretch only when its K1 launches equal the work lists
counted and its nearest-neighbour scans (a verified loop's pair ICP) equal
the launches the program counted.

The judge holds each sampled answer to the plain reference
(reference/pgo.py) from the same noisy priors: the refined poses
(`pose_gap_m`, `pose_gap_rad`), and the cloud row for row against the
reference's cloud fused at the program's refined poses in a volume sized
from the priors (reference/refine.py's `fused_cloud`). For each judged
request it prints on standard error the trajectory error of the priors
and of the refined poses against the truth, and the reference's loop
candidates and verified loop edges; with the control on, also the
control's pose gaps on that request. A traced run prints the objects in
the profiled stretch it kept and whether its launch counts agreed.
"""

from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers.recon import K1, K1Counter, compare, program_config
from benchmark.drivers.recon_refine import (TRACE_TRIES, nn_launches,
                                            requests, stretch_counts)
from benchmark.inputs.captures import make_captures
from benchmark.reference import pgo as ref_pgo
from benchmark.reference import recon as reference
from benchmark.reference import refine as ref_refine
from benchmark.trace import Trace, kernel


def run(cfg, traffic, seed, seconds, trace, device, chips, t_start,
        control=False) -> dict:
    from otslam_tpu_torch.core.camera import PinholeIntrinsics
    from otslam_tpu_torch.pipeline import reconstruct as prog
    from otslam_tpu_torch.pipeline.dataset import FrameBatch
    from otslam_tpu_torch.pipeline.refine import trajectory_error

    pcfg = program_config(cfg)
    intr = PinholeIntrinsics.from_config(pcfg.camera)
    caps, rounds = make_captures(traffic, cfg["camera"], seed, device)
    request = requests(caps, traffic, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = torch.rand(pcfg.surface_samples, generator=gen, device=device)
    spans = harness.Spans(device, trace)
    originals, refiner = {}, prog.REFINERS[cfg["refine"]]
    if trace:
        for name in ("auto_volume_config", "fuse_frames",
                     "extract_filtered_cloud"):
            originals[name] = getattr(prog, name)
            setattr(prog, name, spans.wrap(name, originals[name]))
        prog.REFINERS[cfg["refine"]] = spans.wrap("refine", refiner)
    k1 = (K1Counter(cfg["camera"]["height"], cfg["camera"]["width"])
          if trace else None)

    def call(cap, timings=None):
        batch = FrameBatch(cap.depths, cap.colors, cap.extrinsics, cap.poses,
                           [f"{cap.name}_{i + 1}.jpg"
                            for i in range(len(cap.depths))])
        return prog.reconstruct_frames(
            batch, intr, pcfg, backend=cfg["backend"],
            output="cloud", auto_origin=cfg["auto_origin"],
            refine=cfg["refine"], device=device, draws=draws,
            timings=timings)

    failed = 0
    try:
        for name in traffic.get("warmup", traffic["objects"]):   # warm-up
            try:
                call(request(name)[0])
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
        stretch = None    # (start time, K1 work lists, objects) before it
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
                    stretch = (time.perf_counter(), len(k1.calls),
                               len(stages))
                    tries += 1
                timings = {} if trace else None
                cap, truth = request(name)
                tc = time.perf_counter()
                try:
                    res = call(cap, timings)
                except Exception as e:  # a failed answer; the window goes on
                    failed += 1
                    print(f"benchmark: {name} failed: {e!r}",
                          file=sys.stderr)
                    res = None
                te = time.perf_counter()
                if res is not None:
                    latencies.append(te - tc)
                    sample.offer(name, lambda r=res, c=cap, t=truth: (r, c, t))
                    if trace:
                        stages.append(timings)
                if stretch is not None and \
                        te - stretch[0] >= traffic["trace_seconds"]:
                    summary = tracer.stop()
                    summary["k1_calls"] = k1.calls[stretch[1]:]
                    summary.update(stretch_counts(stages[stretch[2]:]))
                    summary["objects"] = len(stages) - stretch[2]
                    last = summary
                    if (kernel(summary, K1)[0] == len(summary["k1_calls"])
                            and nn_launches(summary)
                            == summary["nn_calls"]):
                        chosen = summary
                    stretch = None
            if te >= deadline and stretch is None:
                break
        window_s = te - t0
        dev = harness.device_record(device, chips)
        if tracer is not None:
            held = chosen or last
            print(f"trace: {held['objects'] if held else 0} objects in the "
                  f"stretch kept, sound {chosen is not None}, {tries} tries",
                  file=sys.stderr)
    finally:
        for name, fn in originals.items():
            setattr(prog, name, fn)
        prog.REFINERS[cfg["refine"]] = refiner
        if k1 is not None:
            k1.close()

    # judge the sampled answers against the reference, the program's state
    # freed first
    if device.type == "cuda":
        torch.cuda.empty_cache()
    intr_r, params = reference.params_from_config(cfg)
    st = ref_pgo.settings_from_config(cfg)
    limits = {**cfg["limits"]["cloud"], **cfg["limits"]["poses"]}
    checks = harness.Checks(limits)
    ctl = harness.Checks(limits) if control else None
    refs, clouds = {}, {}

    def judge(into, cap, ref_ext, ext, cloud):
        gaps = ref_refine.pose_gaps(ext, ref_ext)
        for k, v in gaps.items():
            into.add(k, v)
        key = (cap.extrinsics.tobytes(), np.asarray(ext, np.float32).tobytes())
        if key not in clouds:
            clouds[key] = ref_refine.fused_cloud(cap, ext, intr_r, params,
                                                 draws, device)
        for k, v in compare(cloud, clouds[key], "cloud").items():
            into.add(k, v)
        return gaps

    for name, (res, cap, truth) in sample.items():
        key = cap.extrinsics.tobytes()
        if key not in refs:
            refs[key], rec = ref_pgo.refine_trajectory(cap, intr_r, params,
                                                       st, device)
            prior = trajectory_error(cap.extrinsics, truth.extrinsics)
            refined = trajectory_error(res.extrinsics, truth.extrinsics)
            print(f"trajectory {name}: prior {prior[0]:.6f} m "
                  f"{prior[1]:.6f} rad, refined {refined[0]:.6f} m "
                  f"{refined[1]:.6f} rad; loops: "
                  f"{rec['loop_candidates']} candidates, "
                  f"{rec['loop_edges']} edges", file=sys.stderr)
            if control:
                c_ext, _ = ref_pgo.refine_trajectory(
                    cap, intr_r, params, st, device, dtype=torch.bfloat16)
                c = ref_refine.fused_cloud(cap, c_ext, intr_r, params, draws,
                                           device, dtype=torch.bfloat16)
                gaps = judge(ctl, cap, refs[key], c_ext, SimpleNamespace(
                    points=c["points"], colors=c["colors"],
                    normals=c["normals"],
                    raw_surface_count=c["raw_surface_count"]))
                print(f"control {name}: {gaps['pose_gap_m']:.6g} m "
                      f"{gaps['pose_gap_rad']:.6g} rad", file=sys.stderr)
        judge(checks, cap, refs[key], res.extrinsics, res)
    return {"setup_s": setup_s, "window_s": window_s,
            "attempted": len(latencies) + failed, "failed": failed,
            "completed": len(latencies), "latencies": latencies,
            "stages": stages, "trace": chosen or last,
            "trace_sound": chosen is not None, "trace_tries": tries,
            "device": dev, "checks": checks, "control": ctl,
            "judged": len(sample.items())}
