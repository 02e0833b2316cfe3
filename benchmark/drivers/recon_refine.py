"""Driver of the estimated-pose recon cell: per-object reconstruction with
ICP pose refinement, one object after another in a closed loop.

The inputs are the recon cells' captures as inputs/captures.py's
`make_captures` makes them from the seed (each object's seeded start
angle, the rounds in a seeded order), with the poses a 2D localizer
reports: each capture's body pose moved by a planar error, (dx, dy)
uniform in a disc of radius `pose_noise_xy_m` and a yaw uniform in
+-`pose_noise_yaw_rad`, drawn from a generator of its own seeded from the
seed (the captures' own draws stay as they are). The frames are rendered
at the true poses; the extrinsics and pose files carry the noisy ones.
Every request draws its own error, as every mission's captures of an
object carry their own localizer's error.

The window calls the program's `reconstruct_frames(..., refine=cfg
["refine"])` round after round as drivers/recon.py does; a traced run
also wraps the refiner (`REFINERS[refine]`) in a span, and keeps a
profiled stretch only when its K1 launches equal the work lists counted
and its nearest-neighbour scans (K3, K4) equal the launches the program
counted (`launches.otslam_nn`, `launches.otslam_nn_window`).

The judge holds each sampled answer to the plain reference
(reference/refine.py) from the same noisy priors: the refined poses
(`pose_gap_m`, `pose_gap_rad`), and the cloud row for row against the
reference's cloud fused at the program's refined poses in a volume sized
from the priors, as `reconstruct_frames` sizes it before refining.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers.recon import K1, K1Counter, compare, program_config
from benchmark.inputs.captures import T_FIX_OPTICAL, make_captures
from benchmark.reference import recon as reference
from benchmark.reference import refine as ref_refine
from benchmark.trace import Trace, kernel

NN_KERNELS = ("nn_kernel", "nn_window_kernel")   # K3, K4 (csrc/nn.cu)
NN_LAUNCHES = ("launches.otslam_nn", "launches.otslam_nn_window")
NN_COUNTERS = NN_LAUNCHES + ("nn.pairs", "nn.window_pairs", "nn.window_scans")
TRACE_TRIES = 6
NOISE_STREAM = 0x5EF1        # the pose noise's own generator, by the seed


def noisy(cap, rng, xy: float, yaw: float):
    """cap with each pose moved by a planar localization error: the body
    (and so the camera, whose centre it shares) shifted by (dx, dy) in a
    disc of radius xy and turned about the vertical by a yaw in +-yaw."""
    exts, poses = [], []
    for pose in np.asarray(cap.poses, np.float64):
        optical = pose @ T_FIX_OPTICAL      # pose files: optical @ FIX^T
        r = xy * np.sqrt(rng.uniform())
        a = rng.uniform(0.0, 2 * np.pi)
        dyaw = rng.uniform(-yaw, yaw)
        c, s = np.cos(dyaw), np.sin(dyaw)
        moved = optical.copy()
        moved[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) \
            @ optical[:3, :3]
        moved[:2, 3] += (r * np.cos(a), r * np.sin(a))
        exts.append(np.linalg.inv(moved).astype(np.float32))
        poses.append(moved @ T_FIX_OPTICAL.T)
    return dataclasses.replace(cap, extrinsics=np.stack(exts),
                               poses=np.stack(poses))


def requests(caps: dict, traffic: dict, seed: int):
    """request(name) -> (the capture of `name` at poses with a fresh error,
    the capture at its true poses)."""
    rng = np.random.default_rng([seed, NOISE_STREAM])

    def request(name):
        truth = caps[name]
        return noisy(truth, rng, traffic["pose_noise_xy_m"],
                     traffic["pose_noise_yaw_rad"]), truth
    return request


def stretch_counts(stages) -> dict:
    """The program's nearest-neighbour counters summed over a stretch's
    objects (0 where the program keeps none), and the K3 and K4 launches
    among them."""
    counts = [t["trace"]["counts"] for t in stages
              if isinstance(t.get("trace"), dict)]
    nn = {k: sum(c.get(k, 0) for c in counts) for k in NN_COUNTERS}
    return {"nn": nn, "nn_calls": sum(nn[k] for k in NN_LAUNCHES)}


def nn_launches(summary) -> int:
    return sum(kernel(summary, k)[0] for k in NN_KERNELS)


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
    st = ref_refine.settings_from_config(cfg)
    limits = {**cfg["limits"]["cloud"], **cfg["limits"]["poses"]}
    checks = harness.Checks(limits)
    ctl = harness.Checks(limits) if control else None
    refs, clouds = {}, {}

    def judge(into, cap, ref_ext, ext, cloud):
        for k, v in ref_refine.pose_gaps(ext, ref_ext).items():
            into.add(k, v)
        key = (cap.extrinsics.tobytes(), np.asarray(ext, np.float32).tobytes())
        if key not in clouds:
            clouds[key] = ref_refine.fused_cloud(cap, ext, intr_r, params,
                                                 draws, device)
        for k, v in compare(cloud, clouds[key], "cloud").items():
            into.add(k, v)

    for name, (res, cap, truth) in sample.items():
        key = cap.extrinsics.tobytes()
        if key not in refs:
            refs[key], _ = ref_refine.refine_trajectory(cap, intr_r, st,
                                                        device)
            prior = trajectory_error(cap.extrinsics, truth.extrinsics)
            refined = trajectory_error(res.extrinsics, truth.extrinsics)
            print(f"trajectory {name}: prior {prior[0]:.6f} m "
                  f"{prior[1]:.6f} rad, refined {refined[0]:.6f} m "
                  f"{refined[1]:.6f} rad", file=sys.stderr)
            if control:
                c_ext, _ = ref_refine.refine_trajectory(
                    cap, intr_r, st, device, dtype=torch.bfloat16)
                c = ref_refine.fused_cloud(cap, c_ext, intr_r, params, draws,
                                           device, dtype=torch.bfloat16)
                judge(ctl, cap, refs[key], c_ext, SimpleNamespace(
                    points=c["points"], colors=c["colors"],
                    normals=c["normals"],
                    raw_surface_count=c["raw_surface_count"]))
        judge(checks, cap, refs[key], res.extrinsics, res)
    return {"setup_s": setup_s, "window_s": window_s,
            "attempted": len(latencies) + failed, "failed": failed,
            "completed": len(latencies), "latencies": latencies,
            "stages": stages, "trace": chosen or last,
            "trace_sound": chosen is not None, "trace_tries": tries,
            "device": dev, "checks": checks, "control": ctl,
            "judged": len(sample.items())}
