#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (otslam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles the CUDA kernels from otslam_tpu_torch/csrc/ with nvcc;
3. each kernel against its plain PyTorch version at the main path's shapes
   (64 VGA frames, 1 cm voxels, a 256^3 volume = 32768 blocks, and
   100k x 50k points), with CUDA-event times for both:
   K2 block classification (bit-identical), K1 block fusion (weights equal,
   tsdf <= 1e-5, colour <= 1e-3), K3 nearest neighbour (distances
   rel <= 1e-6, indices equal off ties);
4. main path: a 64-frame VGA capture circle of the cardboard room, rendered
   on the card, goes through reconstruct_frames (the body of
   reconstruct_object after dataset loading) with the default
   ReconstructionConfig and auto_volume_config, then write_ply -> read_ply
   -> evaluate_map against the 50k-point scenario GT; every kernel must
   have launched and the accuracy must be < 1 cm;
5. K4 windowed nearest neighbour against its plain version at 50k x 50k
   (bit-identical d^2 and index on every row) and against K3 (identical on
   every row whose nearest neighbour lies within the 0.05 m radius, >= the
   radius elsewhere), with CUDA-event times for K4, its plain version and
   K3;
6. registration path: the phase-4 capture with its poses drifted by
   compounding odometry noise goes through reconstruct_frames with
   refine="icp" and refine="pgo", then write_ply -> read_ply ->
   evaluate_map(use_icp=True); then ScanLocalizer registers a 1440-beam
   scan against the cardboard room's 0.05 m grid. K4 must have launched,
   pgo must lower the drifted trajectory's translation RMSE, and the scan
   must localize to < 4 cm and < 0.02 rad;
7. K5 ray casting against its plain version at the perception workload:
   1440 beams, range 10 m (200 steps), 64 poses in one call, on the
   cardboard room's 208^2 map and full_room's map (bit-identical keys and
   ranges), with CUDA-event times, hit beams and samples per second;
8. mission path: `python -m otslam_tpu_torch.cli mission` (through its
   main()) at the CLI's defaults (VGA camera, 1440 beams, 512^2 evidence
   grid, cardboard scenario) with --removed --localizer
   --perception-batch 8 for 300 ticks, then reconstruct_all (auto origin)
   over the mission's dataset and evaluate_map of Object_0 against the
   scenario GT. K5 must have launched, at least one stable object and 4
   missions, the removed-object check visited, every cloud non-empty and
   finite, and Object_0's accuracy < 2 cm.

Each path (phases 4, 6 and 8) is driven with the launch counters set to 0
just before it and read just after. Every kernel's record carries two
times: `ms`, CUDA events around the wrapper call (its host work included),
and `kernel_ms`, the kernel alone in a torch.profiler trace. It carries its
bound too: the larger of the bytes it must move over 3.35 TB/s and its f32
operations over 67 TFLOP/s (the H100 SXM's published peaks), at this run's
shapes and data. The line before the last two is the kernels' JSON record,
then the nvidia-smi name/power line; the last line is
{"ok": true, "device": {...}}. JAX and otslam_tpu are never imported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 64
CAPTURE_RADIUS = 1.0      # m, as eval/headline.py's capture circles
CAPTURE_HEIGHT = 0.5      # m
SRC_POINTS = 100_000      # the default surface_samples
GT_POINTS = 50_000        # the eval protocol's GT samples
NN_RADIUS = 0.05          # EvalConfig.icp_threshold
RAY_BEAMS = 1440          # LidarConfig.num_beams
RAY_POSES = 64            # one perception batch of K = 64 ticks
MISSION_TICKS = 300       # the mission CLI's --max-ticks default
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, setup=None, warmup: int = 1) -> float:
    """Mean CUDA-event milliseconds of fn() over `reps` runs; `setup` runs
    before each call, outside the timed window."""
    import torch
    for _ in range(warmup):
        if setup:
            setup()
        fn()
    total = 0.0
    for _ in range(reps):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def kernel_ms(fn, reps: int, kernel: str):
    """Device milliseconds per fn() call of the CUDA kernel named `kernel`,
    from a torch.profiler trace of `reps` calls after a warm-up: the kernel
    alone, without the wrapper's host time and the other launches that the
    event timing of cuda_ms includes. None when the trace holds no such
    kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and f"{kernel}(" in e.name]
    return sum(us) * 1e-3 / reps if us else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound(nbytes: float, ops: float) -> dict:
    """The least time for the work: the larger of its bytes over the
    card's memory rate and its f32 operations over its peak rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def cdist_min_ms(src, dst) -> float:
    """CUDA-event ms of torch.cdist(src, dst).min(dim=1), chunked over src
    so each distance block stays near 2 GB: the library call that computes
    K3's function (timed as a yardstick; the port never calls it)."""
    import torch
    rows = max(1, (1 << 29) // dst.shape[0])

    def run():
        for s in range(0, src.shape[0], rows):
            torch.cdist(src[s:s + rows], dst).min(dim=1)
    return cuda_ms(run, 3)


def render_capture(dev):
    """The capture circle as a dataset would hand it over: host arrays in a
    FrameBatch, depth truncated as CaptureDataset.load_object does."""
    import numpy as np
    import torch

    from otslam_tpu_torch.config import CameraConfig
    from otslam_tpu_torch.core.camera import PinholeIntrinsics
    from otslam_tpu_torch.pipeline.dataset import FrameBatch
    from otslam_tpu_torch.sim.sensors import look_at_pose, render_rgbd
    from otslam_tpu_torch.sim.world import cardboard_room

    cam = CameraConfig()                      # VGA, fx = fy = 565.6009
    intr = PinholeIntrinsics.from_config(cam)
    scene = cardboard_room()
    center = np.asarray(scene.objects[0].center, np.float64)
    depths, colors, exts, poses = [], [], [], []
    for i in range(N_FRAMES):
        a = 2 * np.pi * i / N_FRAMES
        eye = np.array([center[0] + CAPTURE_RADIUS * np.cos(a),
                        center[1] + CAPTURE_RADIUS * np.sin(a),
                        CAPTURE_HEIGHT])
        pose = look_at_pose(eye, center)
        d, c = render_rgbd(scene, pose, intr, far=cam.depth_max, device=dev)
        d = torch.where((d > 0) & (d <= cam.depth_trunc), d, 0.0)
        depths.append(d)
        colors.append(c)
        exts.append(np.linalg.inv(pose).astype(np.float32))
        poses.append(pose)
    batch = FrameBatch(torch.stack(depths).cpu().numpy(),
                       torch.stack(colors).cpu().numpy(), np.stack(exts),
                       np.stack(poses), [f"Object_0_{i + 1}.jpg"
                                         for i in range(N_FRAMES)])
    return batch, intr, scene


def phase_k2(meta, depths, exts, intr):
    import torch

    from otslam_tpu_torch.kernels import tsdf_cuda as tc
    from otslam_tpu_torch.kernels.tsdf_block import _depth_mips
    band_k, vis_k = tc.classify_blocks(meta, depths, exts, intr)
    band_p, vis_p = tc.classify_blocks_torch(meta, depths, exts, intr)
    torch.cuda.synchronize()
    mism = int((band_k != band_p).sum() + (vis_k != vis_p).sum())
    check(mism == 0, f"K2 disagrees with its plain version at {mism} pairs")
    ms = cuda_ms(lambda: tc.classify_blocks(meta, depths, exts, intr), 10)
    plain_ms = cuda_ms(
        lambda: tc.classify_blocks_torch(meta, depths, exts, intr), 10)
    # both include the torch depth mip pyramid; time it alone too
    mips_ms = cuda_ms(lambda: _depth_mips(depths), 10)
    dev_ms = kernel_ms(lambda: tc.classify_blocks(meta, depths, exts, intr),
                       10, "classify_kernel")
    n, nb = band_k.shape
    # depths read once, band and visible written once (a byte each); about
    # 55 f32 operations a (frame, block) pair (block centre, projection,
    # pixel slack, frustum and depth-bound tests)
    b = bound(depths.numel() * 4 + n * nb * 2 + exts.numel() * 4,
              55.0 * n * nb)
    log(f"K2 classify: {tuple(band_k.shape)} pairs, band {int(band_p.sum())}"
        f" visible {int(vis_p.sum())}, mismatches 0, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (both incl. the mips, {mips_ms:.4f} ms), "
        f"kernel alone {fmt_ms(dev_ms)}, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']})")
    return band_p, vis_p, {"max_abs_err": 0.0, "ms": ms,
                           "kernel_ms": dev_ms, "plain_ms": plain_ms, **b,
                           "library_ms": None}


def phase_k1(vol_cfg, band, vis, depths, colors, exts, intr):
    import torch

    from otslam_tpu_torch.kernels import tsdf_cuda as tc
    from otslam_tpu_torch.kernels.tsdf_block import make_block_volume, pack_rgb
    dev = depths.device
    ka = make_block_volume(vol_cfg, dev)
    pa = make_block_volume(vol_cfg, dev)
    nb = ka.num_blocks
    _, active = tc.created_and_active(band, vis, ka.created[:nb])
    ids, ptr, frames = tc.active_worklist(active)
    cpk = pack_rgb(colors)
    tc.fuse_blocks(ka, ids, ptr, frames, depths, cpk, exts, intr)
    tc.fuse_blocks_torch(pa, ids, ptr, frames, depths, cpk, exts, intr)
    torch.cuda.synchronize()
    w_eq = bool(torch.equal(ka.weight, pa.weight))
    check(w_eq, "K1 weights differ from the plain version: "
          f"{int((ka.weight != pa.weight).sum())} voxels")
    t_err = float((ka.tsdf - pa.tsdf).abs().max())
    c_err = float((ka.color - pa.color).abs().max())
    check(t_err <= 1e-5, f"K1 tsdf error {t_err} > 1e-5")
    check(c_err <= 1e-3, f"K1 colour error {c_err} > 1e-3")
    observed = int((pa.weight > 0).sum())

    def reset():
        for v in (ka, pa):
            v.tsdf.zero_()
            v.weight.zero_()
            v.color.zero_()
    ms = cuda_ms(lambda: tc.fuse_blocks(ka, ids, ptr, frames, depths, cpk,
                                        exts, intr), 5, setup=reset)
    plain_ms = cuda_ms(lambda: tc.fuse_blocks_torch(
        pa, ids, ptr, frames, depths, cpk, exts, intr), 3, setup=reset)
    dev_ms = kernel_ms(lambda: (reset(), tc.fuse_blocks(
        ka, ids, ptr, frames, depths, cpk, exts, intr)), 5, "fuse_kernel")
    # the listed blocks' 5 floats a voxel read and written once, the frames'
    # depth and packed colour read once; about 55 f32 operations a
    # (voxel, frame) pair (projection, rounding, sdf, four running means)
    pairs = frames.shape[0]
    b = bound(ids.shape[0] * 512 * 5 * 4 * 2 + depths.numel() * 4
              + cpk.numel() * 4 + exts.numel() * 4
              + (ids.numel() + ptr.numel() + pairs) * 4,
              55.0 * pairs * 512)
    log(f"K1 fuse: {ids.shape[0]} blocks, {pairs} (block, frame) "
        f"pairs, observed voxels {observed}, weights "
        f"equal, tsdf err {t_err:.3g}, colour err {c_err:.3g}, kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, kernel alone "
        f"{fmt_ms(dev_ms)}, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"max_abs_err": max(t_err, c_err), "ms": ms, "kernel_ms": dev_ms,
            "plain_ms": plain_ms, **b, "library_ms": None}


def phase_k3(dev):
    import numpy as np
    import torch

    from otslam_tpu_torch.eval.scenarios import scenario_gt
    from otslam_tpu_torch.kernels import nn
    gt = torch.as_tensor(scenario_gt("cardboard", GT_POINTS), device=dev)
    rng = np.random.default_rng(1)
    src_np = scenario_gt("cardboard", SRC_POINTS, seed=1) + rng.normal(
        0, 0.004, (SRC_POINTS, 3)).astype(np.float32)
    src = torch.as_tensor(src_np, device=dev)
    mask = torch.ones(GT_POINTS, dtype=torch.bool, device=dev)
    d_k, i_k = nn.nn_min(src, gt, mask)
    d_p, i_p = nn.nn_min_torch(src, gt, mask)
    torch.cuda.synchronize()
    rel = float(((d_k - d_p).abs() / d_p.clamp(min=1e-30)).max())
    check(rel <= 1e-6, f"K3 squared distances rel err {rel} > 1e-6")
    diff = i_k != i_p
    if bool(diff.any()):
        # an index may differ only at a tie: both candidates equally near
        dk = ((src[diff] - gt[i_k[diff]]) ** 2).sum(-1)
        dp = ((src[diff] - gt[i_p[diff]]) ** 2).sum(-1)
        check(bool(((dk - dp).abs() <= 1e-6 * dp).all()),
              "K3 indices differ off ties")
    dist_err = float((d_k.sqrt() - d_p.sqrt()).abs().max())
    ms = cuda_ms(lambda: nn.nn_min(src, gt, mask), 10)
    plain_ms = cuda_ms(lambda: nn.nn_min_torch(src, gt, mask), 3)
    dev_ms = kernel_ms(lambda: nn.nn_min(src, gt, mask), 10, "nn_kernel")
    lib_ms = cdist_min_ms(src, gt)
    # src, dst and the mask read once, d2 and index written once; 8 f32
    # operations a pair (3 differences, 3 squares, 2 sums)
    b = bound(SRC_POINTS * 12 + GT_POINTS * 13 + SRC_POINTS * 8,
              8.0 * SRC_POINTS * GT_POINTS)
    log(f"K3 nn: {SRC_POINTS} x {GT_POINTS}, rel err {rel:.3g}, index "
        f"mismatches {int(diff.sum())} (ties), kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, kernel alone {fmt_ms(dev_ms)}, "
        f"torch.cdist().min() {lib_ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"max_abs_err": dist_err, "ms": ms, "kernel_ms": dev_ms,
            "plain_ms": plain_ms, **b, "library_ms": lib_ms}


def phase_k4(dev):
    import numpy as np
    import torch

    from otslam_tpu_torch.eval.scenarios import scenario_gt
    from otslam_tpu_torch.kernels import nn
    gt_np = scenario_gt("cardboard", GT_POINTS)
    rng = np.random.default_rng(1)
    src_np = scenario_gt("cardboard", GT_POINTS, seed=1) + rng.normal(
        0, 0.004, (GT_POINTS, 3)).astype(np.float32)
    window, axis = nn.auto_nn_window(src_np, gt_np, NN_RADIUS)
    nchunks = -(-GT_POINTS // nn.DST_CHUNK)
    check(window < nchunks, f"K4 window {window} covers all {nchunks} "
          "chunks: the workload would not exercise the windowed scan")
    # both sorted on the widest axis, as icp._sorted_for_window does
    gt = torch.as_tensor(gt_np, device=dev)
    src = torch.as_tensor(src_np, device=dev)
    gt = gt[torch.argsort(gt[:, axis], stable=True)]
    src = src[torch.argsort(src[:, axis], stable=True)]
    mask = torch.ones(GT_POINTS, dtype=torch.bool, device=dev)
    dstp, dmaskp, c0, c1 = nn.window_ranges(src, gt, mask, NN_RADIUS, axis)
    d_k, i_k = nn.nn_min_windowed(src, dstp, dmaskp, c0, c1)
    d_p, i_p = nn.nn_min_windowed_torch(src, dstp, dmaskp, c0, c1)
    d_3, i_3 = nn.nn_min(src, gt, mask)
    torch.cuda.synchronize()
    check(bool(torch.equal(d_k, d_p)) and bool(torch.equal(i_k, i_p)),
          f"K4 differs from its plain version at "
          f"{int(((d_k != d_p) | (i_k != i_p)).sum())} rows")
    inl = d_3.sqrt() < NN_RADIUS
    check(bool(torch.equal(d_k[inl], d_3[inl]))
          and bool(torch.equal(i_k[inl], i_3[inl])),
          "K4 differs from K3 on rows with a neighbour within the radius")
    check(bool((d_k[~inl].sqrt() >= NN_RADIUS).all()),
          "K4 gives d < radius on a row whose nearest neighbour is farther")
    scanned = float(((c1 - c0).clamp(min=0)).float().mean())
    ms = cuda_ms(lambda: nn.nn_min_windowed(src, dstp, dmaskp, c0, c1), 10)
    plain_ms = cuda_ms(
        lambda: nn.nn_min_windowed_torch(src, dstp, dmaskp, c0, c1), 3)
    dev_ms = kernel_ms(lambda: nn.nn_min_windowed(src, dstp, dmaskp, c0, c1),
                       10, "nn_window_kernel")
    k3_ms = cuda_ms(lambda: nn.nn_min(src, gt, mask), 10)
    wrapper_ms = cuda_ms(lambda: nn.nn_distance_radius(
        src, gt, NN_RADIUS, window_chunks=window, axis=axis), 10)
    lib_ms = cdist_min_ms(src, gt)
    # the pairs this data needs: each 256-row tile against its chunk range
    tile_rows = torch.full_like(c0, nn.SRC_TILE)
    tile_rows[-1] = GT_POINTS - nn.SRC_TILE * (c0.numel() - 1)
    pairs = float((tile_rows * (c1 - c0).clamp(min=0) * nn.DST_CHUNK).sum())
    b = bound(GT_POINTS * 12 + dstp.shape[0] * 13 + c0.numel() * 8
              + GT_POINTS * 8, 8.0 * pairs)
    log(f"K4 windowed nn: {GT_POINTS} x {GT_POINTS}, radius {NN_RADIUS}, "
        f"axis {axis}, auto window {window} of {nchunks} chunks, mean "
        f"chunks scanned per tile {scanned:.2f}, in-radius rows "
        f"{int(inl.sum())}, identical to its plain version on every row "
        f"and to K3 on every in-radius row; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, kernel alone {fmt_ms(dev_ms)}, K3 "
        f"{k3_ms:.4f} ms, nn_distance_radius (ranges + K4 + recompute) "
        f"{wrapper_ms:.4f} ms, torch.cdist().min() {lib_ms:.4f} ms, pairs "
        f"scanned {pairs:.0f}, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']})")
    return {"max_abs_err": 0.0, "ms": ms, "kernel_ms": dev_ms,
            "plain_ms": plain_ms, "k3_ms": k3_ms, **b, "library_ms": lib_ms}


def drift(exts, seed: int = 0, t_sigma: float = 0.012,
          r_sigma: float = 0.008):
    """Compounding odometry drift (tests/test_refine.py's perturb): per-step
    errors compound along the trajectory, frame 0 exact."""
    import numpy as np

    from otslam_tpu_torch.core.se3 import euler_xyz_to_matrix, se3
    rng = np.random.default_rng(seed)
    out = [exts[0]]
    acc = np.eye(4)
    for e in exts[1:]:
        dR = euler_xyz_to_matrix(*rng.normal(0, r_sigma, 3))
        dt = rng.normal(0, t_sigma, 3)
        acc = se3(dR, dt) @ acc
        out.append((acc @ e).astype(np.float32))
    return np.stack(out)


def phase_registration(batch, intr, cfg, dev, gt):
    """The registration path (phase 6): refine="icp" and "pgo" on the
    drifted capture, each through PLY and the ICP-aligned eval, then scan
    localization. Fails on a non-finite or missing result, a pgo that does
    not lower the drifted translation RMSE, or a localization off by
    >= 4 cm / 0.02 rad."""
    import numpy as np
    import torch

    from otslam_tpu_torch.config import LidarConfig
    from otslam_tpu_torch.core import io as tio
    from otslam_tpu_torch.eval.metrics import evaluate_map
    from otslam_tpu_torch.mapping.localize import ScanLocalizer
    from otslam_tpu_torch.pipeline.reconstruct import reconstruct_frames
    from otslam_tpu_torch.pipeline.refine import trajectory_error
    from otslam_tpu_torch.sim.sensors import render_lidar
    from otslam_tpu_torch.sim.world import cardboard_room

    drifted = dataclasses.replace(batch,
                                  extrinsics=drift(batch.extrinsics))
    t_odo, r_odo = trajectory_error(drifted.extrinsics, batch.extrinsics)
    log(f"registration: drifted odometry RMSE {t_odo:.6f} m, "
        f"{r_odo:.6f} rad")
    errors = {}
    for refine in ("icp", "pgo"):
        stages: dict = {}
        t0 = time.perf_counter()
        res = reconstruct_frames(drifted, intr, cfg, backend="pallas",
                                 auto_origin=True, refine=refine,
                                 device=dev, seed=0, timings=stages)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "Object_0.ply")
            tio.write_ply(path, res.points, colors=res.colors,
                          normals=res.normals)
            cloud = tio.read_ply(path)["points"]
        t1 = time.perf_counter()
        m = evaluate_map(cloud, gt, use_icp=True, device=dev)
        torch.cuda.synchronize()
        stages["eval"] = time.perf_counter() - t1
        total = time.perf_counter() - t0
        t_err, r_err = trajectory_error(res.extrinsics, batch.extrinsics)
        errors[refine] = t_err
        log(f"refine={refine} stages (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in stages.items())
            + f", total {total:.4f}")
        log(f"refine={refine}: trajectory RMSE {t_err:.6f} m, {r_err:.6f} "
            f"rad (drifted {t_odo:.6f} m, {r_odo:.6f} rad); cloud "
            f"{len(cloud)} points, eval ICP fitness {m.icp_fitness:.4f} "
            f"rmse {m.icp_rmse:.6f}, accuracy {m.accuracy_cm:.4f} cm, "
            f"completeness {m.completeness_cm:.4f} cm")
        check(cloud.ndim == 2 and cloud.shape[1] == 3 and len(cloud) > 0,
              f"refine={refine}: cloud shape {cloud.shape}")
        check(bool(np.isfinite(cloud).all()),
              f"refine={refine}: cloud has non-finite points")
        check(np.isfinite([m.accuracy_cm, m.completeness_cm,
                           m.icp_fitness]).all(),
              f"refine={refine}: non-finite metrics {m}")
    check(errors["pgo"] < t_odo,
          f"pgo translation RMSE {errors['pgo']} m is not below the "
          f"drifted odometry's {t_odo} m")

    lidar = LidarConfig()
    scene = cardboard_room()
    angles = np.linspace(0, 2 * np.pi, lidar.num_beams,
                         endpoint=False).astype(np.float32)
    true = (0.6, -1.1, 0.8)
    scan = render_lidar(scene, *true, angles, lidar.range_min,
                        lidar.range_max, device=dev)
    prior = (true[0] + 0.08, true[1] - 0.06, true[2] + 0.07)
    t0 = time.perf_counter()
    loc = ScanLocalizer(scene.occupancy_grid(0.05), device=dev)
    pose = loc.localize(scan, angles, prior)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    pos_err = float(np.hypot(pose.x - true[0], pose.y - true[1]))
    yaw_err = abs(pose.yaw - true[2])
    log(f"localize: {lidar.num_beams} beams, map {len(loc._map_np)} cells, "
        f"prior off 0.1000 m / 0.0700 rad -> off {pos_err:.6f} m / "
        f"{yaw_err:.6f} rad, fitness {pose.fitness:.4f}, {secs:.4f} s")
    check(pos_err < 0.04 and yaw_err < 0.02,
          f"localization off by {pos_err} m, {yaw_err} rad")


def ray_poses(scene, n: int, seed: int):
    """n (x, y, yaw) poses drawn inside a scene's room, in free space."""
    import numpy as np
    rng = np.random.default_rng(seed)
    xmin, xmax, ymin, ymax = scene.room
    grid = scene.occupancy_grid(0.05)
    out = []
    while len(out) < n:
        x, y = rng.uniform([xmin + 0.3, ymin + 0.3], [xmax - 0.3, ymax - 0.3])
        gx = int((x - grid.origin[0]) / grid.resolution)
        gy = int((y - grid.origin[1]) / grid.resolution)
        if grid.data[gy, gx] != 100:
            out.append((x, y, rng.uniform(-np.pi, np.pi)))
    return np.asarray(out, np.float32)


def phase_k5(dev):
    """K5 against its plain version at the perception workload: RAY_BEAMS
    beams of a 10 m LiDAR (200 steps at 0.05 m), RAY_POSES poses in one
    call, on the cardboard room's and full_room's maps."""
    import numpy as np
    import torch

    from otslam_tpu_torch.config import LidarConfig
    from otslam_tpu_torch.kernels import raycast
    from otslam_tpu_torch.mapping.virtual_scan import VirtualScanner
    from otslam_tpu_torch.sim.world import cardboard_room, full_room
    lidar = LidarConfig()
    out = {}
    for name, scene in (("cardboard", cardboard_room()),
                        ("full_room", full_room())):
        vs = VirtualScanner(lidar, device=dev)
        vs.set_map(scene.occupancy_grid(0.05))
        g = vs._map
        poses = torch.as_tensor(ray_poses(scene, RAY_POSES, 7), device=dev)
        steps = raycast.num_steps_for(lidar.range_max, g.resolution)
        cos_a, sin_a = raycast.beam_trig(poses[:, 2], vs.angles())
        xy = poses[:, :2].contiguous()
        args = (vs.grid, cos_a.contiguous(), sin_a.contiguous(), xy,
                float(g.resolution), float(g.origin[0]), float(g.origin[1]),
                steps)
        fs, fo = raycast.ray_keys(*args)
        ps, po = raycast.ray_keys_torch(*args)
        ranges = raycast.raycast_grid_fast(
            vs.grid, g.resolution, *g.origin, poses[:, 0], poses[:, 1],
            poses[:, 2], vs.angles(), lidar.range_max)
        plain = raycast.raycast_grid(
            vs.grid, g.resolution, *g.origin, poses[:, 0], poses[:, 1],
            poses[:, 2], vs.angles(), lidar.range_max)
        torch.cuda.synchronize()
        check(bool(torch.equal(fs, ps)) and bool(torch.equal(fo, po)),
              f"K5 keys differ from the plain version on {name} at "
              f"{int(((fs != ps) | (fo != po)).sum())} beams")
        check(bool(torch.equal(ranges, plain)),
              f"K5 ranges differ from the plain version on {name}")
        ms = cuda_ms(lambda: raycast.ray_keys(*args), 20)
        plain_ms = cuda_ms(lambda: raycast.ray_keys_torch(*args), 5)
        dev_ms = kernel_ms(lambda: raycast.ray_keys(*args), 20,
                           "raycast_kernel")
        hits = int(torch.isfinite(ranges).sum())
        # the samples this data needs: each beam walks to its first stop
        samples = float((fs + 1).clamp(max=steps).sum())
        kb = fs.numel()
        # about 12 f32 operations a sample (step distance, two products and
        # sums, two differences and divisions, two casts, bounds tests); the
        # grid, cos/sin and poses read once, two keys written once
        b = bound(vs.grid.numel() + kb * 8 + xy.numel() * 4 + kb * 8,
                  12.0 * samples)
        log(f"K5 raycast {name}: map {tuple(vs.grid.shape)}, {RAY_POSES} "
            f"poses x {lidar.num_beams} beams x {steps} steps, hit beams "
            f"{hits} of {kb}, keys and ranges identical to the plain "
            f"version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, kernel "
            f"alone {fmt_ms(dev_ms)}, samples walked {samples:.0f} "
            f"({samples / (ms * 1e-3):.4g} samples/s), bound "
            f"{b['bound_ms']:.6f} ms ({b['bound_by']})")
        out[name] = {"max_abs_err": 0.0, "ms": ms, "kernel_ms": dev_ms,
                     "plain_ms": plain_ms, **b, "library_ms": None}
    return out


def phase_mission(dev, workdir: str):
    """The mission path (phase 8): the mission CLI at its defaults with
    --removed --localizer --perception-batch 8, then reconstruct_all over
    its dataset and evaluate_map of Object_0. Returns stage seconds."""
    import contextlib
    import io

    import numpy as np
    import torch

    from otslam_tpu_torch import cli
    from otslam_tpu_torch.config import ReconstructionConfig
    from otslam_tpu_torch.eval.metrics import evaluate_map
    from otslam_tpu_torch.eval.scenarios import scenario_gt
    from otslam_tpu_torch.pipeline.dataset import CaptureDataset
    from otslam_tpu_torch.pipeline.reconstruct import reconstruct_all

    stages = {}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["mission", "--workdir", workdir, "--removed",
                  "--localizer", "--perception-batch", "8", "--max-ticks",
                  str(MISSION_TICKS), "--device", str(dev)])
    torch.cuda.synchronize()
    stages["mission"] = time.perf_counter() - t0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"mission: {json.dumps(out)}")
    check(out["stable_objects"] >= 1, f"no stable object: {out}")
    check(out["missions"] >= 4, f"only {out['missions']} missions")
    check(len(out["removed_checks_visited"]) > 0,
          "the removed-object check was never visited")
    t1 = time.perf_counter()
    res = reconstruct_all(CaptureDataset(out["dataset"]),
                          ReconstructionConfig(), auto_origin=True,
                          device=dev,
                          save_dir=os.path.join(out["dataset"], "3d_reconst"))
    torch.cuda.synchronize()
    stages["reconstruct_all"] = time.perf_counter() - t1
    for name, r in res.items():
        log(f"mission reconstruct: {name} {len(r.points)} points from "
            f"{r.num_frames} frames")
        check(len(r.points) > 0 and bool(np.isfinite(r.points).all()),
              f"{name}: empty or non-finite cloud")
    check("Object_0" in res, f"no Object_0 among {sorted(res)}")
    t1 = time.perf_counter()
    m = evaluate_map(res["Object_0"].points, scenario_gt("cardboard",
                                                         GT_POINTS),
                     device=dev)
    torch.cuda.synchronize()
    stages["eval"] = time.perf_counter() - t1
    log(f"mission stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items())
        + f"; ticks {out['ticks']}, {out['ticks'] / stages['mission']:.2f} "
        f"ticks/s; Object_0 accuracy {m.accuracy_cm:.4f} cm, completeness "
        f"{m.completeness_cm:.4f} cm")
    check(m.accuracy_cm < 2.0, f"Object_0 accuracy {m.accuracy_cm} cm >= 2")
    return stages


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a CUDA GPU", file=sys.stderr)
        return 1
    try:
        import otslam_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the otslam_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 1
    import numpy as np

    from otslam_tpu_torch.config import ReconstructionConfig
    from otslam_tpu_torch.core import io as tio
    from otslam_tpu_torch.eval.metrics import evaluate_map
    from otslam_tpu_torch.eval.scenarios import scenario_gt
    from otslam_tpu_torch.kernels import _build, nn, raycast
    from otslam_tpu_torch.kernels import tsdf_cuda as tc
    from otslam_tpu_torch.kernels.tsdf_block import make_block_volume
    from otslam_tpu_torch.pipeline.reconstruct import (
        auto_volume_config, reconstruct_frames)

    dev = torch.device("cuda:0")
    # --- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave no reading"
    log(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__}"
        f" cuda {torch.version.cuda} | {card}")

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s, nvcc "
        f"{' '.join(_build.NVCC_FLAGS)} -> {_build.BUILD_LOG['path']}")
    for line in _build.BUILD_LOG["output"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # --- 3. kernels against their plain versions --------------------------
    t0 = time.perf_counter()
    batch, intr, _ = render_capture(dev)
    log(f"render: {N_FRAMES} frames {intr.width}x{intr.height} in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg = ReconstructionConfig()
    vol_cfg = auto_volume_config(batch, intr, cfg).tsdf
    meta = make_block_volume(vol_cfg, dev).meta
    log(f"volume: dims {vol_cfg.dims} voxel {vol_cfg.voxel_size} origin "
        f"{tuple(round(o, 4) for o in vol_cfg.origin)}")
    depths = torch.as_tensor(batch.depths, device=dev)
    colors = torch.as_tensor(batch.colors, device=dev)
    exts = torch.as_tensor(batch.extrinsics, device=dev)
    band, vis, k2 = phase_k2(meta, depths, exts, intr)
    torch.cuda.synchronize()
    k1 = phase_k1(vol_cfg, band, vis, depths, colors, exts, intr)
    torch.cuda.synchronize()
    k3 = phase_k3(dev)
    torch.cuda.synchronize()
    k4 = phase_k4(dev)
    torch.cuda.synchronize()
    del depths, colors, exts, band, vis

    # --- 4. main path -----------------------------------------------------
    gt = scenario_gt("cardboard", GT_POINTS)
    counters = (tc.classify_blocks, tc.fuse_blocks, nn.nn_min,
                nn.nn_min_windowed, raycast.ray_keys)
    for fn in counters:
        fn.launches = 0
    stages: dict = {}
    t0 = time.perf_counter()
    res = reconstruct_frames(batch, intr, cfg, backend="pallas",
                             auto_origin=True, device=dev, seed=0,
                             timings=stages)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "Object_0.ply")
        t1 = time.perf_counter()
        tio.write_ply(path, res.points, colors=res.colors,
                      normals=res.normals)
        cloud = tio.read_ply(path)["points"]
        stages["ply"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    metrics = evaluate_map(cloud, gt, device=dev)
    torch.cuda.synchronize()
    stages["eval"] = time.perf_counter() - t1
    total = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    log("main path stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + f", total {total:.4f}")
    log(f"main path: raw surface points {res.raw_surface_count}, cloud "
        f"{len(cloud)} points, accuracy {metrics.accuracy_cm:.4f} cm, "
        f"completeness {metrics.completeness_cm:.4f} cm, launches {launches}")
    check(cloud.ndim == 2 and cloud.shape[1] == 3 and len(cloud) > 0,
          f"cloud shape {cloud.shape}")
    check(bool(np.isfinite(cloud).all()), "cloud has non-finite points")
    path_kernels = ("classify_blocks", "fuse_blocks", "nn_min")
    check(all(launches[k] > 0 for k in path_kernels),
          f"a kernel of the path never launched: {launches}")
    check(metrics.accuracy_cm < 1.0,
          f"accuracy {metrics.accuracy_cm} cm >= 1 cm")

    # --- 6. registration path ---------------------------------------------
    for fn in counters:
        fn.launches = 0
    phase_registration(batch, intr, cfg, dev, gt)
    torch.cuda.synchronize()
    reg_launches = {fn.__name__: fn.launches for fn in counters}
    log(f"registration path launches {reg_launches}")
    check(all(reg_launches[fn.__name__] > 0 for fn in counters[:4]),
          f"a kernel of the registration path never launched: "
          f"{reg_launches}")

    # --- 7. K5 against its plain version ----------------------------------
    k5 = phase_k5(dev)
    torch.cuda.synchronize()

    # --- 8. mission path ---------------------------------------------------
    for fn in counters:
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        phase_mission(dev, os.path.join(tmp, "mission"))
    torch.cuda.synchronize()
    mis_launches = {fn.__name__: fn.launches for fn in counters}
    log(f"mission path launches {mis_launches}")
    check(mis_launches["ray_keys"] > 0, "K5 never launched in the mission")
    check("jax" not in sys.modules, "jax was imported")

    def counts(name):
        by_path = {"reconstruct": launches[name],
                   "registration": reg_launches[name],
                   "mission": mis_launches[name]}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    kernels = [
        {"name": "K1 block TSDF fusion", "route": "cuda",
         "source": "otslam_tpu_torch/csrc/tsdf_fuse.cu",
         "replaces": "otslam_tpu/kernels/tsdf_pallas.py:92",
         **counts("fuse_blocks"), **k1},
        {"name": "K2 block classification", "route": "cuda",
         "source": "otslam_tpu_torch/csrc/tsdf_classify.cu",
         "replaces": "otslam_tpu/kernels/tsdf_pallas.py:378",
         **counts("classify_blocks"), **k2},
        {"name": "K3 nearest neighbour", "route": "cuda",
         "source": "otslam_tpu_torch/csrc/nn.cu",
         "replaces": "otslam_tpu/kernels/nn.py:49",
         **counts("nn_min"), **k3},
        {"name": "K4 windowed nearest neighbour", "route": "cuda",
         "source": "otslam_tpu_torch/csrc/nn.cu",
         "replaces": "otslam_tpu/kernels/nn.py:200",
         **counts("nn_min_windowed"), **k4},
        {"name": "K5 ray cast", "route": "cuda",
         "source": "otslam_tpu_torch/csrc/raycast.cu",
         "replaces": "otslam_tpu/kernels/raycast.py:113",
         **counts("ray_keys"), **k5["cardboard"],
         "full_room": k5["full_room"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
