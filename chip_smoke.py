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
   have launched and the accuracy must be < 1 cm.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. JAX and otslam_tpu are never imported.
"""

from __future__ import annotations

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
    log(f"K2 classify: {tuple(band_k.shape)} pairs, band {int(band_p.sum())}"
        f" visible {int(vis_p.sum())}, mismatches 0, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (both incl. the mips, {mips_ms:.4f} ms)")
    return band_p, vis_p, {"max_abs_err": 0.0, "ms": ms,
                           "plain_ms": plain_ms}


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

    def reset():
        for v in (ka, pa):
            v.tsdf.zero_()
            v.weight.zero_()
            v.color.zero_()
    ms = cuda_ms(lambda: tc.fuse_blocks(ka, ids, ptr, frames, depths, cpk,
                                        exts, intr), 5, setup=reset)
    plain_ms = cuda_ms(lambda: tc.fuse_blocks_torch(
        pa, ids, ptr, frames, depths, cpk, exts, intr), 3, setup=reset)
    log(f"K1 fuse: {ids.shape[0]} blocks, {frames.shape[0]} (block, frame) "
        f"pairs, observed voxels {int((pa.weight > 0).sum())}, weights "
        f"equal, tsdf err {t_err:.3g}, colour err {c_err:.3g}, kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": max(t_err, c_err), "ms": ms, "plain_ms": plain_ms}


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
    log(f"K3 nn: {SRC_POINTS} x {GT_POINTS}, rel err {rel:.3g}, index "
        f"mismatches {int(diff.sum())} (ties), kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    return {"max_abs_err": dist_err, "ms": ms, "plain_ms": plain_ms}


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
    from otslam_tpu_torch.kernels import _build, nn
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
    del depths, colors, exts, band, vis

    # --- 4. main path -----------------------------------------------------
    gt = scenario_gt("cardboard", GT_POINTS)
    counters = (tc.classify_blocks, tc.fuse_blocks, nn.nn_min)
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
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    check(metrics.accuracy_cm < 1.0,
          f"accuracy {metrics.accuracy_cm} cm >= 1 cm")
    check("jax" not in sys.modules, "jax was imported")

    kernels = [
        {"name": "K1 block TSDF fusion", "route": "cuda",
         "source": "otslam_tpu_torch/csrc/tsdf_fuse.cu",
         "replaces": "otslam_tpu/kernels/tsdf_pallas.py:92",
         "launches": launches["fuse_blocks"], **k1},
        {"name": "K2 block classification", "route": "cuda",
         "source": "otslam_tpu_torch/csrc/tsdf_classify.cu",
         "replaces": "otslam_tpu/kernels/tsdf_pallas.py:378",
         "launches": launches["classify_blocks"], **k2},
        {"name": "K3 nearest neighbour", "route": "cuda",
         "source": "otslam_tpu_torch/csrc/nn.cu",
         "replaces": "otslam_tpu/kernels/nn.py:49",
         "launches": launches["nn_min"], **k3},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
