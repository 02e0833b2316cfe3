#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (otslam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles the CUDA kernels from otslam_tpu_torch/csrc/ with nvcc;
3. each kernel against its plain PyTorch version at the main path's shapes
   (64 VGA frames, 1 cm voxels, a 256^3 volume = 32768 blocks, and
   100k x 50k points), with CUDA-event times for both:
   K2 block classification (bit-identical), K1 block fusion (tsdf, weight
   and colour bit-identical) at the reconstruction's 64-frame batch and at frame-to-model
   tracking's one frame (frame 32 into the volume of frames 0-31, capped at
   max_active = 2048 blocks), K3 nearest neighbour (d^2 and index
   bit-identical) at the eval's 100k x 50k and 50k x 100k and at the
   localizer's 1440-beam scan against the cardboard room's 0.05 m grid
   cloud (the operands of the first K3 call of a real
   ScanLocalizer.localize), each with the split S of its launch;
4. main path: a 64-frame VGA capture circle of the cardboard room, rendered
   on the card, goes through reconstruct_frames (the body of
   reconstruct_object after dataset loading) with the default
   ReconstructionConfig and auto_volume_config, then write_ply -> read_ply
   -> evaluate_map against the 50k-point scenario GT; every kernel must
   have launched and the accuracy must be < 1 cm;
5. K4 windowed nearest neighbour against its plain version (bit-identical
   d^2 and index on every row) and against K3 (identical on every row whose
   nearest neighbour lies within the radius, >= the radius elsewhere) at
   50k x 50k with a 0.05 m radius and at the pair-ICP shape: two
   consecutive capture frames through refine._frame_points_normals, the
   source moved by the prior, the window of _pair_nn_window, radius 0.1 m;
6. registration path: the phase-4 capture with its poses drifted by
   compounding odometry noise goes through reconstruct_frames with
   refine="icp" and refine="pgo", then write_ply -> read_ply ->
   evaluate_map(use_icp=True); then ScanLocalizer registers a 1440-beam
   scan against the cardboard room's 0.05 m grid. K4 must have launched,
   pgo must lower the drifted trajectory's translation RMSE, and the scan
   must localize to < 4 cm and < 0.02 rad;
7. K5 ray casting against its plain version at the perception workload:
   1440 beams, range 10 m (200 steps), 64 poses in one call, on the
   cardboard room's 208^2 map and full_room's map, and the mission's 8
   poses on the cardboard map (bit-identical keys and ranges, at every
   lane count a ray), with CUDA-event times, hit
   beams and samples per second;
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
and `kernel_ms`, the kernel alone in a torch.profiler trace (K3/K4: the
scan and, for a split launch, the merge). It carries its bound too: the
larger of the bytes it must move over 3.35 TB/s and its f32 operations
over 67 TFLOP/s (the H100 SXM's published peaks), at this run's shapes and
data; K1, K3, K4 and K5 also a `shapes` list with a record per shape (the
log gives each shape's pairs or samples and the instruction floor of the
kernel's unfused arithmetic beside it, K3/K4 their split S; K5's records
hold the kernel alone at each lane count, K1's and K5's the registers
ptxas reports). The line before the last two is
the kernels' JSON record, then the nvidia-smi name/power line; the last
line is {"ok": true, "device": {...}}. JAX and otslam_tpu are never
imported. profile_paths.py drives phases 4, 6 and 8 under a profiler.
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
SM_CLOCK_HZ = 1.98e9          # H100 SXM boost clock
# lane instructions a pair with -fmad=false, counted from csrc/nn.cu's scan
# (its shared-memory loads and loop overhead left out): 8 f32 operations,
# then K4 a compare and two selects a pair, K3 3 fminf, a compare and a
# branch a group of 4 destinations
K3_INSTRUCTIONS = 9.3
K4_INSTRUCTIONS = 11.0
# lane instructions of one IEEE f32 division (div.rn.f32) as nvcc emits it
# for sm_90a: the reciprocal estimate, 5 fused multiply-adds of the
# refinement, the range check, its branch and the reconvergence pair
# around it (the slow path, for operands near the range limits, not
# counted)
DIV_INSTRUCTIONS = 10
# K1, a (voxel, frame) pair, counted from the arithmetic of
# csrc/tsdf_fuse.cu (the SASS issues ~184, see sass_loops): projection 18
# (9 products, 9 sums), in-front test and safe z 2, each pixel coordinate
# 5 + a division (product, sum, rint, clamp, cast), the bounds test 4, the
# address 6, the two loads 2, sdf, validity and the observed tsdf 6, colour
# unpacking 9 (3 fields, 3 casts, 3 products), the weight 2 and the four
# means 3 + a division each
K1_INSTRUCTIONS = 18 + 2 + 2 * 5 + 4 + 6 + 2 + 6 + 9 + 2 + 4 * 3 \
    + 6 * DIV_INSTRUCTIONS
# K5, a sample, counted from the arithmetic of csrc/raycast.cu (the chunk
# bookkeeping of its ballots not counted): step distance 3, the two
# coordinates 2 each, each cell index a difference and a cast + a
# division, the bounds test 4, the address 2, the load and its test 2,
# loop and exit tests 4
K5_INSTRUCTIONS = 3 + 2 * 2 + 2 * 2 + 4 + 2 + 2 + 4 + 2 * DIV_INSTRUCTIONS
F2M_FRAME = N_FRAMES // 2     # phase 3's one-frame K1 shape: this frame ...
F2M_MAX_ACTIVE = 2048         # ... into the volume of the frames before it
MISSION_POSES = 8             # the mission's --perception-batch
PAIR_RADIUS = 0.1             # refine_trajectory's widest ICP threshold


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


def kernel_ms(fn, reps: int, kernels):
    """Device milliseconds per fn() call of the CUDA kernels named in
    `kernels` (one name or several, summed), from a torch.profiler trace of
    `reps` calls after a warm-up: the kernels alone, without the wrapper's
    host time and the other launches that the event timing of cuda_ms
    includes. None when the trace holds none of them."""
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
    names = (kernels,) if isinstance(kernels, str) else kernels
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and any(
              f"{k}(" in e.name or f"{k}<" in e.name for k in names)]
    return sum(us) * 1e-3 / reps if us else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def instruction_floor_ms(instructions: float, work: float, dev) -> float:
    """`instructions` lane instructions for each of `work` items over
    every lane of the card (its SMs x 128) at the boost clock."""
    import torch
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return instructions * work / (sms * 128 * SM_CLOCK_HZ) * 1e3


def ptxas_registers(kernel: str) -> dict:
    """{entry: registers} of every compiled entry whose name holds
    `kernel`, from the build's ptxas -v report (templates demangled by
    cu++filt / c++filt where one is installed); {} when this process
    found the library built."""
    import re

    from otslam_tpu_torch.kernels import _build
    out, entry = {}, None
    for line in _build.BUILD_LOG["output"].splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and kernel in entry:
            out[entry] = int(m.group(1))
            entry = None
    return demangled(out)


def demangled(entries: dict) -> dict:
    """`entries` keyed by kernel name and template arguments (as
    raycast_kernel<8>) instead of mangled names, where cu++filt or c++filt is
    installed; as they are elsewhere."""
    import re
    import shutil
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if not filt or not entries:
        return entries
    names = subprocess.run([filt], input="\n".join(entries), text=True,
                           capture_output=True).stdout.split("\n")
    out = {}
    for name, value in zip(names, entries.values()):
        name = re.sub(r"\((?:unsigned )?(?:int|bool|long)\)", "", name)
        name = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::", "",
                      name)
        out[name.split("(")[0]] = value
    return out


def sass_loops(kernel: str) -> dict:
    """{entry: (instructions, slow-path calls)} of the innermost loop that
    holds a MUFU (the per-pair or per-sample loop) of every compiled entry
    whose name holds `kernel`, from cuobjdump -sass of the built library;
    {} where cuobjdump is missing. The calls are the divisions' slow paths,
    not taken for ordinary operands, each with its argument moves."""
    import re
    import shutil

    from otslam_tpu_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool) or not _build.BUILD_LOG["path"]:
        return {}
    sass = subprocess.run([tool, "-sass", _build.BUILD_LOG["path"]],
                          capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = m.group(1) if kernel in m.group(1) else None
            if cur:
                funcs[cur] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur:
            funcs[cur].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for name, ins in funcs.items():
        loops = []
        for addr, text in ins:
            m = re.search(r"BRA\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
                if any("MUFU" in t for t in body):
                    loops.append((len(body), sum("CALL" in t for t in body)))
        if loops:
            out[name] = min(loops)
    return demangled(out)


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
    # the kernel reads the packed (th*tw, 8) f32 mip table and two f32 depth
    # bounds of each frame and its extrinsic, and writes band and visible
    # (a byte each); the block coordinates come from the thread index. About
    # 55 f32 operations a (frame, block) pair (block centre, projection,
    # pixel slack, frustum and depth-bound tests)
    table = _depth_mips(depths)[0]
    b = bound(table.numel() * 4 + n * 2 * 4 + exts.numel() * 4
              + n * nb * 2, 55.0 * n * nb)
    # the torch mips read the frames and write the table
    mips_bytes = depths.numel() * 4 + table.numel() * 4
    log(f"K2 classify: {tuple(band_k.shape)} pairs, band {int(band_p.sum())}"
        f" visible {int(vis_p.sum())}, mismatches 0, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (both incl. the mips, {mips_ms:.4f} ms "
        f"for {mips_bytes} bytes, bound "
        f"{mips_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms), kernel alone "
        f"{fmt_ms(dev_ms)}, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return band_p, vis_p, {"max_abs_err": 0.0, "ms": ms,
                           "kernel_ms": dev_ms, "plain_ms": plain_ms, **b,
                           "library_ms": None, "mips_ms": mips_ms}


def k1_shape(label, base, ids, ptr, frames, depths, colors, exts, intr,
             reps=5):
    """K1 at one shape: the work list (ids, ptr, frames) fused into copies
    of the volume `base` by the kernel and by its plain version, which must
    agree bit for bit (tsdf, weight, colour); then its times, each call on a
    fresh copy of `base`, and its bound. The log adds the instruction floor
    and the time of pack_rgb, the colour pass before each launch."""
    import copy

    import torch

    from otslam_tpu_torch.kernels import tsdf_cuda as tc
    from otslam_tpu_torch.kernels.tsdf_block import pack_rgb
    ka, pa, ref = (copy.deepcopy(base) for _ in range(3))
    cpk = pack_rgb(colors)

    def reset():
        for v in (ka, pa):
            v.tsdf.copy_(base.tsdf)
            v.weight.copy_(base.weight)
            v.color.copy_(base.color)

    def fuse():
        tc.fuse_blocks(ka, ids, ptr, frames, depths, cpk, exts, intr)

    tc.fuse_blocks_torch(ref, ids, ptr, frames, depths, cpk, exts, intr)
    fuse()
    torch.cuda.synchronize()
    diff = {k: int((getattr(ka, k) != getattr(ref, k)).sum())
            for k in ("tsdf", "weight", "color")}
    check(not any(diff.values()), f"K1 differs from its plain version at "
          f"{label} (voxels per field {diff})")
    observed = int((ref.weight > 0).sum())
    del ref
    ms = cuda_ms(fuse, reps, setup=reset)
    plain_ms = cuda_ms(lambda: tc.fuse_blocks_torch(
        pa, ids, ptr, frames, depths, cpk, exts, intr), 3, setup=reset)
    dev_ms = kernel_ms(lambda: (reset(), fuse()), reps, "fuse_kernel")
    pack_ms = cuda_ms(lambda: pack_rgb(colors), reps)
    # the listed blocks' 5 floats a voxel read and written once, the frames'
    # depth and packed colour read once; about 55 f32 operations a (voxel,
    # frame) pair (projection, rounding, sdf, four running means)
    pairs = frames.shape[0]
    b = bound(ids.shape[0] * 512 * 5 * 4 * 2 + depths.numel() * 8
              + exts.numel() * 4 + (ids.numel() + ptr.numel() + pairs) * 4,
              55.0 * pairs * 512)
    floor = instruction_floor_ms(K1_INSTRUCTIONS, pairs * 512.0,
                                 depths.device)
    log(f"  {label}: {ids.shape[0]} blocks, {pairs} (block, frame) pairs, "
        f"observed voxels {observed}, tsdf, weight and colour equal; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, kernel alone "
        f"{fmt_ms(dev_ms)} (V={tc.VOXELS_PER_THREAD}), bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}), instruction floor at "
        f"{K1_INSTRUCTIONS} a voxel pair {floor:.4f} ms; pack_rgb "
        f"{pack_ms:.4f} ms")
    return {"shape": label, "max_abs_err": 0.0, "ms": ms,
            "kernel_ms": dev_ms, "plain_ms": plain_ms, **b,
            "library_ms": None, "blocks": int(ids.shape[0]),
            "pairs": int(pairs)}


def f2m_volume(vol_cfg, depths, colors, exts, intr):
    """The f2m shape's volume: frames 0 .. F2M_FRAME - 1 fused one at a
    time with max_active = F2M_MAX_ACTIVE, as refine_trajectory_f2m fuses
    each tracked frame (here at the capture's true poses)."""
    from otslam_tpu_torch.kernels.tsdf_block import (integrate_frames_sparse,
                                                     make_block_volume)
    vol = make_block_volume(vol_cfg, depths.device)
    for i in range(F2M_FRAME):
        integrate_frames_sparse(vol, depths[i:i + 1], colors[i:i + 1],
                                exts[i:i + 1], intr,
                                max_active=F2M_MAX_ACTIVE)
    return vol


def phase_k1(vol_cfg, band, vis, depths, colors, exts, intr):
    """K1 at the paths' two shapes: the reconstruction's 64-frame batch into
    an empty volume, and f2m's one frame into the volume of the frames
    before it, capped at max_active blocks as integrate_frames_cuda caps
    it."""
    import torch

    from otslam_tpu_torch.kernels import tsdf_cuda as tc
    from otslam_tpu_torch.kernels.tsdf_block import make_block_volume
    empty = make_block_volume(vol_cfg, depths.device)
    nb = empty.num_blocks
    _, active = tc.created_and_active(band, vis, empty.created[:nb])
    shapes = [k1_shape(f"reconstruct {N_FRAMES} frames", empty,
                       *tc.active_worklist(active), depths, colors, exts,
                       intr)]
    del empty, active
    f = slice(F2M_FRAME, F2M_FRAME + 1)
    vol = f2m_volume(vol_cfg, depths, colors, exts, intr)
    band1, vis1 = tc.classify_blocks(vol.meta, depths[f], exts[f], intr)
    _, active = tc.created_and_active(band1, vis1, vol.created[:nb])
    capped = active & (torch.cumsum(active, dim=1) <= F2M_MAX_ACTIVE)
    log(f"  f2m frame {F2M_FRAME}: {int(active.sum())} active blocks, "
        f"{int(capped.sum())} after the max_active = {F2M_MAX_ACTIVE} cap, "
        f"{int(vol.created.sum())} blocks created before it")
    shapes.append(k1_shape(f"f2m one frame, max_active {F2M_MAX_ACTIVE}",
                           vol, *tc.active_worklist(capped), depths[f],
                           colors[f], exts[f], intr, reps=20))
    regs = ptxas_registers("fuse_kernel")
    loops = sass_loops("fuse_kernel")
    log(f"K1 fuse: bit-identical to its plain version at both shapes; "
        f"registers {regs}; SASS frame loop (instructions, slow-path "
        f"calls) {loops}")
    return {**shapes[0], "registers": regs, "sass_loop": loops,
            "shapes": shapes}


def nn_record(label, kernel, plain, names, pairs, nbytes, instructions,
              splits, dev, cdist=None, reps=10):
    """Times of one NN kernel call at one shape: events around the wrapper,
    the kernel alone (its scan and merge launches) from a trace, the plain
    version, torch.cdist().min() where `cdist` gives its (src, dst), and the
    bound. The log adds the split S, the pairs and the instruction floor:
    `instructions` lane instructions a pair over every lane of the card at
    its boost clock."""
    import torch
    ms = cuda_ms(kernel, reps)
    dev_ms = kernel_ms(kernel, reps, names)
    plain_ms = cuda_ms(plain, 3)
    lib_ms = cdist_min_ms(*cdist) if cdist is not None else None
    # 8 f32 operations a pair (3 differences, 3 squares, 2 sums)
    b = bound(nbytes, 8.0 * pairs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    floor_ms = instructions * pairs / (sms * 128 * SM_CLOCK_HZ) * 1e3
    log(f"  {label}: split S {splits}, pairs {pairs:.0f}, kernel {ms:.4f} "
        f"ms, kernel alone {fmt_ms(dev_ms)}, plain {plain_ms:.4f} ms, "
        f"torch.cdist().min() {fmt_ms(lib_ms)}, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}), instruction floor at "
        f"{instructions} a pair {floor_ms:.4f} ms")
    return {"shape": label, "max_abs_err": 0.0, "ms": ms,
            "kernel_ms": dev_ms, "plain_ms": plain_ms, **b,
            "library_ms": lib_ms}


def localizer_case(dev):
    """Phase 6's scan localization: a ScanLocalizer on the cardboard room's
    0.05 m grid, the 1440-beam scan from the true pose, and a prior off by
    (0.08, -0.06) m and 0.07 rad. Returns (loc, scan, angles, prior,
    true)."""
    import numpy as np

    from otslam_tpu_torch.config import LidarConfig
    from otslam_tpu_torch.mapping.localize import ScanLocalizer
    from otslam_tpu_torch.sim.sensors import render_lidar
    from otslam_tpu_torch.sim.world import cardboard_room
    lidar = LidarConfig()
    scene = cardboard_room()
    angles = np.linspace(0, 2 * np.pi, lidar.num_beams,
                         endpoint=False).astype(np.float32)
    true = (0.6, -1.1, 0.8)
    scan = render_lidar(scene, *true, angles, lidar.range_min,
                        lidar.range_max, device=dev)
    prior = (true[0] + 0.08, true[1] - 0.06, true[2] + 0.07)
    loc = ScanLocalizer(scene.occupancy_grid(0.05), device=dev)
    return loc, scan, angles, prior, true


def first_k3_operands(run):
    """(src, dst, dst_mask) of the first nn_min call that run() makes,
    recorded on its way to the kernel; run's K3 calls all go ahead."""
    from otslam_tpu_torch.kernels import nn
    real, seen = nn.nn_min, []

    def record(src, dst, dst_mask):
        seen.append((src.clone(), dst.clone(), dst_mask.clone()))
        return real(src, dst, dst_mask)

    # the wrapper counts its launches on the module's nn_min, this one while
    # it stands in
    record.launches = 0
    nn.nn_min = record
    try:
        run()
    finally:
        nn.nn_min = real
    check(bool(seen), "the localizer made no K3 call")
    return seen[0]


def phase_k3(dev):
    """K3 against its plain version (bit-identical d^2 and index) at the
    paths' shapes: the eval's 100k x 50k and 50k x 100k chamfer directions
    and the localizer's 1440-beam scan against its grid cloud."""
    import numpy as np
    import torch

    from otslam_tpu_torch.eval.scenarios import scenario_gt
    from otslam_tpu_torch.kernels import nn
    gt = torch.as_tensor(scenario_gt("cardboard", GT_POINTS), device=dev)
    rng = np.random.default_rng(1)
    src_np = scenario_gt("cardboard", SRC_POINTS, seed=1) + rng.normal(
        0, 0.004, (SRC_POINTS, 3)).astype(np.float32)
    cloud = torch.as_tensor(src_np, device=dev)
    ones = torch.ones(max(GT_POINTS, SRC_POINTS), dtype=torch.bool,
                      device=dev)
    loc, scan, angles, prior, _ = localizer_case(dev)
    lsrc, ldst, lmask = first_k3_operands(
        lambda: loc.localize(scan, angles, prior))
    shapes = []
    for label, src, dst, mask in (
            (f"eval {SRC_POINTS} x {GT_POINTS}", cloud, gt, ones[:GT_POINTS]),
            (f"eval {GT_POINTS} x {SRC_POINTS}", gt, cloud,
             ones[:SRC_POINTS]),
            (f"localizer {lsrc.shape[0]} x {ldst.shape[0]}", lsrc, ldst,
             lmask)):
        d_k, i_k = nn.nn_min(src, dst, mask)
        d_p, i_p = nn.nn_min_torch(src, dst, mask)
        torch.cuda.synchronize()
        check(bool(torch.equal(d_k, d_p)) and bool(torch.equal(i_k, i_p)),
              f"K3 differs from its plain version at {label} on "
              f"{int(((d_k != d_p) | (i_k != i_p)).sum())} rows")
        n, m = src.shape[0], dst.shape[0]
        shapes.append(nn_record(
            label, lambda: nn.nn_min(src, dst, mask),
            lambda: nn.nn_min_torch(src, dst, mask),
            ("nn_kernel", "nn_merge_kernel"), float(n) * m,
            n * 12 + m * 13 + n * 12, K3_INSTRUCTIONS,
            nn.split_count(n, m, nn.sm_count(dev)), dev, cdist=(src, dst)))
    log("K3 nn: bit-identical to its plain version (d^2 and index) at "
        "every shape")
    return {**shapes[0], "shapes": shapes}


def pair_icp_clouds(batch, intr, dev):
    """K4's operands at the pair-ICP shape: frames 1 and 0 of the capture
    through refine._frame_points_normals, the source moved by the prior and
    the window sized as refine_trajectory does, both sorted as ICP sorts
    them, at the widest annealing threshold."""
    import numpy as np
    import torch

    from otslam_tpu_torch.core.se3 import invert_se3
    from otslam_tpu_torch.kernels import nn
    from otslam_tpu_torch.kernels.icp import _sorted_for_window
    from otslam_tpu_torch.pipeline import refine
    depths = torch.as_tensor(batch.depths[:2], device=dev)
    prev_pts, _, prev_valid = refine._frame_points_normals(depths[0], intr)
    cur_pts, _, cur_valid = refine._frame_points_normals(depths[1], intr)
    window, axis = refine._pair_nn_window(cur_pts, prev_pts, PAIR_RADIUS)
    ext = np.asarray(batch.extrinsics, np.float64)
    src = refine._moved(cur_pts, ext[0] @ invert_se3(ext[1]))
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    src, dst, _, dmask, _ = _sorted_for_window(src, prev_pts, cur_valid,
                                               prev_valid, eye, axis)
    check(window * nn.DST_CHUNK < dst.shape[0], f"pair-ICP window {window} "
          f"covers the {dst.shape[0]}-point cloud: ICP would take K3")
    return src, dst, dmask, axis, window


def k4_shape(nn, label, src, dst, mask, radius, axis, dev):
    """K4 at one shape: bit-identical to its plain version, equal to K3 on
    every in-radius row, >= the radius elsewhere; then its times."""
    import torch
    dstp, dmaskp, c0, c1 = nn.window_ranges(src, dst, mask, radius, axis)
    d_k, i_k = nn.nn_min_windowed(src, dstp, dmaskp, c0, c1)
    d_p, i_p = nn.nn_min_windowed_torch(src, dstp, dmaskp, c0, c1)
    d_3, i_3 = nn.nn_min(src, dst, mask)
    torch.cuda.synchronize()
    check(bool(torch.equal(d_k, d_p)) and bool(torch.equal(i_k, i_p)),
          f"K4 differs from its plain version at {label} on "
          f"{int(((d_k != d_p) | (i_k != i_p)).sum())} rows")
    inl = d_3.sqrt() < radius
    check(bool(torch.equal(d_k[inl], d_3[inl]))
          and bool(torch.equal(i_k[inl], i_3[inl])),
          f"K4 differs from K3 at {label} on rows with a neighbour within "
          "the radius")
    check(bool((d_k[~inl].sqrt() >= radius).all()),
          f"K4 gives d < radius at {label} on a row whose nearest "
          "neighbour is farther")
    n, mp = src.shape[0], dstp.shape[0]
    # the pairs this data needs: each 256-row tile against its chunk range
    tile_rows = torch.full_like(c0, nn.SRC_TILE)
    tile_rows[-1] = n - nn.SRC_TILE * (c0.numel() - 1)
    lo = c0.clamp(min=0) * nn.DST_CHUNK
    hi = (c1 * nn.DST_CHUNK).clamp(max=mp)
    pairs = float((tile_rows * (hi - lo).clamp(min=0)).sum())
    log(f"  {label}: radius {radius}, axis {axis}, mean chunks scanned per "
        f"tile {float((c1 - c0).clamp(min=0).float().mean()):.2f} of "
        f"{mp // nn.DST_CHUNK}, in-radius rows {int(inl.sum())} of {n}")
    return nn_record(
        label, lambda: nn.nn_min_windowed(src, dstp, dmaskp, c0, c1),
        lambda: nn.nn_min_windowed_torch(src, dstp, dmaskp, c0, c1),
        ("nn_window_kernel", "nn_merge_kernel"), pairs,
        n * 12 + mp * 13 + c0.numel() * 8 + n * 12, K4_INSTRUCTIONS,
        nn.split_count(n, mp, nn.sm_count(dev)), dev, cdist=(src, dst))


def phase_k4(dev, batch, intr):
    """K4 at the eval's GT alignment shape (50k x 50k, radius 0.05 m) and at
    the pair-ICP shape."""
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
    shapes = [k4_shape(nn, f"eval {GT_POINTS} x {GT_POINTS}", src, gt, mask,
                       NN_RADIUS, axis, dev)]
    wrapper_ms = cuda_ms(lambda: nn.nn_distance_radius(
        src, gt, NN_RADIUS, window_chunks=window, axis=axis), 10)
    psrc, pdst, pmask, paxis, pwin = pair_icp_clouds(batch, intr, dev)
    shapes.append(k4_shape(
        nn, f"pair ICP {psrc.shape[0]} x {pdst.shape[0]}", psrc, pdst, pmask,
        PAIR_RADIUS, paxis, dev))
    log(f"K4 windowed nn: bit-identical to its plain version at every "
        f"shape, and to K3 on every in-radius row; nn_distance_radius "
        f"(ranges + K4 + recompute) at 50k x 50k {wrapper_ms:.4f} ms; "
        f"pair-ICP window {pwin} chunks")
    return {**shapes[0], "shapes": shapes}


def phase_reconstruct(batch, intr, cfg, dev, gt):
    """The main path (phase 4): reconstruct_frames with `cfg` and an auto
    volume, then write_ply -> read_ply -> evaluate_map against `gt`. Fails
    on an empty or non-finite cloud or an accuracy >= 1 cm."""
    import numpy as np
    import torch

    from otslam_tpu_torch.core import io as tio
    from otslam_tpu_torch.eval.metrics import evaluate_map
    from otslam_tpu_torch.pipeline.reconstruct import reconstruct_frames
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
    log("main path stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + f", total {total:.4f}")
    log(f"main path: raw surface points {res.raw_surface_count}, cloud "
        f"{len(cloud)} points, accuracy {metrics.accuracy_cm:.4f} cm, "
        f"completeness {metrics.completeness_cm:.4f} cm")
    check(cloud.ndim == 2 and cloud.shape[1] == 3 and len(cloud) > 0,
          f"cloud shape {cloud.shape}")
    check(bool(np.isfinite(cloud).all()), "cloud has non-finite points")
    check(metrics.accuracy_cm < 1.0,
          f"accuracy {metrics.accuracy_cm} cm >= 1 cm")


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

    from otslam_tpu_torch.core import io as tio
    from otslam_tpu_torch.eval.metrics import evaluate_map
    from otslam_tpu_torch.pipeline.reconstruct import reconstruct_frames
    from otslam_tpu_torch.pipeline.refine import trajectory_error

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

    loc, scan, angles, prior, true = localizer_case(dev)
    t0 = time.perf_counter()
    pose = loc.localize(scan, angles, prior)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    pos_err = float(np.hypot(pose.x - true[0], pose.y - true[1]))
    yaw_err = abs(pose.yaw - true[2])
    log(f"localize: {len(angles)} beams, map {len(loc._map_np)} cells, "
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
    from otslam_tpu_torch.kernels import nn, raycast
    from otslam_tpu_torch.mapping.virtual_scan import VirtualScanner
    from otslam_tpu_torch.sim.world import cardboard_room, full_room
    lidar = LidarConfig()
    out = {}
    for name, scene, n_poses in (
            ("cardboard", cardboard_room(), RAY_POSES),
            ("full_room", full_room(), RAY_POSES),
            ("mission batch", cardboard_room(), MISSION_POSES)):
        vs = VirtualScanner(lidar, device=dev)
        vs.set_map(scene.occupancy_grid(0.05))
        g = vs._map
        poses = torch.as_tensor(ray_poses(scene, n_poses, 7), device=dev)
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
        by_lanes = {}
        for lanes in raycast.LANE_CHOICES:
            ls, lo = raycast.ray_keys(*args, lanes=lanes)
            check(bool(torch.equal(ls, ps)) and bool(torch.equal(lo, po)),
                  f"K5 at L={lanes} differs from the plain version on {name}")
            by_lanes[f"L={lanes}"] = kernel_ms(
                lambda: raycast.ray_keys(*args, lanes=lanes), 20,
                "raycast_kernel")
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
        floor = instruction_floor_ms(K5_INSTRUCTIONS, samples, dev)
        log(f"K5 raycast {name}: map {tuple(vs.grid.shape)}, {n_poses} "
            f"poses x {lidar.num_beams} beams x {steps} steps, hit beams "
            f"{hits} of {kb}, keys and ranges identical to the plain "
            f"version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, kernel "
            f"alone {fmt_ms(dev_ms)}, samples walked {samples:.0f} "
            f"({samples / (ms * 1e-3):.4g} samples/s), bound "
            f"{b['bound_ms']:.6f} ms ({b['bound_by']}), instruction floor "
            f"at {K5_INSTRUCTIONS} a sample {floor:.6f} ms")
        lanes = raycast.lanes_for(fs.numel(), nn.sm_count(dev))
        log(f"  lanes a ray, kernel alone (L={lanes} taken): "
            + ", ".join(f"{k} {fmt_ms(t)}" for k, t in by_lanes.items()))
        out[name] = {"shape": f"{name} {n_poses} poses", "max_abs_err": 0.0,
                     "ms": ms, "kernel_ms": dev_ms, "plain_ms": plain_ms,
                     **b, "library_ms": None, "samples": samples,
                     "kernel_ms_by_lanes": by_lanes}
    regs = ptxas_registers("raycast_kernel")
    loops = sass_loops("raycast_kernel")
    log(f"K5 raycast: registers {regs}; SASS chunk loop (instructions, "
        f"slow-path calls) {loops}")
    return {**out["cardboard"], "registers": regs, "sass_loop": loops,
            "full_room": out["full_room"], "shapes": list(out.values())}


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
    from otslam_tpu_torch.config import ReconstructionConfig
    from otslam_tpu_torch.eval.scenarios import scenario_gt
    from otslam_tpu_torch.kernels import _build, nn, raycast
    from otslam_tpu_torch.kernels import tsdf_cuda as tc
    from otslam_tpu_torch.kernels.tsdf_block import make_block_volume
    from otslam_tpu_torch.pipeline.reconstruct import auto_volume_config

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
    k4 = phase_k4(dev, batch, intr)
    torch.cuda.synchronize()
    del depths, colors, exts, band, vis

    # --- 4. main path -----------------------------------------------------
    gt = scenario_gt("cardboard", GT_POINTS)
    counters = (tc.classify_blocks, tc.fuse_blocks, nn.nn_min,
                nn.nn_min_windowed, raycast.ray_keys)
    for fn in counters:
        fn.launches = 0
    phase_reconstruct(batch, intr, cfg, dev, gt)
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"main path launches {launches}")
    path_kernels = ("classify_blocks", "fuse_blocks", "nn_min")
    check(all(launches[k] > 0 for k in path_kernels),
          f"a kernel of the path never launched: {launches}")

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
         **counts("ray_keys"), **k5},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
