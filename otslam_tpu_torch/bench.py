"""Benchmark of the port on its device: the four workloads of the JAX
package's benchmark (the repository's root bench.py and bench_icp.py),
driven through the port's own entry points, printed in bench.py's record
format with numbers that are this device's own.

    python -m otslam_tpu_torch.bench               # main("cuda")
    python -m otslam_tpu_torch.cli bench [--device cuda]

Workloads, at their full width on the card:
  fusion      384 VGA frames of an analytic cube scan, rendered on the
              device, fused into a 256^3, 1 cm block volume by
              integrate_frames_cuda (the mip pass, K2, the colour pack, K1);
  icp         point-to-point ICP at 50k x 50k points, windowed (K4) and
              full scan (K3);
  perception  perception_ticks: K = 64 ticks of 1440 beams on the 208^2
              map of a one-box room (K5);
  mesh        marching tetrahedra over 16 of the fusion frames: the dense
              256^3 volume, the block volume's created blocks, and 8 block
              volumes in one call.

Every printed line is a full snapshot record, one JSON object, flushed as
each metric lands. The first has status "running" and no numbers, the last
status "complete", and main returns 0. A metric that raises, or whose
reading fails record_plausible, ends the run with a line of status
"failed" that holds "<metric>_error", and main returns 1: a reading outside
the gate is never printed as a measurement. Every line names the device
(nvidia-smi's name and power limit on a card). Nothing is read from or
written to a file.

Left out of the JAX benchmark, which served a TPU behind a network relay:
the reachability probe and the child processes with their timeouts (a
local card needs neither); the first line seeded from BENCH_TUNED.json, its
rewrite and the BENCH_HISTORY.jsonl appends (TPU records, never this
device's); the search over the Pallas window knobs (the port's work list
is exact: max_active=None); and bench_icp's least-squares slope over
iteration counts, which subtracted the relay's round trip (a local card
has none, so the rate is iterations over seconds).
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from otslam_tpu_torch.config import (ChangeDetectConfig, LidarConfig,
                                     TSDFConfig)
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.device import resolve_device

BASELINE_FPS = 500.0   # BASELINE.json's target frames/s/chip, not a reading
VGA = PinholeIntrinsics(width=640, height=480, fx=565.6009, fy=565.6009,
                        cx=320.5, cy=240.5)
ICP_THRESHOLD = 0.3
ICP_ITERATIONS = 60
MESH_FRAMES = 16
MESH_REPS = 8          # extractions a timed rep, and volumes a batched call

# Ceilings (units/s) from the least bytes each workload must move over the
# H100 SXM's 3.35 TB/s of HBM: a rate above one moved fewer bytes than its
# workload holds, so it is a broken measurement, never a fast kernel.
#   fusion: >= 16 B a VGA pixel (f32 depth + f32 RGB) = 4.92 MB a frame
#           -> 3.35e12 / 4.92e6 = 6.8e5 frames/s;
#   icp:    both 50k clouds once, (50k + 50k) * 3 * 4 B = 1.2 MB an
#           iteration -> 2.8e6 iterations/s;
#   mesh:   a 256^3 f32 tsdf plus weight, 134 MB -> 2.5e4 extractions/s;
#   perception: 1e6 ticks/s (a tick ray-casts 1440 beams over the map).
HBM_BYTES_PER_S = 3.35e12
_MESH_CEILING = HBM_BYTES_PER_S / (256 ** 3 * 8)
PLAUSIBILITY_CEILINGS = {
    "value": HBM_BYTES_PER_S / (640 * 480 * 16),
    "icp_iterations_per_sec": HBM_BYTES_PER_S / ((50_000 + 50_000) * 12),
    "perception_ticks_per_sec": 1e6,
    "mesh_extracts_per_sec": _MESH_CEILING,
    "mesh_block_extracts_per_sec": _MESH_CEILING,
    "mesh_batch_extracts_per_sec": _MESH_CEILING,
}

# the keys each metric adds to the record (bench.py's _METRIC_KEYS)
_METRIC_KEYS = {
    "fusion": ("value", "vs_baseline", "fusion_config"),
    "icp": ("icp_iterations_per_sec", "icp_unit", "icp_config"),
    "perception": ("perception_ticks_per_sec", "perception_unit"),
    "mesh": ("mesh_extracts_per_sec", "mesh_unit",
             "mesh_block_extracts_per_sec", "mesh_block_unit",
             "mesh_batch_extracts_per_sec", "mesh_batch_unit"),
}


def record_plausible(rec: dict, keys=None) -> tuple[bool, str]:
    """(ok, reason): every rate named in `keys` (default: every key of
    PLAUSIBILITY_CEILINGS) is in `rec`, a finite number > 0, and at most
    its ceiling."""
    for key in PLAUSIBILITY_CEILINGS if keys is None else keys:
        v = rec.get(key)
        if v is None:
            return False, f"{key} missing"
        try:
            v = float(v)
        except (TypeError, ValueError):
            return False, f"{key} non-numeric: {v!r}"
        if not 0.0 < v < math.inf:
            return False, f"{key} non-finite or non-positive: {v!r}"
        if v > PLAUSIBILITY_CEILINGS[key]:
            return False, (f"{key}={v} above physical ceiling "
                           f"{PLAUSIBILITY_CEILINGS[key]}")
    return True, "ok"


def device_record(dev: torch.device):
    """"cpu", or {"name", "power_limit_w"} of the card from nvidia-smi
    (power_limit_w None where it reads no number)."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=60, check=True).stdout
        name, limit = out.strip().splitlines()[0].rsplit(",", 1)
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
        return {"name": torch.cuda.get_device_name(index),
                "power_limit_w": None, "nvidia_smi": f"no reading: {e}"}
    try:
        watts = float(limit.split()[0])
    except (ValueError, IndexError):
        watts = None
    return {"name": name.strip(), "power_limit_w": watts}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev: torch.device, reps: int):
    """fn() once to warm up, then `reps` timed calls, each ending in a
    device sync. Returns (host seconds of each call, CUDA-event ms of each
    on the device's stream, or None on the CPU)."""
    fn()
    _sync(dev)
    secs, event_ms = [], []
    for _ in range(reps):
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record(stream)
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            end.record(stream)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        event_ms.append(start.elapsed_time(end) if dev.type == "cuda"
                        else None)
    return secs, event_ms


def _r(xs, nd: int = 6):
    return [None if x is None else round(x, nd) for x in xs]


# --- fusion -------------------------------------------------------------------

def _frame_poses(n):
    """Host-side capture-circle poses: per-frame (R, eye, extrinsic)."""
    Rs, eyes, exts = [], [], []
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = np.array([1.2 * np.cos(ang), 1.2 * np.sin(ang), 0.2])
        fwd = -eye / np.linalg.norm(eye)
        up = np.array([0.0, 0.0, -1.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=1)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = eye
        Rs.append(R.astype(np.float32))
        eyes.append(eye.astype(np.float32))
        exts.append(np.linalg.inv(T).astype(np.float32))
    return np.stack(Rs), np.stack(eyes), np.stack(exts)


def _make_frames(intr: PinholeIntrinsics, n: int, device="cuda"):
    """The cube-scan frames rendered on `device` from the capture-circle
    poses (the analytic ray-box render of bench.py): depths (n, H, W) f32,
    `tmin` where a ray enters the 0.4 m cube beyond 0.1 m and 0 elsewhere;
    colours (n, H, W, 3) f32, all 128; extrinsics (n, 4, 4). Made on the
    device, so the timed fusion carries no upload."""
    dev = resolve_device(device)
    Rs, eyes, exts = _frame_poses(n)
    rays = intr.pixel_rays(dev)                       # (H, W, 3)
    lo = torch.tensor([-0.2, -0.2, 0.0], device=dev)
    hi = torch.tensor([0.2, 0.2, 0.4], device=dev)
    Rs = torch.as_tensor(Rs, device=dev)
    eyes = torch.as_tensor(eyes, device=dev)
    depths = torch.empty((n, intr.height, intr.width), dtype=torch.float32,
                         device=dev)
    for i in range(n):
        dirs = rays @ Rs[i].T
        t1 = (lo - eyes[i]) / dirs
        t2 = (hi - eyes[i]) / dirs
        tmin = torch.minimum(t1, t2).amax(dim=-1)
        tmax = torch.maximum(t1, t2).amin(dim=-1)
        hit = (tmax > tmin) & (tmin > 0.1)
        depths[i] = torch.where(hit, tmin, 0.0)
    colors = torch.full((n, intr.height, intr.width, 3), 128.0,
                        dtype=torch.float32, device=dev)
    return depths, colors, torch.as_tensor(exts, device=dev)


def fuse_cube(cfg: TSDFConfig, depths, colors, exts,
              intr: PinholeIntrinsics):
    """The fusion workload: the frames fused into a new block volume of
    `cfg` by integrate_frames_cuda on the exact work list."""
    from otslam_tpu_torch.kernels.tsdf_block import make_block_volume
    from otslam_tpu_torch.kernels.tsdf_cuda import integrate_frames_cuda
    return integrate_frames_cuda(make_block_volume(cfg, depths.device),
                                 depths, colors, exts, intr,
                                 max_active=None)


def _work_pairs(vol, depths, exts, intr) -> int:
    """(block, frame) pairs of the work list that fusing the frames into
    an empty volume like `vol` takes."""
    from otslam_tpu_torch.kernels import tsdf_cuda as tc
    band, visible = tc.classify_blocks(vol.meta, depths, exts, intr)
    created_in = torch.zeros_like(vol.created[:vol.num_blocks])
    return int(tc.created_and_active(band, visible, created_in)[1].sum())


def measure_fusion(device="cuda", n_frames: int | None = None,
                   intr: PinholeIntrinsics = VGA,
                   cfg: TSDFConfig | None = None) -> dict:
    """Fused frames a second: n_frames (384 on a card, 4 on the CPU) cube
    frames into a new volume (TSDFConfig() by default: 256^3, 1 cm, 4 cm
    truncation) per call, one warm-up and 5 timed calls; the value is
    n / the fastest call, as bench.py reports it."""
    dev = resolve_device(device)
    cfg = cfg or TSDFConfig()
    n = n_frames or (384 if dev.type == "cuda" else 4)
    depths, colors, exts = _make_frames(intr, n, dev)
    last = {}
    secs, event_ms = _timed(lambda: last.update(
        vol=fuse_cube(cfg, depths, colors, exts, intr)), dev, 5)
    vol = last["vol"]
    fps = [n / s for s in secs]
    return {
        "value": round(max(fps), 1),
        "vs_baseline": round(max(fps) / BASELINE_FPS, 3),
        "fusion_config": {
            "n_frames": n, "max_active": None,
            "frame": [intr.width, intr.height], "dims": list(cfg.dims),
            "voxel_size": cfg.voxel_size,
            "blocks": int(vol.created.sum()),
            "pairs": _work_pairs(vol, depths, exts, intr)},
        "health": {"fusion_fps_median": round(statistics.median(fps), 1),
                   "fusion_rep_spread_s": _r(secs),
                   "fusion_event_ms": _r(event_ms, 4)}}


# --- ICP ----------------------------------------------------------------------

def _icp_clouds(n: int):
    """bench_icp's seeded pair: src uniform in +-2 m, dst = src turned by
    0.02 rad about z and shifted by (0.01, -0.02, 0.005) m; f32 numpy."""
    rng = np.random.default_rng(0)
    src = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    th = 0.02
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]], np.float32)
    dst = (src @ R.T + np.array([0.01, -0.02, 0.005], np.float32))
    return src, dst


def run_icp(src: torch.Tensor, dst: torch.Tensor, iterations: int, **kw):
    """The ICP workload: icp_point_to_point at the bench's threshold, run
    until `iterations` or until fitness and rmse stop changing at all."""
    from otslam_tpu_torch.kernels.icp import icp_point_to_point
    return icp_point_to_point(src, dst, threshold=ICP_THRESHOLD,
                              max_iterations=iterations,
                              relative_fitness=0.0, relative_rmse=0.0, **kw)


def measure_icp(device="cuda", n: int | None = None,
                iterations: int = ICP_ITERATIONS) -> dict:
    """ICP iterations a second at n x n points (50 000 on a card, 2 000 on
    the CPU), windowed (the window auto_nn_window sizes: K4; a window that
    covers the cloud routes to K3) and full scan (K3); each one warm-up and
    3 timed runs. A rate is the iterations a run took over its seconds;
    the value is the larger of the two best rates."""
    from otslam_tpu_torch.kernels.nn import auto_nn_window
    dev = resolve_device(device)
    n = n or (50_000 if dev.type == "cuda" else 2_000)
    src_np, dst_np = _icp_clouds(n)
    window, axis = auto_nn_window(src_np, dst_np, ICP_THRESHOLD)
    src = torch.as_tensor(src_np, device=dev)
    dst = torch.as_tensor(dst_np, device=dev)
    rates, spreads, events, its, rmse = {}, {}, {}, {}, {}
    for tag, kw in (("windowed", {"nn_window": window, "nn_axis": axis}),
                    ("full_scan", {})):
        runs = []
        secs, event_ms = _timed(
            lambda: runs.append(run_icp(src, dst, iterations, **kw)), dev, 3)
        done = [r.iterations for r in runs[1:]]
        rates[tag] = round(max(i / s for i, s in zip(done, secs)), 1)
        spreads[tag] = _r(secs)
        events[tag] = _r(event_ms, 4)
        its[tag] = done
        rmse[tag] = float(runs[-1].inlier_rmse)
    return {
        "icp_iterations_per_sec": max(rates.values()),
        "icp_unit": f"iters/s at {n}x{n} points",
        "icp_config": {"nn_window": window, "nn_axis": axis,
                       "windowed": rates["windowed"],
                       "full_scan": rates["full_scan"],
                       "iterations": {"requested": iterations, **its},
                       "final_rmse_m": rmse, "rep_spread_s": spreads},
        "health": {"icp_event_ms": events}}


# --- perception ---------------------------------------------------------------

def perception_scene():
    """bench.py's perception room: the default 10 m room with one box."""
    from otslam_tpu_torch.sim.world import Box, Scene
    return Scene(objects=(Box((1.5, 0.5, 0.15), (0.5, 0.4, 0.3), 0.3,
                              (0.7, 0.6, 0.4), "box"),))


def perception_inputs(k: int, device="cuda"):
    """bench.py's perception workload as perception_ticks' arguments: the
    one-box room's 0.05 m map (208^2), default_rng(0) real ranges in
    [0.5, 8) m for k ticks of 1440 beams, poses on a line, dt 0.2 s, empty
    512^2 evidence grids."""
    dev = resolve_device(device)
    lidar = LidarConfig()
    cfg = ChangeDetectConfig()
    grid = perception_scene().occupancy_grid(0.05)
    n = lidar.num_beams
    inc = (lidar.angle_max - lidar.angle_min) / n
    angles = torch.as_tensor(
        (lidar.angle_min + np.arange(n) * inc).astype(np.float32), device=dev)
    rng = np.random.default_rng(0)
    reals = torch.as_tensor(rng.uniform(0.5, 8.0, (k, n)).astype(np.float32),
                            device=dev)
    poses = torch.as_tensor(
        np.stack([np.linspace(-1, 1, k), np.linspace(1, 0, k),
                  np.linspace(-1.5, -1.0, k)], axis=1).astype(np.float32),
        device=dev)
    dts = torch.full((k,), 0.2, dtype=torch.float32, device=dev)
    gh, gw = cfg.grid_cells
    new_g = torch.zeros((gh, gw), dtype=torch.float32, device=dev)
    gone_g = torch.zeros((gh, gw), dtype=torch.float32, device=dev)
    grid_data = torch.as_tensor(np.asarray(grid.data, np.int8), device=dev)
    return (grid_data, float(grid.resolution), float(grid.origin[0]),
            float(grid.origin[1]), new_g, gone_g, reals, poses, dts, angles,
            cfg, float(lidar.range_max))


def measure_perception_ticks(device="cuda", k: int = 64) -> dict:
    """Perception ticks a second: perception_ticks over k ticks in one call
    (K5 for all k virtual scans, the scan diff, k evidence updates, the
    compaction); one warm-up, the best of 3, as k / seconds."""
    from otslam_tpu_torch.mapping.perception import perception_ticks
    dev = resolve_device(device)
    args = perception_inputs(k, dev)
    secs, event_ms = _timed(lambda: perception_ticks(*args), dev, 3)
    return {"perception_ticks_per_sec": round(k / min(secs), 1),
            "perception_unit": f"ticks/s (1440 beams, 208^2 map, K={k})",
            "health": {"perception_rep_spread_s": _r(secs),
                       "perception_event_ms": _r(event_ms, 4)}}


# --- mesh extraction ----------------------------------------------------------

def measure_mesh_extract(d, c, e, intr, cfg, reps: int = MESH_REPS) -> dict:
    """Dense extractions a second: the frames fused into the dense volume
    (kernels/tsdf.py), then extract_mesh_soup at auto_max_cells; `reps`
    calls back to back with one final sync, the best of 5."""
    from otslam_tpu_torch.kernels.marching import (auto_max_cells,
                                                   extract_mesh_soup)
    from otslam_tpu_torch.kernels.tsdf import integrate_frames, make_volume
    dev = d.device
    vol = integrate_frames(make_volume(cfg, dev), d, c, e, intr)
    mc = auto_max_cells(vol)

    def run():
        for _ in range(reps):
            extract_mesh_soup(vol, max_cells=mc)
    secs, event_ms = _timed(run, dev, 5)
    return {"mesh_extracts_per_sec": round(reps / min(secs), 1),
            "mesh_unit": "extractions/s (256^3 marching tetrahedra)",
            "health": {"mesh_max_cells": mc,
                       "mesh_rep_spread_s": _r(secs),
                       "mesh_event_ms": _r(event_ms, 4)}}


def measure_mesh_block(d, c, e, intr, cfg, reps: int = MESH_REPS) -> dict:
    """Block extractions a second: the frames fused by integrate_frames_cuda
    (max_active None), then extract_mesh_soup_block at
    auto_mesh_block_config, `reps` calls back to back (sustained), and
    extract_meshes_block of `reps` copies in one call (batched); each the
    best of 5 after a warm-up."""
    from otslam_tpu_torch.kernels.marching import (auto_mesh_block_config,
                                                   extract_mesh_soup_block,
                                                   extract_meshes_block)
    dev = d.device
    vol = fuse_cube(cfg, d, c, e, intr)
    mb, mc = auto_mesh_block_config(vol)

    def run():
        for _ in range(reps):
            extract_mesh_soup_block(vol, mb, mc)
    secs, event_ms = _timed(run, dev, 5)
    bsecs, bevent_ms = _timed(
        lambda: extract_meshes_block([vol] * reps, mb, mc), dev, 5)
    return {"mesh_block_extracts_per_sec": round(reps / min(secs), 1),
            "mesh_block_unit": "extractions/s (256^3 grid, created blocks "
                               "only)",
            "mesh_batch_extracts_per_sec": round(reps / min(bsecs), 1),
            "mesh_batch_unit": f"extractions/s ({reps} volumes per call)",
            "health": {"mesh_block_config": [mb, mc],
                       "mesh_block_rep_spread_s": _r(secs),
                       "mesh_block_event_ms": _r(event_ms, 4),
                       "mesh_batch_rep_spread_s": _r(bsecs),
                       "mesh_batch_event_ms": _r(bevent_ms, 4)}}


def measure_mesh(device="cuda", n_frames: int = MESH_FRAMES,
                 intr: PinholeIntrinsics = VGA,
                 cfg: TSDFConfig | None = None,
                 reps: int = MESH_REPS) -> dict:
    """The three mesh metrics on the first n_frames cube frames."""
    dev = resolve_device(device)
    cfg = cfg or TSDFConfig()
    d, c, e = _make_frames(intr, n_frames, dev)
    dense = measure_mesh_extract(d, c, e, intr, cfg, reps)
    block = measure_mesh_block(d, c, e, intr, cfg, reps)
    return {**dense, **block, "health": {**dense["health"],
                                         **block["health"]}}


# --- the record -----------------------------------------------------------------

def _emit(snap: dict) -> None:
    print(json.dumps(snap), flush=True)


def main(device="cuda") -> int:
    """Run the four metrics on `device` (a CUDA device without CUDA
    raises), printing a snapshot line as each lands. Returns 0 when every
    metric landed and passed record_plausible, else 1 after a "failed"
    line."""
    dev = resolve_device(device)
    snap = {"metric": "vga_frames_fused_per_sec", "unit": "frames/s/chip",
            "status": "running", "device": device_record(dev),
            "measured": [], "health": {}}
    _emit(snap)
    for name, measure in (
            ("fusion", lambda: measure_fusion(dev)),
            ("icp", lambda: measure_icp(dev)),
            ("perception", lambda: measure_perception_ticks(dev)),
            ("mesh", lambda: measure_mesh(dev))):
        snap["status"] = name
        try:
            out = measure()
            ok, reason = record_plausible(
                out, [k for k in _METRIC_KEYS[name]
                      if k in PLAUSIBILITY_CEILINGS])
            if not ok:
                raise ValueError(f"implausible reading: {reason}")
        except Exception as e:  # noqa: BLE001  the run's boundary
            traceback.print_exc()
            snap["status"] = "failed"
            snap[f"{name}_error"] = f"{type(e).__name__}: {e}"
            _emit(snap)
            return 1
        snap["health"].update(out.pop("health", {}))
        snap.update(out)
        snap["measured"].append(name)
        _emit(snap)
    snap["status"] = "complete"
    _emit(snap)
    return 0


if __name__ == "__main__":
    sys.exit(main("cuda"))
