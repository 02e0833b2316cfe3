#!/usr/bin/env python3
"""Where the time of the port's paths goes, on one CUDA GPU.

    python3 profile_paths.py [reconstruct] [mesh] [registration] [mission]
                             [headline] [online]

Drives each named path (all six by default) as chip_smoke.py's phases 4,
4b, 6, 8, 9c and 10a drive it: the 64-frame VGA capture of the cardboard room
through reconstruct_frames and the eval; the same with mesh output (the PLY
with its faces, the eval of the vertices above the floor); that capture
with drifted poses through
refine="icp" and "pgo", then a 1440-beam scan localization; the mission CLI
with --removed --localizer --perception-batch 8 for 300 ticks, then
reconstruct_all and the eval; headline_report at its defaults on the
cardboard room (capture circle, fusion and cloud, the 48-frame dense
sweep, its PLYs and voxel downsampling, the evals); the capture pushed
by a producer thread into OnlineFusion and drained in micro-batches of 4,
then extracted and evaluated (cProfile sees the draining thread only).
Each path runs three
times: a warm-up (kernel build and first-use costs), a timed run (its
stage lines, host clock), and a run under torch.profiler (CPU and CUDA
activities) and cProfile. For the
profiled run it prints the wall seconds, the device busy time (the sum of
its CUDA kernel and copy durations) and its share of the wall, the number
of kernel launches, each of the repo's kernels with its launches and
device milliseconds at the path's own shapes (their sum, mean, spread and
the three longest launches, which tell a path's shapes apart), the top
device items by total
time, and the host's cumulative seconds in the path's stages. The fusion
schedule's passes (`PASSES`: the classification, the depth mips, the
colour pack) and the mesh extraction's steps (`MESH_STEPS`: the whole
extract_mesh, its capacity sizing, the soup, the host weld) each run
inside a profiler range, so the report also gives each range's calls,
host milliseconds, kernel launches issued inside it and the device
milliseconds of the torch ops launched inside it; the trace does not tie
the repo's own kernels (launched through ctypes) to a range, so those
count by name (`KERNELS`). Prints the card's name and power limit first
(nvidia-smi). Needs a CUDA device. All five paths take ~10 minutes on an
H100, most of it the profiler's reading of registration's ~740 000
launches.
"""

from __future__ import annotations

import bisect
import cProfile
import functools
import io
import os
import pstats
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PATHS = ("reconstruct", "mesh", "registration", "mission", "headline",
         "online")
# the fusion schedule's passes before K1, by function name: K2's wrapper,
# the depth mips (the card's pass and the plain torch pyramid) and the
# colour pack (tsdf_cuda's wrapper and the plain tsdf_block.pack_rgb)
PASSES = ("classify_blocks", "depth_mips", "_depth_mips", "pack_rgb")
# the mesh extraction's steps (kernels/marching.py), by function name
MESH_STEPS = ("extract_mesh", "auto_mesh_block_config",
              "extract_mesh_soup_block", "_weld_mesh")
# each path's stages, by function name (cProfile cumulative seconds)
STAGES = {
    "reconstruct": ("reconstruct_frames", "auto_volume_config",
                    "fuse_frames", "extract_filtered_cloud", "evaluate_map")
    + PASSES,
    "mesh": ("reconstruct_frames", "auto_volume_config", "fuse_frames",
             "write_ply", "read_ply", "evaluate_map") + MESH_STEPS + PASSES,
    "registration": ("reconstruct_frames", "refine_trajectory",
                     "refine_trajectory_pgo", "_annealed_icp",
                     "detect_loop_closures", "track_frame_to_tsdf",
                     "optimize_pose_graph", "fuse_frames", "evaluate_map",
                     "localize") + PASSES,
    "mission": ("run", "perception_tick_batch", "_transit_perception",
                "_run_tick_batch", "perception_ticks", "render_lidar",
                "render_lidar_path", "_estimate_pose", "_post_perception",
                "_scan_action", "_grab_frames", "save_frame",
                "reconstruct_all", "evaluate_map") + PASSES,
    "headline": ("headline_report", "_capture_circle", "render_rgbd",
                 "fuse_frames", "extract_filtered_cloud", "save_hybrid_map",
                 "_room_sweep", "backproject_pointcloud", "write_ply",
                 "voxel_downsample", "evaluate_map") + PASSES,
    "online": ("drain", "pop", "integrate_frames_cuda", "active_worklist",
               "fuse_blocks", "extract", "evaluate_map") + PASSES,
}
# the repo's CUDA kernels (csrc/), by their names in a trace
KERNELS = ("mips_tile_kernel", "mips_finish_kernel", "classify_kernel",
           "pack_rgb_kernel", "fuse_kernel", "nn_kernel", "nn_window_kernel",
           "nn_merge_kernel", "raycast_kernel")
RANGE = "pass:"   # prefix of the profiler ranges around PASSES, MESH_STEPS


def wrap_passes() -> None:
    """Run every function named in PASSES or MESH_STEPS, wherever an
    otslam_tpu_torch module holds it (its own module or one that imported
    it), inside a torch.profiler range `pass:<module>.<name>`. The wrapper
    shares the function's attributes, so a launch counter still counts."""
    import torch
    wrapped = {}
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("otslam_tpu_torch"):
            continue
        for name in PASSES + MESH_STEPS:
            fn = getattr(mod, name, None)
            if fn is None or not callable(fn) or not getattr(
                    fn, "__module__", "").startswith("otslam_tpu_torch"):
                continue
            if fn not in wrapped:
                label = f"{RANGE}{fn.__module__}.{name}"

                def ranged(*args, _fn=fn, _label=label, **kwargs):
                    with torch.profiler.record_function(_label):
                        return _fn(*args, **kwargs)
                wrapped[fn] = functools.update_wrapper(ranged, fn)
            setattr(mod, name, wrapped[fn])


def profile_path(name: str, run) -> None:
    """Warm-up, timed and profiled run(tag) of one path, and its report."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(f"== {name}: warm-up", flush=True)
    run("warmup")
    print(f"== {name}: timed", flush=True)
    t0 = time.perf_counter()
    run("timed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"== {name}: profiled", flush=True)
    prof_host = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_host.enable()
        t0 = time.perf_counter()
        run("profiled")
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
        prof_host.disable()
    events = prof.events()
    by_name: dict = {}
    for e in events:
        # a range's own device-side span (a user annotation) is no device
        # work: the kernels inside it are counted each on its own
        if e.device_type == DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.name.startswith(RANGE)):
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() * 1e-3)
    busy = sum(ms for _, ms in by_name.values()) * 1e-3
    launches = sum(e.name == "cudaLaunchKernel" for e in events)
    print(f"{name}: timed wall {wall:.4f} s; profiled wall {pwall:.4f} s, "
          f"device busy {busy:.4f} s ({100 * busy / pwall:.2f} %), kernel "
          f"launches {launches}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for k in KERNELS:
        each = sorted(e.time_range.elapsed_us() * 1e-3 for e in events
                      if e.device_type == DeviceType.CUDA
                      and (f"{k}(" in e.name or f"{k}<" in e.name))
        n, ms = len(each), sum(each)
        print(f"  kernel {k}: {n} launches, {ms:.4f} ms"
              + (f", {ms / n:.4f} ms each (min {each[0]:.4f}, median "
                 f"{each[n // 2]:.4f}, max {each[-1]:.4f}; the "
                 f"{min(n, 3)} longest {sum(each[-3:]):.4f} ms)"
                 if n else ""))
    # kernel launches by thread, by start time, to count those in a range
    starts: dict = {}
    for e in events:
        if e.name == "cudaLaunchKernel":
            starts.setdefault(e.thread, []).append(e.time_range.start)
    for v in starts.values():
        v.sort()
    spans: dict = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(RANGE):
            n, host, dev, nl = spans.get(e.name, (0, 0.0, 0.0, 0))
            ts = starts.get(e.thread, [])
            inside = (bisect.bisect_right(ts, e.time_range.end)
                      - bisect.bisect_left(ts, e.time_range.start))
            spans[e.name] = (n + 1, host + e.cpu_time_total * 1e-3,
                             dev + e.device_time_total * 1e-3, nl + inside)
    for label, (n, host, dev, nl) in sorted(spans.items()):
        print(f"  pass {label[len(RANGE):]}: {n} calls, host {host:.4f} ms,"
              f" {nl} launches, device {dev:.4f} ms (torch ops launched "
              f"inside it)")
    print("  top device items (total ms, count):")
    for key, (n, ms) in ranked[:12]:
        print(f"  {ms:10.4f} ms {n:7d}x  {key[:90]}")
    stats = pstats.Stats(prof_host, stream=io.StringIO())
    cum: dict = {}
    for (path, _, fn), (_, _, _, ct, _) in stats.stats.items():
        if fn in STAGES[name] and "otslam_tpu_torch" in path:
            cum[fn] = cum.get(fn, 0.0) + ct
    print(f"  host cumulative seconds by stage (under both profilers): "
          + ", ".join(f"{k} {cum[k]:.4f}" for k in STAGES[name] if k in cum),
          flush=True)


def main(argv: list[str]) -> int:
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("profile_paths: CUDA is not available", file=sys.stderr)
        return 1
    paths = argv or list(PATHS)
    if not set(paths) <= set(PATHS):
        print(f"profile_paths: paths are {', '.join(PATHS)}", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import otslam_tpu_torch.kernels.tsdf_cuda  # noqa: F401 (for wrap_passes)
    import otslam_tpu_torch.pipeline.reconstruct  # noqa: F401 (the same)
    from otslam_tpu_torch.config import ReconstructionConfig
    from otslam_tpu_torch.eval.scenarios import scenario_gt
    from otslam_tpu_torch.pipeline.reconstruct import auto_volume_config
    wrap_passes()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"card: {smi.stdout.strip() or 'nvidia-smi gave no reading'}; "
          f"device: {torch.cuda.get_device_name(0)}", flush=True)
    dev = torch.device("cuda:0")
    batch, intr, _ = cs.render_capture(dev)
    cfg = ReconstructionConfig()
    vol_cfg = auto_volume_config(batch, intr, cfg).tsdf
    gt = scenario_gt("cardboard", cs.GT_POINTS)
    with tempfile.TemporaryDirectory() as tmp:
        runs = {
            "reconstruct": lambda tag: cs.phase_reconstruct(
                batch, intr, cfg, dev, gt),
            "mesh": lambda tag: cs.phase_mesh_path(batch, intr, cfg, dev,
                                                   gt),
            "registration": lambda tag: cs.phase_registration(
                batch, intr, cfg, dev, gt),
            "mission": lambda tag: cs.phase_mission(
                dev, os.path.join(tmp, f"mission_{tag}")),
            "headline": lambda tag: cs.phase_headline(
                dev, os.path.join(tmp, f"headline_{tag}"), "cardboard"),
            "online": lambda tag: cs.phase_online(batch, intr, vol_cfg, dev,
                                                  gt),
        }
        for name in paths:
            profile_path(name, runs[name])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
