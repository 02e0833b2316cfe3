#!/usr/bin/env python3
"""Where the time of the port's paths goes, on one CUDA GPU.

    python3 profile_paths.py [reconstruct] [registration] [mission]

Drives each named path (all three by default) as chip_smoke.py's phases 4,
6 and 8 drive it: the 64-frame VGA capture of the cardboard room through
reconstruct_frames and the eval; that capture with drifted poses through
refine="icp" and "pgo", then a 1440-beam scan localization; the mission CLI
with --removed --localizer --perception-batch 8 for 300 ticks, then
reconstruct_all and the eval. Each path runs three times: a warm-up (kernel
build and first-use costs), a timed run (its stage lines, host clock), and
a run under torch.profiler (CPU and CUDA activities) and cProfile. For the
profiled run it prints the wall seconds, the device busy time (the sum of
its CUDA kernel and copy durations) and its share of the wall, the number
of kernel launches, each of the repo's kernels with its launches and
device milliseconds at the path's own shapes (their sum, mean, spread and
the three longest launches, which tell a path's shapes apart), the top
device items by total
time, and the host's cumulative seconds in the path's stages. Prints the
card's name and power limit first (nvidia-smi). Needs a CUDA device.
"""

from __future__ import annotations

import cProfile
import io
import os
import pstats
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PATHS = ("reconstruct", "registration", "mission")
# each path's stages, by function name (cProfile cumulative seconds)
STAGES = {
    "reconstruct": ("reconstruct_frames", "auto_volume_config",
                    "fuse_frames", "extract_filtered_cloud", "evaluate_map"),
    "registration": ("reconstruct_frames", "refine_trajectory",
                     "refine_trajectory_pgo", "_annealed_icp",
                     "detect_loop_closures", "track_frame_to_tsdf",
                     "optimize_pose_graph", "fuse_frames", "evaluate_map",
                     "localize"),
    "mission": ("run", "perception_tick_batch", "_transit_perception",
                "_run_tick_batch", "perception_ticks", "render_lidar",
                "render_lidar_path", "_estimate_pose", "_post_perception",
                "_scan_action", "_grab_frames", "save_frame",
                "reconstruct_all", "evaluate_map"),
}
# the repo's CUDA kernels (csrc/), by their names in a trace
KERNELS = ("classify_kernel", "fuse_kernel", "nn_kernel", "nn_window_kernel",
           "nn_merge_kernel", "raycast_kernel")


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
        if e.device_type == DeviceType.CUDA:
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
    from otslam_tpu_torch.config import ReconstructionConfig
    from otslam_tpu_torch.eval.scenarios import scenario_gt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"card: {smi.stdout.strip() or 'nvidia-smi gave no reading'}; "
          f"device: {torch.cuda.get_device_name(0)}", flush=True)
    dev = torch.device("cuda:0")
    batch, intr, _ = cs.render_capture(dev)
    cfg = ReconstructionConfig()
    gt = scenario_gt("cardboard", cs.GT_POINTS)
    with tempfile.TemporaryDirectory() as tmp:
        runs = {
            "reconstruct": lambda tag: cs.phase_reconstruct(
                batch, intr, cfg, dev, gt),
            "registration": lambda tag: cs.phase_registration(
                batch, intr, cfg, dev, gt),
            "mission": lambda tag: cs.phase_mission(
                dev, os.path.join(tmp, f"mission_{tag}")),
        }
        for name in paths:
            profile_path(name, runs[name])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
