#!/usr/bin/env python3
"""Where the time of the port's mission path goes, on one CUDA GPU.

    python3 profile_mission.py [mission flags, e.g. --max-ticks 300]

Drives the `mission` command's runner (otslam_tpu_torch.cli.mission_runner;
by default the cardboard scenario with --removed --localizer
--perception-batch 8 at the CLI's widths: VGA camera, 1440 beams, 512^2
evidence grid) three times: a warm-up (kernel build and first-use costs), a
timed run (host clock, ending in a device sync), and a run under
torch.profiler (CPU and CUDA activities) and cProfile. Prints the card's
name and power limit (nvidia-smi), the timed run's wall seconds and ticks/s, the profiled run's device busy time (the
sum of its CUDA kernel and copy durations) against its wall time, the
number of kernel launches, the top CUDA kernels by total time, and the
host's cumulative seconds in the runner's stages. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULTS = ["--removed", "--localizer", "--perception-batch", "8"]
# the runner's stages, by function name (cProfile cumulative seconds)
STAGES = ("run", "perception_tick_batch", "_transit_perception",
          "_run_tick_batch", "perception_ticks", "render_lidar",
          "render_lidar_path", "_estimate_pose", "_post_perception",
          "_scan_action", "_grab_frames", "save_frame")


def main(argv: list[str]) -> int:
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("profile_mission: CUDA is not available", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from otslam_tpu_torch import cli

    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd")
    cli._add_mission(sub)
    with tempfile.TemporaryDirectory() as tmp:
        args = ap.parse_args(["mission", "--workdir", tmp, *DEFAULTS, *argv])
        dev = torch.device(args.device)

        def mission(name):
            runner = cli.mission_runner(args, os.path.join(tmp, name), dev)
            t0 = time.perf_counter()
            runner.run(max_ticks=args.max_ticks)
            torch.cuda.synchronize()
            return runner, time.perf_counter() - t0

        mission("warmup")
        runner, wall = mission("timed")
        ticks = len(runner.trace)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        print(f"card: {smi.stdout.strip() or 'nvidia-smi gave no reading'}")
        print(f"device: {torch.cuda.get_device_name(0)}; mission "
              f"{args.scenario}, {ticks} ticks, "
              f"{runner.summary.missions_completed} missions, wall "
              f"{wall:.4f} s, {ticks / wall:.2f} ticks/s")
        prof_host = cProfile.Profile()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prof_host.enable()
            _, pwall = mission("profiled")
            prof_host.disable()
    events = prof.events()
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_events) * 1e-6
    launches = sum(e.name == "cudaLaunchKernel" for e in events)
    print(f"profiled run: wall {pwall:.4f} s, device busy {busy:.4f} s "
          f"({100 * busy / pwall:.2f} %), kernel launches {launches}")
    by_name: dict = {}
    for e in dev_events:
        n, s = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, s + e.time_range.elapsed_us() * 1e-3)
    print("top device items (count, total ms):")
    for name, (n, ms) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:12]:
        print(f"  {ms:10.3f} ms {n:7d}x  {name[:90]}")
    stats = pstats.Stats(prof_host, stream=io.StringIO())
    cum = {}
    for (path, _, fn), (_, _, _, ct, _) in stats.stats.items():
        if fn in STAGES and "otslam_tpu_torch" in path:
            cum[fn] = cum.get(fn, 0.0) + ct
    print("host cumulative seconds by stage (under both profilers): "
          + ", ".join(f"{k} {cum[k]:.4f}" for k in STAGES if k in cum))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
