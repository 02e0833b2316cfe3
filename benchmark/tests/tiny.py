"""Tiny copies of the cells for the CPU: a checkout root in a temporary
directory holding BENCHMARK.json and the benchmark's data files, with the
configurations cut to a size a test run holds. The cells held out of
BENCHMARK.json (`held/<cell>.json`, each with the entries that would add
it back) are added to the copy, so that their drivers stay tested."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_CAMERA = {"width": 160, "height": 120, "fx": 141.4002, "fy": 141.4002,
               "cx": 80.5, "cy": 60.5}


def tiny_root(tmp: Path, recon_objects=("chair_1", "cone_blue"),
              mission=None) -> Path:
    """A checkout root whose configurations run at tiny sizes."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for held in sorted((REPO / "benchmark" / "held").glob("*.json")):
        for key, entries in json.loads(held.read_text()).items():
            spec[key].extend(entries)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    dst = tmp / "benchmark"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(REPO / "benchmark" / d, dst / d)
    rc = json.loads((dst / "configs/object_recon.json").read_text())
    rc["camera"].update(TINY_CAMERA)
    rc["tsdf"].update({"voxel_size": 0.02, "sdf_trunc": 0.08,
                       "dims": [64, 64, 64], "origin": [-0.64, -0.64, -0.14]})
    rc["surface_samples"] = 2000
    (dst / "configs/object_recon.json").write_text(json.dumps(rc))
    for name in ("captures", "captures.mesh", "orbit"):
        p = dst / "traffic" / f"{name}.json"
        t = json.loads(p.read_text())
        t["objects"] = list(recon_objects)
        if "warmup" in t:
            t["warmup"] = list(recon_objects[:1])
        if t["poses"] == "orbit":
            t["frame_rate_hz"] = 1.0
        p.write_text(json.dumps(t))
    mc_path = dst / "configs/lidar_mission.json"
    if mc_path.exists():
        mc = json.loads(mc_path.read_text())
        mc["camera"].update(TINY_CAMERA)
        mc_path.write_text(json.dumps(mc))
        t = json.loads((dst / "traffic/mission.json").read_text())
        t.update(mission or {"max_ticks": 40, "warmup_ticks": 10,
                             "perception_batch": 8})
        t["missions"] = t["missions"][:2]
        # a 40-tick mission completes nothing: its gates keep only the
        # final pose error's limit
        for name, lim in t["outcome"].items():
            if name != "pose_error_m":
                t["outcome"][name] = ({"at_least": 0} if "at_least" in lim
                                      else {"at_most": len(t["sites"])})
        (dst / "traffic/mission.json").write_text(json.dumps(t))
    return tmp
