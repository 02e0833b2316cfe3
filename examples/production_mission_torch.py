"""Production-scale mission workflow on the PyTorch/CUDA port: the
MISSION_r04 recipe as a script (the port's copy of
examples/production_mission.py).

The full 5-object-group scene (table + 4 chairs + cardboard box + 2 cones,
the reference's cardboard_table_chairs_cones_room.world placements) run
closed-loop with the production estimated-pose stack:

1. mission with drifting odometry + scan-to-map localization AND a
   removed object seeded in the saved map (removed-check missions run
   alongside the added-object scans);
2. reconstruct the mission's own captured dataset (volumes auto-sized to
   each tracked group's capture-circle geometry);
3. headline report computed from that mission-captured data: per-object
   accuracy/completeness vs the analytic GT and the selective-vs-dense
   map-size reduction.

Run:  python examples/production_mission_torch.py [workdir] [device]

The device defaults to the card (cuda), where perception fuses 64 ticks a
batch; on the CPU (device "cpu") it fuses 8 and the perception loop
dominates the wall time. Imports neither jax nor otslam_tpu.
"""

import dataclasses as dc
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from otslam_tpu_torch.config import OTSLAMConfig, TrackerConfig
from otslam_tpu_torch.device import resolve_device
from otslam_tpu_torch.eval.headline import headline_report
from otslam_tpu_torch.pipeline.dataset import CaptureDataset
from otslam_tpu_torch.pipeline.reconstruct import reconstruct_all
from otslam_tpu_torch.sim.runner import MissionRunner
from otslam_tpu_torch.sim.world import Box, full_room


def main(workdir: str, device="cuda", max_ticks: int = 24000,
         perception_batch: int | None = None,
         cfg: OTSLAMConfig | None = None, room_frames: int = 48) -> dict:
    """The three stages on `device`. perception_batch None takes 64 on a
    CUDA device and 8 on the CPU; cfg None is the reference's (VGA camera,
    1440 beams, the update-pipeline tracker). Returns the runner, its
    summary, the reconstruction and the headline report."""
    dev = resolve_device(device)
    if perception_batch is None:
        perception_batch = 64 if dev.type == "cuda" else 8
    world = full_room()
    cfg = cfg or OTSLAMConfig(tracker=TrackerConfig.update_pipeline_profile())

    # 1. closed-loop mission: estimated poses + a removed-object check
    # (the saved map carries a box reality no longer has)
    phantom = Box((4.0, -4.0, 0.15), (0.5, 0.4, 0.3), 0.0,
                  (0.7, 0.7, 0.7), "removed_box")
    runner = MissionRunner(
        scene_map=dc.replace(world, objects=(phantom,)),
        scene_world=world, workdir=workdir, cfg=cfg,
        start_pose=(0.5, 4.5, 0.0),
        odom_noise_per_m=0.01, use_localizer=True,
        perception_batch=perception_batch, device=dev)
    summary = runner.run(max_ticks=max_ticks)
    print(f"mission: {summary.missions_completed} missions, labels "
          f"{summary.labels}, removed checks visited "
          f"{sorted(runner.sender.visited_removed_ids)}")

    # 2. reconstruct the captured dataset (per-object auto-sized volumes)
    ds = CaptureDataset(os.path.join(workdir, "dataset"), cfg.camera)
    objdir = os.path.join(workdir, "dataset", "3d_reconst")
    out = reconstruct_all(ds, cfg.reconstruction, backend="pallas",
                          save_dir=objdir, auto_origin=True, device=dev)
    for name, res in out.items():
        print(f"  {name}: {len(res.points)} pts from {res.num_frames} frames")

    # 3. headline from the mission's own captures
    rep = headline_report(os.path.join(workdir, "headline"),
                          scene_fn=full_room, cam=cfg.camera,
                          room_frames=room_frames, objects_dir=objdir,
                          device=dev)
    print(json.dumps({k: v for k, v in rep.items() if k != "objects"},
                     indent=1))
    return {"runner": runner, "summary": summary, "reconstruction": out,
            "headline": rep}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        tempfile.gettempdir(), "otslam_production_torch"),
        device=sys.argv[2] if len(sys.argv) > 2 else "cuda")
