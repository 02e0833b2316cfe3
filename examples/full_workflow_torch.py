"""End-to-end OTSLAM workflow on the PyTorch/CUDA port, headless (the
port's copy of examples/full_workflow.py):

1. survey an empty room with the LiDAR and *build* the 2D map (grid mapper);
2. a box appears; run the closed-loop change-detection mission against the
   learned map (detect -> track -> visit -> scan);
3. reconstruct the captured object (block-sparse TSDF);
4. assemble the hybrid 2D+3D map;
5. evaluate against the analytic ground truth and report.

Run:  python examples/full_workflow_torch.py [workdir] [device]

The device defaults to the card (cuda); pass "cpu" to run the plain
PyTorch path. Imports neither jax nor otslam_tpu.
"""

import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from otslam_tpu_torch.config import (CameraConfig, LidarConfig, OTSLAMConfig,
                                     ReconstructionConfig, TSDFConfig,
                                     TrackerConfig)
from otslam_tpu_torch.device import resolve_device
from otslam_tpu_torch.eval.metrics import evaluate_map
from otslam_tpu_torch.eval.scenarios import sample_object_surfaces
from otslam_tpu_torch.mapping.grid_mapper import GridMapper
from otslam_tpu_torch.mapping.hybrid import save_hybrid_map
from otslam_tpu_torch.pipeline.dataset import CaptureDataset
from otslam_tpu_torch.pipeline.reconstruct import reconstruct_all
from otslam_tpu_torch.sim.runner import MissionRunner
from otslam_tpu_torch.sim.sensors import render_lidar
from otslam_tpu_torch.sim.world import Box, Scene


def main(workdir: str = os.path.join(tempfile.gettempdir(),
                                     "otslam_workflow_torch"),
         device="cuda") -> dict:
    dev = resolve_device(device)
    cam = CameraConfig(width=160, height=120, fx=141.4002, fy=141.4002,
                       cx=80.5, cy=60.5)
    lidar = LidarConfig(num_beams=360)
    cfg = OTSLAMConfig(camera=cam, lidar=lidar,
                       tracker=TrackerConfig.update_pipeline_profile())
    empty = Scene(objects=())
    box = Box((1.5, 0.5, 0.15), (0.5, 0.4, 0.3), 0.3, (0.76, 0.6, 0.42),
              "cardboard_box")
    world = Scene(objects=(box,))

    # --- 1. initial mapping session: survey the empty room -----------------
    print("== building the 2D map from LiDAR survey ==")
    gm = GridMapper(extent=(-5.6, 5.6, -5.6, 5.6), resolution=0.05,
                    lidar=lidar, device=dev)
    angles = np.linspace(0, 2 * np.pi, lidar.num_beams, endpoint=False)
    ang = torch.as_tensor(angles, dtype=torch.float32, device=dev)
    poses = [(x, y, yaw) for x in (-3.0, 0.0, 3.0) for y in (-3.0, 0.0, 3.0)
             for yaw in (0.0, 1.57, 3.14, 4.71)]
    scans = torch.stack([render_lidar(empty, *p, ang, lidar.range_min,
                                      lidar.range_max, device=dev)
                         for p in poses])
    gm.add_trajectory(scans, ang, np.asarray(poses, np.float32))
    os.makedirs(workdir, exist_ok=True)
    gm.save(f"{workdir}/map.pgm", f"{workdir}/map.yaml")
    saved_map = gm.to_grid()
    print(f"   map: {saved_map.width}x{saved_map.height} cells -> "
          f"{workdir}/map.pgm")

    # --- 2. change-detection mission against the learned map ---------------
    print("== running the change-detection mission ==")
    runner = MissionRunner(scene_map=empty, scene_world=world,
                           workdir=workdir, cfg=cfg,
                           start_pose=(-2.0, -2.0, 0.5), device=dev)
    runner.vscanner.set_map(saved_map)  # use the LEARNED map, not the oracle
    summary = runner.run(max_ticks=300)
    print(f"   missions: {summary.missions_completed}, frames: "
          f"{summary.frames_captured}, labels: {summary.labels}")

    # --- 3. reconstruct ------------------------------------------------------
    print("== reconstructing captured objects ==")
    ds = CaptureDataset(f"{workdir}/dataset", cam)
    rc = ReconstructionConfig(
        camera=cam,
        tsdf=TSDFConfig(voxel_size=0.01, sdf_trunc=0.04, dims=(192, 192, 96)),
        surface_samples=50000)
    out = reconstruct_all(ds, rc, backend="sparse", auto_origin=True,
                          save_dir=f"{workdir}/3d_reconst", device=dev)
    for name, res in out.items():
        print(f"   {name}: {len(res.points)} points from "
              f"{res.num_frames} frames")

    # --- 4. hybrid map -------------------------------------------------------
    pts, cols = save_hybrid_map(f"{workdir}/hybrid_map.ply", saved_map,
                                f"{workdir}/3d_reconst")
    print(f"== hybrid map: {len(pts)} points -> {workdir}/hybrid_map.ply ==")

    # --- 5. evaluate ---------------------------------------------------------
    gt = sample_object_surfaces([box], 20000, seed=0)
    gt = gt[gt[:, 2] >= 0.03]
    map_pts = np.concatenate([r.points for r in out.values()])
    m = evaluate_map(map_pts, gt, device=dev)
    report = {"accuracy_cm": round(m.accuracy_cm, 2),
              "completeness_cm": round(m.completeness_cm, 2),
              "reference_cardboard": {"accuracy_cm": 4.15,
                                      "completeness_cm": 4.39}}
    print("== evaluation ==")
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        tempfile.gettempdir(), "otslam_workflow_torch"),
        device=sys.argv[2] if len(sys.argv) > 2 else "cuda")
