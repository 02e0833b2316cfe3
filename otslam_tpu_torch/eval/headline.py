"""End-to-end headline report: selective hybrid mapping vs dense mapping
(counterpart of otslam_tpu/eval/headline.py).

Reproduces the reference's flagship claim — **99.0% map-data-size reduction
vs conventional dense 3D mapping** with *better* accuracy (README.md:60;
1.7 MB vs 169.0 MB in eval/result_plot.py:17-18, RTAB-Map as the dense
baseline) — as one automated function over the analytic simulator:

1. capture circles around each object (scanner_node.cpp:164-258 geometry,
   radius 1.0 m) -> per-object TSDF reconstruction -> filtered sampled
   clouds written as PLYs (reconstruct_rgbd_filter.py protocol, 100k
   samples per object at VGA);
2. the saved 2D occupancy map (PGM) + object PLYs -> hybrid map
   (fusion/hybrid_map.py protocol);
3. the dense baseline: a whole-room sweep whose frames accumulate into an
   RTAB-Map-style dense cloud (rtabmap stores the concatenated registered
   clouds of all keyframes — that is what makes the 169 MB);
4. accuracy/completeness of BOTH maps against the analytic object GT, and
   the byte-size comparison.

The frames, the fusion, the dense cloud, its voxel downsampling and crops
and every eval run on the device; the host gets what is written to disk
(the PLYs, the PGM, hybrid.ply) and the small object clouds. Returns the
full published-table equivalent as a dict.
"""

from __future__ import annotations

import glob
import os
import types
from typing import Callable

import numpy as np
import torch

from otslam_tpu_torch.config import (CameraConfig, ReconstructionConfig,
                                     TSDFConfig)
from otslam_tpu_torch.core import io as tio
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.device import resolve_device
from otslam_tpu_torch.eval.baseline import hybrid_map_size_stats
from otslam_tpu_torch.eval.metrics import evaluate_map
from otslam_tpu_torch.eval.scenarios import sample_object_surfaces
from otslam_tpu_torch.kernels.backproject import backproject_pointcloud
from otslam_tpu_torch.kernels.voxel import voxel_downsample
from otslam_tpu_torch.mapping.hybrid import save_hybrid_map
from otslam_tpu_torch.pipeline.reconstruct import (extract_filtered_cloud,
                                                   fuse_frames)
from otslam_tpu_torch.sim.sensors import look_at_pose, render_rgbd
from otslam_tpu_torch.sim.world import Scene, cardboard_room
from otslam_tpu_torch.utils.profiling import StageTimer


def _capture_circle(scene, center, intr, n_frames, radius=1.0, height=0.5,
                    far=5.0, device="cuda"):
    """(depths, colors, extrinsics) of a capture circle around `center`,
    stacked tensors on `device`."""
    depths, colors, exts = [], [], []
    for i in range(n_frames):
        a = 2 * np.pi * i / n_frames
        eye = np.array([center[0] + radius * np.cos(a),
                        center[1] + radius * np.sin(a), height])
        pose = look_at_pose(eye, np.asarray(center))
        d, c = render_rgbd(scene, pose, intr, far=far, device=device)
        depths.append(d)
        colors.append(c)
        exts.append(np.linalg.inv(pose).astype(np.float32))
    return (torch.stack(depths), torch.stack(colors),
            torch.as_tensor(np.stack(exts), device=depths[0].device))


def _room_sweep(scene, intr, n_frames, room, height=1.2, far=9.0,
                device="cuda"):
    """Perimeter sweep looking inward — the dense-mapping trajectory: a
    list of (depth, color, extrinsic) with the frames on `device`."""
    xmin, xmax, ymin, ymax = room
    cx, cy = (xmin + xmax) / 2, (ymin + ymax) / 2
    rx, ry = 0.42 * (xmax - xmin), 0.42 * (ymax - ymin)
    out = []
    for i in range(n_frames):
        a = 2 * np.pi * i / n_frames
        eye = np.array([cx + rx * np.cos(a), cy + ry * np.sin(a), height])
        pose = look_at_pose(eye, np.array([cx, cy, 0.4]))
        d, c = render_rgbd(scene, pose, intr, far=far, device=device)
        out.append((d, c, np.linalg.inv(pose).astype(np.float32)))
    return out


def object_volume_config(center, voxel_size: float) -> TSDFConfig:
    """The volume of one object's capture circle: 128 x 128 x 64 voxels
    (twice that below 1 cm) centred on the object in x and y, from just
    under the floor, with the truncation at 4 voxels."""
    dims = (128, 128, 64) if voxel_size >= 0.01 else (256, 256, 128)
    side = dims[0] * voxel_size
    return TSDFConfig(voxel_size=voxel_size, sdf_trunc=4 * voxel_size,
                      dims=dims, origin=(float(center[0] - side / 2),
                                         float(center[1] - side / 2), -0.02))


def headline_report(workdir: str,
                    scene_fn: Callable[[], Scene] = cardboard_room,
                    cam: CameraConfig | None = None,
                    frames_per_object: int = 12,
                    room_frames: int = 48,
                    object_samples: int = 100_000,
                    voxel_size: float = 0.01,
                    map_resolution: float = 0.05,
                    backend: str = "sparse",
                    seed: int = 0,
                    objects_dir: str | None = None,
                    device="cuda",
                    timings: dict | None = None) -> dict:
    """Run the full selective-vs-dense comparison on `device`; returns the
    report dict.

    Defaults mirror reference operation: VGA-class camera, 1 cm voxels,
    100k sampled points per object PLY (reconstruct_rgbd_filter.py:123),
    5 cm 2D map. The dense baseline is the accumulated registered cloud of
    the room sweep (what RTAB-Map's map export stores).

    objects_dir: when given, the selective map is the reconstructed object
    PLYs already in that directory (e.g. a closed-loop mission dataset's
    ``3d_reconst/``) instead of synthesized capture circles — the report is
    then computed from mission-captured data. Per-object metrics associate
    each scene object with the cloud that covers it (most above-floor
    points within 1 m — the headless analog of the eval scripts' manual
    object<->GT pairing, eval_table_chair.py:130-138) and crop grouped
    clouds to the object's neighborhood symmetrically with the dense side.

    timings: when given, filled with the seconds of each stage (render,
    fuse, extract, map, dense_sweep, ply_write, downsample, eval), each
    ending in a device sync; the stages are torch.profiler ranges too.
    """
    dev = resolve_device(device)
    timer = StageTimer()
    cam = cam or CameraConfig()    # reference VGA intrinsics by default
    scene = scene_fn()
    intr = PinholeIntrinsics.from_config(cam)
    os.makedirs(workdir, exist_ok=True)

    prop_clouds = {}
    if objects_dir is not None:
        # --- 1'. selective map = mission-reconstructed PLYs --------------
        objdir = objects_dir
        for f in sorted(glob.glob(os.path.join(objects_dir, "*.ply"))):
            data = tio.read_ply(f)
            name = os.path.splitext(os.path.basename(f))[0]
            pts = np.asarray(data["points"])
            if len(pts) < 10:
                # e.g. a removed-object check capture of an empty site
                continue
            prop_clouds[name] = types.SimpleNamespace(points=pts)
        if not prop_clouds:
            raise ValueError(f"no object PLYs in {objects_dir}")
    else:
        objdir = os.path.join(workdir, "objects")
        os.makedirs(objdir, exist_ok=True)
        # --- 1. selective per-object reconstruction ----------------------
        for k, obj in enumerate(scene.objects):
            center = np.asarray(obj.center, np.float64)
            with timer.stage("render", sync=True):
                d, c, e = _capture_circle(scene, center, intr,
                                          frames_per_object, device=dev)
            cfg = ReconstructionConfig(
                camera=cam, tsdf=object_volume_config(center, voxel_size),
                surface_samples=object_samples)
            with timer.stage("fuse", sync=True):
                vol = fuse_frames(d, c, e, intr, cfg, backend, densify=False,
                                  device=dev)
            with timer.stage("extract", sync=True):
                res = extract_filtered_cloud(vol, cfg, seed=seed)
            name = f"Object_{k}"
            with timer.stage("ply_write"):
                tio.write_ply(os.path.join(objdir, f"{name}.ply"),
                              res.points, colors=res.colors)
            prop_clouds[name] = res

    # --- 2. 2D map + hybrid map ----------------------------------------
    with timer.stage("map"):
        grid = scene.occupancy_grid(map_resolution)
        pgm_path = os.path.join(workdir, "map.pgm")
        tio.write_pgm(pgm_path, _grid_to_pgm(grid))
        hybrid_path = os.path.join(workdir, "hybrid.ply")
        save_hybrid_map(hybrid_path, grid, objdir)

    # --- 3. dense baseline: accumulated registered clouds ---------------
    with timer.stage("dense_sweep", sync=True):
        dense_parts_p, dense_parts_c = [], []
        for d, c, e in _room_sweep(scene, intr, room_frames, scene.room,
                                   device=dev):
            pc = backproject_pointcloud(
                d, c / 255.0, intr, depth_trunc=9.0,
                extrinsic_inv=np.linalg.inv(e.astype(np.float64))
                .astype(np.float32), device=dev)
            dense_parts_p.append(pc.points[pc.mask])
            dense_parts_c.append(pc.colors[pc.mask])
        dense_pts = torch.cat(dense_parts_p)
        dense_cols = torch.cat(dense_parts_c)
        del dense_parts_p, dense_parts_c
    dense_path = os.path.join(workdir, "dense.ply")
    with timer.stage("ply_write"):
        tio.write_ply(dense_path, dense_pts.cpu().numpy(),
                      colors=dense_cols.cpu().numpy())

    # robustness variant: the same dense map voxel-downsampled at the
    # reconstruction voxel size (an export pipeline that grid-filters its
    # cloud would store this; the raw concatenation above is what RTAB-Map's
    # registered-keyframe export stores and is the published 169 MB
    # comparison, result_plot.py:17-18). Reported alongside so the headline
    # reduction is robust to the baseline-representation objection.
    with timer.stage("downsample", sync=True):
        ds_pts, ds_cols, keep = voxel_downsample(dense_pts, voxel_size,
                                                 colors=dense_cols)
        ds_pts, ds_cols = ds_pts[keep], ds_cols[keep]
        del dense_cols, keep
    dense_ds_path = os.path.join(workdir, "dense_downsampled.ply")
    with timer.stage("ply_write"):
        tio.write_ply(dense_ds_path, ds_pts.cpu().numpy(),
                      colors=ds_cols.cpu().numpy())
    del ds_pts, ds_cols

    # --- 4. metrics ------------------------------------------------------
    # whole-scene GT, also used per object: ACCURACY is evaluated against
    # the LOCAL SCENE surfaces (all objects within the crop + margin), not
    # the object's own surfaces alone — a member capture legitimately
    # contains neighboring scene content (a chair's 1 m crop includes the
    # table 0.8 m away), and scoring those correct points against
    # chair-only GT reported 22-30 cm for 1-3 cm reconstructions.
    # COMPLETENESS stays against the object's OWN surfaces (how well is
    # THIS object covered). The published table+chair numbers are combined
    # whole-cloud metrics (eval_table_chair.py evaluates the full scene
    # cloud), reported below as combined_*.
    with timer.stage("eval", sync=True):
        gt_all = sample_object_surfaces(list(scene.objects),
                                        20000 * len(scene.objects), seed=seed)
        gt_all = gt_all[gt_all[:, 2] >= 0.03]

        def _cloud_for(k, obj):
            """(cloud name, points) for a scene object: exact Object_k naming
            for the synthesized path; coverage association for
            mission-reconstructed clouds (whose labels follow tracker ids, not
            scene order) — the cloud with the most above-floor points within
            1 m of the object's center. Centroid distance would mis-report
            outer members of a merged group cloud (e.g. the far chairs of the
            table group) as unscanned."""
            if objects_dir is None:
                name = f"Object_{k}"
                return name, prop_clouds[name].points
            c = np.asarray(obj.center[:2], np.float64)
            best, bestn = None, 0
            for nm, r in prop_clouds.items():
                p = r.points
                n = int(np.sum(
                    (np.linalg.norm(p[:, :2] - c[None], axis=1) < 1.0)
                    & (p[:, 2] >= 0.03)))
                if n > bestn:
                    best, bestn = nm, n
            if bestn < 50:
                return None, None
            return best, prop_clouds[best].points

        # the dense cloud's xy in float64 for the crops, as the JAX package
        # takes them (float32 points minus a float64 centre, in numpy)
        dense_xy = dense_pts[:, :2].double()
        above = dense_pts[:, 2] >= 0.03
        report = {"objects": {}}
        for k, obj in enumerate(scene.objects):
            name = f"{obj.name}" if objects_dir is not None else f"Object_{k}"
            gt = sample_object_surfaces([obj], 20000, seed=seed)
            gt = gt[gt[:, 2] >= 0.03]
            c = np.asarray(obj.center)
            # local scene GT for the accuracy side: crop radius + margin so a
            # proposal point at the crop edge still finds its true nearest
            # surface inside the GT set
            gt_near = gt_all[np.linalg.norm(
                gt_all[:, :2] - c[None, :2], axis=1) < 1.2]
            cloud_name, prop = _cloud_for(k, obj)
            if prop is None:
                report["objects"][name] = {"scanned": False}
                continue
            if objects_dir is not None:
                # a mission cloud covers a capture site (a member of a tracked
                # group, or a whole merged group); crop to this object's
                # neighborhood exactly like the dense side below (the eval
                # scripts' re-centering crop, eval_cardboard.py:50-52)
                cnear = (np.linalg.norm(
                    prop[:, :2] - np.asarray(obj.center)[None, :2], axis=1)
                    < 1.0)
                cnear &= prop[:, 2] >= 0.03
                if not cnear.any():
                    report["objects"][name] = {"scanned": False,
                                               "cloud": cloud_name}
                    continue
                prop = prop[cnear]
            m_acc = evaluate_map(prop, gt_near, device=dev)
            m_comp = evaluate_map(prop, gt, device=dev)
            # dense-map points near this object (same crop the eval scripts
            # apply by re-centering: eval_cardboard.py:50-52)
            off = dense_xy - torch.as_tensor(c[:2], dtype=torch.float64,
                                             device=dev)
            near = (torch.sqrt((off * off).sum(dim=1)) < 1.0) & above
            entry = {
                "proposal_accuracy_cm": round(float(m_acc.accuracy_cm), 3),
                "proposal_completeness_cm": round(
                    float(m_comp.completeness_cm), 3),
            }
            if bool(near.any()):
                near_pts = dense_pts[near]
                m_dacc = evaluate_map(near_pts, gt_near, device=dev)
                m_dcomp = evaluate_map(near_pts, gt, device=dev)
                entry["dense_accuracy_cm"] = round(
                    float(m_dacc.accuracy_cm), 3)
                entry["dense_completeness_cm"] = round(
                    float(m_dcomp.completeness_cm), 3)
            else:
                # the dense sweep never saw this object (occluded from the
                # room-perimeter keyframes) — a genuine selective-vs-dense
                # coverage difference, reported rather than crashed on
                entry["dense_coverage"] = "none"
            if objects_dir is not None:
                entry["cloud"] = cloud_name
            report["objects"][name] = entry
        del dense_xy, above

        # combined-scene metrics (the eval_table_chair protocol evaluates the
        # whole proposal cloud against the whole-scene GT, not per object)
        all_prop = np.concatenate([r.points for r in prop_clouds.values()])
        m_all = evaluate_map(all_prop, gt_all, device=dev)
        report["combined_accuracy_cm"] = round(float(m_all.accuracy_cm), 3)
        report["combined_completeness_cm"] = round(
            float(m_all.completeness_cm), 3)

    stats = hybrid_map_size_stats(pgm_path, objdir, dense_path)
    report["hybrid_bytes"] = stats.hybrid_bytes
    report["dense_bytes"] = stats.dense_bytes
    report["size_reduction_percent"] = round(stats.reduction_percent, 2)
    ds_bytes = os.path.getsize(dense_ds_path)
    report["dense_downsampled_bytes"] = ds_bytes
    report["size_reduction_downsampled_percent"] = round(
        100.0 * (1.0 - stats.hybrid_bytes / ds_bytes), 2)
    # third framing — BOTH maps voxel-filtered at the reconstruction voxel
    # size: per-MEMBER capture sites (round 5) overlap (a chair's frames
    # legitimately see the table edge behind it), so the raw per-object
    # PLYs double-store shared surfaces; at map resolution the union
    # carries the same information. Symmetric with the dense_downsampled
    # side (comparing raw selective vs downsampled dense mixes framings).
    with timer.stage("downsample", sync=True):
        sel_pts, _, sel_mask = voxel_downsample(
            torch.as_tensor(all_prop.astype(np.float32), device=dev),
            voxel_size)
        sel_pts = sel_pts[sel_mask].cpu().numpy()
    sel_ds_path = os.path.join(workdir, "selective_downsampled.ply")
    with timer.stage("ply_write"):
        tio.write_ply(sel_ds_path, sel_pts)
    sel_ds_bytes = os.path.getsize(sel_ds_path) + os.path.getsize(pgm_path)
    report["selective_downsampled_bytes"] = sel_ds_bytes
    report["size_reduction_voxel_percent"] = round(
        100.0 * (1.0 - sel_ds_bytes / ds_bytes), 2)
    report["reference_claim_percent"] = 99.0     # README.md:60
    report["hybrid_map_path"] = hybrid_path
    if timings is not None:
        timings.update(timer.totals)
    return report


def _grid_to_pgm(grid) -> np.ndarray:
    """Occupancy grid -> slam_toolbox-style PGM image (254 free, 0 occupied,
    205 unknown; row 0 at the TOP like map_saver writes)."""
    data = grid._host_data()
    img = np.full(data.shape, 205, np.uint8)
    img[data == 0] = 254
    img[data == 100] = 0
    return img[::-1]
