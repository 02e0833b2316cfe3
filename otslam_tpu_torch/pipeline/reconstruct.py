"""Per-object 3D reconstruction pipelines (counterpart of
otslam_tpu/pipeline/reconstruct.py).

* ``reconstruct_frames``  — the post-load body: fuse a frame batch, then
  either extract the surface, sample N points and remove the floor
  (Z < 0.03 m), or extract a welded marching-tetrahedra mesh.
* ``reconstruct_object``  — reconstruct_rgbd_filter.py: load one object's
  frames from a capture dataset, then ``reconstruct_frames``; saves a PLY.
* ``reconstruct_range``   — multi_reconstruct_rgbd_filter.py: explicit frame
  ranges per object.
* ``reconstruct_all``     — main() loop over every object in a dataset.

``backend`` keeps the JAX package's names: "pallas" and "sparse" both reach
the block-sparse path (kernels/tsdf_block.py), which launches the CUDA
kernels for CUDA tensors; "dense" reaches kernels/tsdf.py. ``refine``
corrects the capture poses before the main fusion (pipeline/refine.py):
"icp", "f2m" or "pgo".

With `timings=`, ``reconstruct_frames`` and ``reconstruct_object`` record
the call's span tree and counter changes (utils/profiling.py) under
``timings["trace"]``, in one recorder:

    recon.object
    ├ recon.load            reconstruct_object: CaptureDataset.load_object
    │  ├ load.read          the frames' files' bytes      (a phase each:
    │  ├ load.decode        their JPG and PNG decodes      one map over the
    │  └ load.convert       their float planes and poses   frames, pooled)
    ├ recon.auto_volume
    ├ recon.refine          (refine != "none"; its refine.upload copies the
    │                         frames, and fuse.upload then only the poses;
    │                         the refiner's own spans, pipeline/refine.py)
    ├ recon.fuse
    │  ├ fuse.upload        the host frames to the card
    │  ├ fuse.volume        the block volume's allocation and zero fill
    │  ├ fuse.schedule      mips, K2, creation, the work list (one sync)
    │  ├ fuse.pack          the colour pack
    │  └ fuse.k1            the range check (one sync), K1, the created
    │                         mask and the dead row
    └ recon.extract
       ├ extract.surface    cloud: the zero crossings and their compactions
       ├ extract.sample     cloud: the count and the resampling
       ├ extract.march      mesh: the marching soup and its compaction
       ├ extract.to_host    the copies to the host (mesh on the card:
       │                      the soup's masked rows, then the copy back)
       ├ extract.floor      cloud: the floor filter
       └ extract.weld       mesh: the weld, on the device of the soup
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch

from otslam_tpu_torch.config import ReconstructionConfig
from otslam_tpu_torch.core import io as tio
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.device import resolve_device, to_f32, to_host
from otslam_tpu_torch.kernels.marching import extract_mesh
from otslam_tpu_torch.kernels.sampling import resample_points
from otslam_tpu_torch.kernels.tsdf import (
    extract_surface_points, integrate_frames, make_volume)
from otslam_tpu_torch.kernels.tsdf_block import (
    BlockTSDFVolume, block_to_dense, extract_surface_points_sparse,
    integrate_frames_sparse, make_block_volume)
from otslam_tpu_torch.pipeline.dataset import CaptureDataset, FrameBatch
from otslam_tpu_torch.pipeline.refine import (
    _icp_poses, _pgo_poses, refine_trajectory_f2m)
from otslam_tpu_torch.utils.profiling import (
    COUNTS, count, drain, recording, span)

BACKENDS = ("pallas", "sparse", "dense")
OUTPUTS = ("cloud", "mesh")
REFINERS = {"icp": _icp_poses, "f2m": refine_trajectory_f2m,
            "pgo": _pgo_poses}
STAGES = ("load", "auto_volume", "refine", "fuse", "extract")


def _observed_world_points(batch, intr: PinholeIntrinsics,
                           stride: int = 8) -> np.ndarray:
    """(P, 3) world points from a sparse pixel subset of every frame."""
    pts = []
    for i in range(batch.depths.shape[0]):
        d = batch.depths[i, ::stride, ::stride]
        ok = d > 0
        if not ok.any():
            continue
        ys, xs = np.nonzero(ok)
        z = d[ys, xs]
        u = xs * stride
        v = ys * stride
        x = (u - intr.cx) / intr.fx * z
        y = (v - intr.cy) / intr.fy * z
        cam = np.stack([x, y, z, np.ones_like(z)])
        world = np.linalg.inv(batch.extrinsics[i].astype(np.float64)) @ cam
        pts.append(world[:3].T)
    return np.concatenate(pts) if pts else np.zeros((0, 3))


def auto_volume_origin(batch, intr: PinholeIntrinsics,
                       cfg: ReconstructionConfig) -> tuple:
    """Center the object volume on the observed geometry.

    Open3D's ScalableTSDFVolume is extent-free (hash map); our dense block
    grid needs an origin. Estimate the object center by back-projecting a
    sparse pixel subset of every frame into world space and averaging, then
    place the grid so the center sits mid-volume (z aligned to start just
    below the floor).
    """
    pts = _observed_world_points(batch, intr)
    c = np.mean(pts, axis=0)
    X, Y, Z = cfg.tsdf.dims
    vs = cfg.tsdf.voxel_size
    origin = (float(c[0] - X * vs / 2), float(c[1] - Y * vs / 2),
              float(min(c[2] - Z * vs / 2, -0.02)))
    return origin


def auto_volume_config(batch, intr: PinholeIntrinsics,
                       cfg: ReconstructionConfig,
                       near_radius: float = 4.0,
                       max_dim: int = 512) -> ReconstructionConfig:
    """cfg with the volume origin AND dims fitted to the observed object.

    Open3D's ScalableTSDFVolume grows unbounded (reconstruct_rgbd.py:79-83);
    the dense block grid must size up-front, and a tracked GROUP (e.g. the
    full_room table + chairs merged by the tuned 4 m cluster radius) can
    exceed the default extent — frames then fuse into a volume that clips
    the group's outer members. Extent comes from the 2nd/98th percentile of
    floor-filtered observed points within the capture circle's own radius
    of the ray-converged target center (captures also see floor, walls and
    far background; the circle bounds the target by construction —
    `near_radius` caps the crop), padded by 8 cells and bucketed to
    64-cell multiples (bounds jit-cache variants) between the configured
    dims and `max_dim`.
    """
    pts = _observed_world_points(batch, intr)
    if not len(pts):
        return dataclasses.replace(cfg, tsdf=dataclasses.replace(
            cfg.tsdf, origin=auto_volume_origin(batch, intr, cfg)))
    # the captures see the floor across the whole frustum; measure the
    # OBJECT's extent above the z-filter plane (the same floor cut the
    # output cloud applies, reconstruct_rgbd_filter.py:22,128)
    above = pts[pts[:, 2] >= cfg.z_filter_threshold]
    if len(above) >= 50:
        pts = above
    # target center = least-squares intersection of the capture circle's
    # optical axes (every viewpoint faces the object,
    # 3_multi_object_goal_selector.cpp:275-308 yaw=angle+pi); the circle's
    # radius then bounds the object — background geometry (walls, other
    # objects) beyond the cameras must not inflate the volume
    E = np.asarray(batch.extrinsics, np.float64)
    cams = -np.einsum("nij,ni->nj", E[:, :3, :3], E[:, :3, 3])
    axes = E[:, 2, :3]                     # optical +z rows of world->cam
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for ci, di in zip(cams, axes):
        P = np.eye(3) - np.outer(di, di)
        A += P
        b += P @ ci
    try:
        c = np.linalg.solve(A + 1e-9 * np.eye(3), b)
    except np.linalg.LinAlgError:
        c = np.median(pts, axis=0)
    cam_r = float(np.median(
        np.linalg.norm(cams[:, :2] - c[None, :2], axis=1)))
    # the circle stands off the object by the visiting buffer + lock margin
    # (~0.7 m tuned): the object proper ends well inside cam_r, while walls
    # behind it can sit just outside the circle — crop strictly inside
    crop_r = min(max(cam_r - 0.5, 0.5), near_radius)
    near = pts[np.linalg.norm(pts[:, :2] - c[None, :2], axis=1) < crop_r]
    if len(near) < 50:
        near = pts
    lo = np.percentile(near, 2, axis=0)
    hi = np.percentile(near, 98, axis=0)
    vs = cfg.tsdf.voxel_size
    margin = 8 * vs
    need = hi - lo + 2 * margin
    dims = []
    for k, base in enumerate(cfg.tsdf.dims):
        cells = int(np.ceil(need[k] / vs / 64.0)) * 64
        dims.append(int(min(max(cells, base), max_dim)))
    cx, cy = (lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2
    origin = (float(cx - dims[0] * vs / 2), float(cy - dims[1] * vs / 2),
              float(min(lo[2] - margin, -0.02)))
    return dataclasses.replace(cfg, tsdf=dataclasses.replace(
        cfg.tsdf, dims=tuple(dims), origin=origin))


@dataclass
class ReconstructionResult:
    points: np.ndarray          # (M, 3) surface points (filtered, sampled)
    colors: np.ndarray          # (M, 3) float [0,1]
    normals: np.ndarray | None  # (M, 3) or None
    num_frames: int
    raw_surface_count: int
    # (N, 4, 4) world->camera poses the fusion used (refined or as given)
    extrinsics: np.ndarray | None = None
    # (F, 3) int32 triangles over `points` for mesh output, else None
    faces: np.ndarray | None = None


def fuse_frames(depths, colors, extrinsics, intr: PinholeIntrinsics,
                cfg: ReconstructionConfig, backend: str = "pallas",
                max_active: int | None = None, densify: bool = True,
                device="cuda"):
    """Fuse a stacked frame batch into a TSDF volume on `device`.

    depths (N,H,W) meters, colors (N,H,W,3) [0,255], extrinsics (N,4,4)
    world->camera, as arrays or tensors. max_active caps the block backends
    at each frame's max_active lowest active block ids; None fuses every
    active block. densify=False keeps the block backends in block form
    (extraction then runs on created blocks only)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)
    with span("fuse.upload"):
        depths, colors, extrinsics = (to_f32(x, dev)
                                      for x in (depths, colors, extrinsics))
    if backend == "dense":
        dtype = torch.bfloat16 if cfg.tsdf.use_bfloat16 else torch.float32
        return integrate_frames(make_volume(cfg.tsdf, dev, dtype), depths,
                                colors, extrinsics, intr)
    with span("fuse.volume"):
        vol = make_block_volume(cfg.tsdf, dev)
    vol = integrate_frames_sparse(vol, depths, colors, extrinsics, intr,
                                  max_active=max_active)
    return block_to_dense(vol) if densify else vol


def extract_filtered_cloud(vol, cfg: ReconstructionConfig,
                           seed: int = 0, capacity: int = 2_000_000,
                           z_filter: bool = True,
                           with_normals: bool = True,
                           draws: torch.Tensor | None = None
                           ) -> ReconstructionResult:
    """Surface extraction + uniform sampling + floor filter
    (reconstruct_rgbd_filter.py:119-134). Accepts dense or block volumes;
    block volumes extract from created blocks only. The sample draws come
    from a torch.Generator seeded with `seed`, or from `draws`."""
    with span("extract.surface"):
        if isinstance(vol, BlockTSDFVolume):
            out = extract_surface_points_sparse(vol, capacity=capacity,
                                                with_normals=with_normals)
        else:
            out = extract_surface_points(vol, capacity=capacity,
                                         with_normals=with_normals)
    pts, cols, mask = out[:3]
    normals = out[3] if with_normals else None
    with span("extract.sample"):
        raw_count = pts.shape[0]        # the mask is all ones
        gen = torch.Generator(device=pts.device).manual_seed(seed)
        s_pts, s_cols, s_nrm = resample_points(
            pts, mask, cfg.surface_samples, colors=cols, normals=normals,
            generator=gen, draws=draws)
    with span("extract.to_host"):
        p = to_host(s_pts)
        c = to_host(s_cols)
        nrm = None if s_nrm is None else to_host(s_nrm)
    if z_filter:
        with span("extract.floor"):
            keep = p[:, 2] >= cfg.z_filter_threshold
            p, c = p[keep], c[keep]
            if nrm is not None:
                nrm = nrm[keep]
    return ReconstructionResult(p, c, nrm, 0, raw_count)


def _check(output: str, refine: str) -> None:
    if output not in OUTPUTS:
        raise ValueError(f"unknown output {output!r}")
    if refine != "none" and refine not in REFINERS:
        raise ValueError(f"unknown refine {refine!r}")


@contextlib.contextmanager
def _object_record(timings: dict | None):
    """One object's `recon.object` span, in a recorder of its own when
    `timings` is given, which then receives the stages' seconds and the
    record (see `reconstruct_frames`). The block sets the yielded dict's
    "frames"."""
    count("recon.objects")
    out = {"object": COUNTS["recon.objects"]}
    rec = recording() if timings is not None else contextlib.nullcontext()
    with rec as r, span("recon.object"):
        yield out
    if timings is not None:
        for stage in STAGES:
            sec = r.seconds("recon." + stage)
            if sec is not None:
                timings[stage] = sec
        timings["trace"] = {**out, "spans": r.spans, "counts": r.counts()}


def reconstruct_frames(batch: FrameBatch, intr: PinholeIntrinsics,
                       cfg: ReconstructionConfig | None = None,
                       backend: str = "pallas", z_filter: bool = True,
                       seed: int = 0, output: str = "cloud",
                       auto_origin: bool = False, refine: str = "none",
                       auto_dims: bool | None = None, device="cuda",
                       draws: torch.Tensor | None = None,
                       timings: dict | None = None) -> ReconstructionResult:
    """The per-object pipeline after dataset loading: (auto-sized volume)
    -> (pose refinement) -> fusion -> surface extraction, sampling and
    floor filter, or a welded mesh.

    batch holds host arrays, as CaptureDataset.load_object returns them;
    the work runs on `device`. output='cloud' is the filtered sampled
    point cloud; output='mesh' the marching-tetrahedra mesh, welded on the
    device, with its faces and area-weighted vertex normals (no sampling or
    floor filter). auto_origin=True centers (and, unless auto_dims is
    False, sizes) the volume on the observed geometry.
    refine: 'none' trusts the dataset poses (the reference trusts TF),
    'icp' chains frame-to-frame ICP corrections, 'f2m' tracks each frame
    against the fused TSDF, 'pgo' adds loop-closure edges and a pose-graph
    solve; only the refined extrinsics feed the main fusion.
    `timings`, when given, receives the seconds of each stage
    ("auto_volume", "refine", "fuse", "extract"; a mesh's "extract" holds
    the extraction and the weld), each ending in a device sync, and under
    "trace" the call's record: {"object": its number in the process,
    "frames": the frame count, "spans": [[name, parent, t0_ns, t1_ns],
    ...] (the module docstring's tree), "counts": the change of each
    process counter}."""
    _check(output, refine)
    with _object_record(timings) as out:
        res = _reconstruct(batch, intr, cfg or ReconstructionConfig(),
                           backend, z_filter, seed, output, auto_origin,
                           refine, auto_dims, resolve_device(device), draws)
        out["frames"] = res.num_frames
    return res


def _reconstruct(batch, intr, cfg, backend, z_filter, seed, output,
                 auto_origin, refine, auto_dims, dev, draws):
    """`reconstruct_frames`' stages, inside the object's record."""
    with span("recon.auto_volume"):
        if auto_origin:
            if auto_dims is None or auto_dims:
                cfg = auto_volume_config(batch, intr, cfg)
            else:
                cfg = dataclasses.replace(cfg, tsdf=dataclasses.replace(
                    cfg.tsdf, origin=auto_volume_origin(batch, intr, cfg)))
        drain(dev)
    depths, colors = batch.depths, batch.colors
    if refine != "none":
        with span("recon.refine"):
            with span("refine.upload"):     # fuse_frames reuses them
                depths, colors = to_f32(depths, dev), to_f32(colors, dev)
            refined = REFINERS[refine](depths, colors, batch.extrinsics,
                                       intr, cfg, device=dev)
            batch = dataclasses.replace(batch, extrinsics=refined.extrinsics)
            drain(dev)
    with span("recon.fuse"):
        vol = fuse_frames(depths, colors, batch.extrinsics, intr, cfg,
                          backend, densify=False, device=dev)
        drain(dev)
    with span("recon.extract"):
        if output == "mesh":
            verts, faces, cols, normals = extract_mesh(vol)
            res = ReconstructionResult(verts, cols, normals, 0, len(verts),
                                       faces=faces)
        else:
            res = extract_filtered_cloud(vol, cfg, seed=seed,
                                         z_filter=z_filter, draws=draws)
        drain(dev)
    res.num_frames = len(batch.names)
    res.extrinsics = np.asarray(batch.extrinsics)
    return res


def _save(save_dir: str | None, name: str, res: ReconstructionResult):
    if save_dir is not None:
        tio.write_ply(os.path.join(save_dir, f"{name}.ply"), res.points,
                      colors=res.colors, normals=res.normals, faces=res.faces)


def reconstruct_object(ds: CaptureDataset, obj_name: str,
                       cfg: ReconstructionConfig | None = None,
                       backend: str = "pallas", save_dir: str | None = None,
                       z_filter: bool = True, seed: int = 0,
                       frame_numbers: Sequence[int] | None = None,
                       output: str = "cloud",
                       auto_origin: bool = False,
                       refine: str = "none",
                       auto_dims: bool | None = None, device="cuda",
                       draws: torch.Tensor | None = None,
                       timings: dict | None = None
                       ) -> ReconstructionResult:
    """Full per-object pipeline; writes <save_dir>/<obj_name>.ply if asked.

    output='cloud': filtered sampled point cloud (reconstruct_rgbd_filter.py);
    output='mesh': welded triangle mesh with vertex normals, saved with its
    faces (reconstruct_rgbd.py's extract_triangle_mesh +
    compute_vertex_normals); see `reconstruct_frames` for the rest.
    `timings` is `reconstruct_frames`' with the "load" stage first (the
    dataset read, no device work) and its spans in the same record; the
    PLY write comes after the record."""
    _check(output, refine)
    with _object_record(timings) as out:
        with span("recon.load"):
            batch = ds.load_object(obj_name, frame_numbers)
        intr = PinholeIntrinsics.from_config(ds.camera)
        res = _reconstruct(batch, intr, cfg or ReconstructionConfig(),
                           backend, z_filter, seed, output, auto_origin,
                           refine, auto_dims, resolve_device(device), draws)
        out["frames"] = res.num_frames
    _save(save_dir, obj_name, res)
    return res


def reconstruct_range(ds: CaptureDataset,
                      object_ranges: Mapping[str, tuple],
                      cfg: ReconstructionConfig | None = None,
                      backend: str = "pallas", save_dir: str | None = None,
                      **kw) -> dict:
    """Explicit frame ranges per object: {"Object_0": (1, 16), ...}
    (multi_reconstruct_rgbd_filter.py:23-32; ranges inclusive)."""
    return {name: reconstruct_object(ds, name, cfg, backend, save_dir,
                                     frame_numbers=range(lo, hi + 1), **kw)
            for name, (lo, hi) in object_ranges.items()}


def reconstruct_all(ds: CaptureDataset, cfg: ReconstructionConfig | None = None,
                    backend: str = "pallas", save_dir: str | None = None,
                    **kw) -> dict:
    """Reconstruct every object found in the dataset (main() loop)."""
    return {name: reconstruct_object(ds, name, cfg, backend, save_dir, **kw)
            for name in ds.object_names()}
