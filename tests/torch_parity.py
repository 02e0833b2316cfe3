"""Shared fixtures for the otslam_tpu vs otslam_tpu_torch parity tests.

Inputs are made once in numpy (from a seed or the JAX renderer) and handed
to both packages; results come back as numpy arrays.

Rounding note. XLA:CPU contracts ``a*b + c`` into fused multiply-adds and
rewrites division by a constant as multiplication by its f32 reciprocal;
the port (and its CUDA kernels, built with -fmad=false) rounds every
product separately. The classification comparisons survive that bit for bit
at these sizes, but a voxel whose projection lands within a few ulps of a
.5 pixel boundary (or whose sdf lands on -sdf_trunc) can round to the other
pixel in one package. `ambiguous_voxels` marks exactly those voxels; the
fusion tests demand exact weights and 1e-5 tsdf everywhere else, and bound
the share of marked voxels.
"""

from __future__ import annotations

import numpy as np
import torch

from otslam_tpu.core.camera import PinholeIntrinsics as JIntr
from otslam_tpu.sim.sensors import look_at_pose, render_rgbd
from otslam_tpu.sim.world import cardboard_room
from otslam_tpu_torch.core.camera import PinholeIntrinsics as TIntr

# a QQVGA-scaled copy of the reference camera (fx scaled with the width)
SMALL_CAM = dict(width=160, height=120, fx=141.400225, fy=141.400225,
                 cx=80.5, cy=60.5)
J_SMALL = JIntr(**SMALL_CAM)
T_SMALL = TIntr(**SMALL_CAM)
BOX_CENTER = (1.5, 0.5, 0.15)        # cardboard_room()'s box
DEPTH_TRUNC = 3.0                    # CameraConfig.depth_trunc

# The parity tests run thousands of small torch ops (ICP and tracking
# loops) while JAX tests fill the other cores of a parallel run; torch's
# default one-thread-per-core pool then oversubscribes the machine and
# slows these files about fivefold. One intra-op thread each avoids that.
torch.set_num_threads(1)


def capture(n_frames: int, intr=J_SMALL, radius: float = 1.0,
            height: float = 0.5, phase: float = 0.0):
    """A capture circle around the cardboard box, rendered by the JAX
    package: (depths (N,H,W), colors (N,H,W,3), extrinsics (N,4,4)) f32,
    depth truncated as CaptureDataset.load_object does."""
    scene = cardboard_room()
    c = np.asarray(BOX_CENTER)
    ds, cs, es = [], [], []
    for i in range(n_frames):
        a = 2 * np.pi * i / n_frames + phase
        eye = np.array([c[0] + radius * np.cos(a), c[1] + radius * np.sin(a),
                        height])
        pose = look_at_pose(eye, c)
        d, col = render_rgbd(scene, pose, intr, far=5.0)
        d = np.asarray(d)
        ds.append(np.where((d > 0) & (d <= DEPTH_TRUNC), d, 0.0))
        cs.append(np.asarray(col))
        es.append(np.linalg.inv(pose))
    return (np.stack(ds).astype(np.float32), np.stack(cs).astype(np.float32),
            np.stack(es).astype(np.float32))


def voxel_centers(meta):
    """(NB+1, 512) x 3 float64 voxel-center coordinates of a block volume
    (the dead row repeats block 0; callers mask it)."""
    (bx, by, bz), origin, vs, _ = meta
    ids = np.concatenate([np.arange(bx * by * bz), [0]])
    l = np.arange(512)
    idx = (ids // (by * bz), (ids // bz) % by, ids % bz)
    loc = (l // 64, (l // 8) % 8, l % 8)
    return [origin[k] + ((idx[k][:, None] * 8 + loc[k][None]) + 0.5) * vs
            for k in range(3)]


def ambiguous_voxels(points, depths, extrinsics, intr, sdf_trunc,
                     tol_px: float = 1e-4, tol_sdf: float = 1e-5):
    """Mask (shape of points[0]) of voxels that, in any frame, project in
    front of the camera within tol_px of a .5 pixel boundary or land within
    tol_sdf of the -sdf_trunc cut: the voxels where one rounding of the
    projection can pick another pixel or validity."""
    px, py, pz = (np.asarray(p, np.float64) for p in points)
    amb = np.zeros(px.shape, bool)
    for d, E in zip(depths, np.asarray(extrinsics, np.float64)):
        cam = [E[r, 0] * px + E[r, 1] * py + E[r, 2] * pz + E[r, 3]
               for r in range(3)]
        z = np.where(cam[2] > 0, cam[2], 1.0)
        u = intr.fx * cam[0] / z + intr.cx
        v = intr.fy * cam[1] / z + intr.cy
        near = ((np.abs(u - np.floor(u) - 0.5) < tol_px)
                | (np.abs(v - np.floor(v) - 0.5) < tol_px))
        ui = np.clip(np.round(u), 0, intr.width - 1).astype(np.int64)
        vi = np.clip(np.round(v), 0, intr.height - 1).astype(np.int64)
        near |= np.abs(d[vi, ui] - cam[2] + sdf_trunc) < tol_sdf
        amb |= near & (cam[2] > 0)
    return amb


def assert_fusion_matches(w_ref, t_ref, c_ref, w, t, c, amb,
                          max_ambiguous: float = 0.05):
    """Exact weights, tsdf <= 1e-5 and colour <= 1e-3 on every voxel off
    the rounding-ambiguous set; that set stays a small share of the
    observed voxels. Colour arrays are (rows, 3*512) channel-major."""
    observed = (w_ref > 0) | (w > 0)
    assert observed.sum() > 1000
    assert (amb & observed).sum() <= max_ambiguous * observed.sum()
    ok = ~amb
    np.testing.assert_array_equal(w[ok], w_ref[ok])
    np.testing.assert_allclose(t[ok], t_ref[ok], rtol=0, atol=1e-5)
    ok3 = np.tile(ok, (1, 3)) if c.ndim == 2 else np.broadcast_to(ok, c.shape)
    np.testing.assert_allclose(c[ok3], c_ref[ok3], rtol=0, atol=1e-3)


def lattice_box(center=BOX_CENTER, size=(0.5, 0.4, 0.3), yaw=0.3,
                spacing: float = 0.012, jitter: float = 0.001,
                seed: int = 0):
    """Points and outward normals on the surface of an oriented box, on a
    per-face lattice of `spacing` jittered by up to `jitter` (float32).

    Every two points lie at least spacing - 2 * jitter apart, so a copy
    moved by less than a third of that has one unambiguous nearest
    neighbour per point: registration tests then agree between packages
    whose NN distances round differently (the JAX package's XLA path
    takes |a|^2 + |b|^2 - 2ab)."""
    rng = np.random.default_rng(seed)
    half = np.asarray(size, np.float64) / 2
    pts, nrm = [], []
    for axis in range(3):
        u, v = [k for k in range(3) if k != axis]
        # a margin of one spacing keeps the faces' lattices apart too
        gu = np.arange(-half[u] + spacing, half[u] - spacing / 2, spacing)
        gv = np.arange(-half[v] + spacing, half[v] - spacing / 2, spacing)
        uu, vv = np.meshgrid(gu, gv, indexing="ij")
        for sign in (-1.0, 1.0):
            p = np.zeros((uu.size, 3))
            p[:, u] = uu.ravel()
            p[:, v] = vv.ravel()
            p[:, axis] = sign * half[axis]
            p[:, [u, v]] += rng.uniform(-jitter, jitter, (uu.size, 2))
            n = np.zeros((uu.size, 3))
            n[:, axis] = sign
            pts.append(p)
            nrm.append(n)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    pts = np.concatenate(pts) @ R.T + np.asarray(center)
    nrm = np.concatenate(nrm) @ R.T
    return pts.astype(np.float32), nrm.astype(np.float32)


def small_motion(rot=(0.002, -0.003, 0.0025), trans=(0.0012, -0.001, 0.0008),
                 about=BOX_CENTER):
    """(4, 4) float64 rigid motion of a few mm, rotating about `about`."""
    from otslam_tpu.core.se3 import euler_xyz_to_matrix, se3
    R = euler_xyz_to_matrix(*rot)
    c = np.asarray(about, np.float64)
    return se3(R, c - R @ c + np.asarray(trans))
