"""Direct frame-to-model tracking against the TSDF (counterpart of
otslam_tpu/kernels/track.py).

KinectFusion-style camera tracking: each Gauss-Newton iteration
trilinearly samples the signed distance field at the frame's transformed
points and steps the pose down the field's own gradient,

    minimize_T   sum_p  w_p * ( sdf( T . p ) )^2,

so no surface extraction and no correspondence search exist. Plain
PyTorch: the JAX function is no Pallas kernel either. The corner lookups
are gathers into the block volume's (NB+1, 512) rows; the iterations are
a Python loop with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from otslam_tpu_torch.kernels.pose_graph import exp_se3
from otslam_tpu_torch.kernels.tsdf import recip32
from otslam_tpu_torch.kernels.tsdf_block import (BLOCK, BLOCK_VOXELS,
                                                 BlockTSDFVolume)


def sample_tsdf_trilinear(vol: BlockTSDFVolume, pts: torch.Tensor):
    """Trilinear TSDF sample + analytic gradient at world points.

    pts: (P, 3) world coordinates on the volume's device. Returns
    (sdf (P,), grad (P, 3), valid (P,)): sdf in normalized units (stored
    tsdf, [-1, 1]); grad is d(sdf)/d(world); valid requires all 8
    interpolation corners observed (weight > 0) and in bounds. Corners
    cross block boundaries via flat (block_row, voxel) indexing."""
    bx, by, bz = vol.grid_blocks
    nb = bx * by * bz
    dims = (bx * BLOCK, by * BLOCK, bz * BLOCK)
    dev = pts.device
    origin = torch.tensor(vol.origin, dtype=torch.float32, device=dev)
    inv_vs = recip32(vol.voxel_size)

    # continuous voxel-center coordinates, rounded once as the fused
    # multiply-add XLA makes of them (the product of two f32 values and the
    # -0.5 are exact in f64), so floor() picks the JAX package's cells
    g = ((pts - origin).double() * inv_vs - 0.5).float()   # (P, 3)
    i0 = torch.floor(g).to(torch.int32)
    f = g - i0.to(torch.float32)                            # [0, 1)
    hi = torch.tensor(dims, dtype=torch.int32, device=dev) - 1

    tsdf_flat = vol.tsdf[:nb].reshape(-1)
    w_flat = vol.weight[:nb].reshape(-1)

    def corner(dx, dy, dz):
        v = i0 + torch.tensor([dx, dy, dz], dtype=torch.int32, device=dev)
        inb = ((v[:, 0] >= 0) & (v[:, 0] < dims[0])
               & (v[:, 1] >= 0) & (v[:, 1] < dims[1])
               & (v[:, 2] >= 0) & (v[:, 2] < dims[2]))
        vc = torch.minimum(torch.clamp(v, min=0), hi).long()
        bid = ((vc[:, 0] // BLOCK) * (by * bz)
               + (vc[:, 1] // BLOCK) * bz + (vc[:, 2] // BLOCK))
        loc = ((vc[:, 0] % BLOCK) * (BLOCK * BLOCK)
               + (vc[:, 1] % BLOCK) * BLOCK + (vc[:, 2] % BLOCK))
        flat = bid * BLOCK_VOXELS + loc
        return tsdf_flat[flat], (w_flat[flat] > 0) & inb

    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    sdf = torch.zeros(pts.shape[0], dtype=torch.float32, device=dev)
    gx = torch.zeros_like(sdf)
    gy = torch.zeros_like(sdf)
    gz = torch.zeros_like(sdf)
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    for dx in (0, 1):
        wx_ = fx if dx else 1.0 - fx
        dwx = 1.0 if dx else -1.0
        for dy in (0, 1):
            wy_ = fy if dy else 1.0 - fy
            dwy = 1.0 if dy else -1.0
            for dz in (0, 1):
                wz_ = fz if dz else 1.0 - fz
                dwz = 1.0 if dz else -1.0
                s, ok = corner(dx, dy, dz)
                valid &= ok
                sdf = sdf + s * (wx_ * wy_ * wz_)
                gx = gx + s * (dwx * wy_ * wz_)
                gy = gy + s * (wx_ * dwy * wz_)
                gz = gz + s * (wx_ * wy_ * dwz)
    grad = torch.stack([gx, gy, gz], dim=-1) * inv_vs
    return sdf, grad, valid


class TrackResult(NamedTuple):
    transformation: torch.Tensor   # (4, 4) camera -> world
    rmse: torch.Tensor             # final inlier |sdf| RMSE, meters
    inlier_fraction: torch.Tensor  # valid & in-band share of frame points


def track_frame_to_tsdf(vol: BlockTSDFVolume, pts_cam: torch.Tensor,
                        pts_valid: torch.Tensor, T_init: torch.Tensor,
                        max_iterations: int = 12,
                        damping: float = 1e-3,
                        max_step_rot: float = 0.1,
                        max_step_tr: float = 0.1) -> TrackResult:
    """Align a frame's camera-space points onto the TSDF zero set.

    pts_cam: (P, 3) camera-frame points (pts_valid masks), T_init: (4, 4)
    camera->world prior, all on the volume's device. Each iteration samples
    sdf + gradient at the transformed points, solves the damped 6x6 normal
    equations of the level-set distance r = sdf / |grad sdf| with
    J = [q x n | n], and updates T <- exp_se3(step) @ T. Points on the far
    side of the band (sdf <= -0.95) or in unobserved space drop out per
    iteration; a Huber weight (delta = one voxel) tames outliers."""
    trunc = vol.sdf_trunc
    huber = vol.voxel_size
    dev = pts_cam.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    T = T_init.to(device=dev, dtype=torch.float32)
    for _ in range(max_iterations):
        q = pts_cam @ T[:3, :3].T + T[:3, 3]
        s, g, ok = sample_tsdf_trilinear(vol, q)
        gn = torch.linalg.norm(g, dim=-1)
        gnc = torch.clamp(gn, min=1e-9)
        n = g / gnc[:, None]
        # level-set distance: s / |g| is the first-order true distance
        # along the gradient (the fused field is a projective distance)
        r = s / gnc
        w = (pts_valid & ok & (s > -0.95) & (s < 0.95)
             & (gn > 0.1 / trunc)).to(torch.float32)
        w = w * torch.clamp(torch.full_like(r, huber)
                            / torch.clamp(torch.abs(r), min=1e-9), max=1.0)
        c = torch.linalg.cross(q, n, dim=-1)
        J = torch.cat([c, n], dim=-1)                    # (P, 6)
        Jw = J * w[:, None]
        A = Jw.T @ J
        A = A + (damping * torch.trace(A) * recip32(6.0) + 1e-9) * eye6
        b = -(Jw.T @ r)
        x = torch.linalg.solve_ex(A, b)[0]
        rot_n = torch.linalg.norm(x[:3])
        tr_n = torch.linalg.norm(x[3:])
        scale = torch.clamp(torch.minimum(
            torch.full_like(rot_n, max_step_rot)
            / torch.clamp(rot_n, min=1e-9),
            torch.full_like(tr_n, max_step_tr)
            / torch.clamp(tr_n, min=1e-9)), max=1.0)
        T = exp_se3(x * scale) @ T

    q = pts_cam @ T[:3, :3].T + T[:3, 3]
    s, g, ok = sample_tsdf_trilinear(vol, q)
    dist = s / torch.clamp(torch.linalg.norm(g, dim=-1), min=1e-9)
    inband = pts_valid & ok & (torch.abs(s) < 0.95)
    nin = torch.clamp(torch.sum(inband), min=1)
    rmse = torch.sqrt(torch.sum(torch.where(inband, dist * dist, 0.0)) / nin)
    frac = torch.sum(inband) / torch.clamp(torch.sum(pts_valid), min=1)
    return TrackResult(T, rmse, frac)
