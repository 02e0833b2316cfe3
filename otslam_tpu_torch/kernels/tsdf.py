"""Dense TSDF fusion, plain PyTorch (counterpart of otslam_tpu/kernels/tsdf.py).

The semantic reference for the block-sparse path (kernels/tsdf_block.py):
every voxel center projects into each frame, samples the depth image at its
rounded pixel and updates a running weighted mean (weight 1 per valid
observation). Surface extraction is the TSDF zero crossing along +x/+y/+z.

The op order follows the JAX function line for line so that both packages
round alike; tests hold the two to stated tolerances.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from otslam_tpu_torch.config import TSDFConfig
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.device import resolve_device
from otslam_tpu_torch.utils.profiling import waited


@dataclass
class TSDFVolume:
    """tsdf/weight: (X, Y, Z); color: (3, X, Y, Z) running-mean RGB [0,255]."""

    tsdf: torch.Tensor
    weight: torch.Tensor
    color: torch.Tensor
    origin: Tuple[float, float, float]
    voxel_size: float
    sdf_trunc: float

    @property
    def dims(self) -> Tuple[int, int, int]:
        return tuple(self.tsdf.shape)  # type: ignore[return-value]

    @classmethod
    def from_numpy(cls, tsdf, weight, color, origin, voxel_size, sdf_trunc,
                   device="cuda") -> "TSDFVolume":
        """Volume from numpy fields (e.g. np.asarray of a JAX volume's)."""
        dev = resolve_device(device)
        def t(a):
            return torch.tensor(np.asarray(a), device=dev)
        return cls(t(tsdf), t(weight), t(color),
                   tuple(float(o) for o in origin), float(voxel_size),
                   float(sdf_trunc))

    def to_numpy(self) -> dict:
        return {"tsdf": self.tsdf.cpu().numpy(),
                "weight": self.weight.cpu().numpy(),
                "color": self.color.cpu().numpy(),
                "origin": self.origin, "voxel_size": self.voxel_size,
                "sdf_trunc": self.sdf_trunc}


def make_volume(cfg: TSDFConfig, device="cuda",
                dtype: torch.dtype = torch.float32) -> TSDFVolume:
    X, Y, Z = cfg.dims
    dev = resolve_device(device)
    return TSDFVolume(
        tsdf=torch.zeros((X, Y, Z), dtype=dtype, device=dev),
        weight=torch.zeros((X, Y, Z), dtype=dtype, device=dev),
        color=torch.zeros((3, X, Y, Z), dtype=dtype, device=dev),
        origin=tuple(float(o) for o in cfg.origin),
        voxel_size=float(cfg.voxel_size),
        sdf_trunc=float(cfg.sdf_trunc),
    )


def _axis_coords(n: int, origin: float, voxel: float, device) -> torch.Tensor:
    """Voxel *center* world coordinates along one axis (f32)."""
    return origin + (torch.arange(n, dtype=torch.float32, device=device)
                     + 0.5) * voxel


def recip32(x: float) -> float:
    """The f32 reciprocal of the f32-rounded constant x. Division by a
    constant is taken as multiplication by this value everywhere: XLA
    rewrites it so, PyTorch's CUDA division by a scalar does too, and the
    CUDA kernels do the same, so every backend rounds alike."""
    return float(np.float32(1.0) / np.float32(x))


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of f32 tensors rounded once to f32, as the fused
    multiply-add that XLA:CPU contracts such an expression into: the
    product of two f32 values is exact in f64, and the f64 sum is rounded
    to f32."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _round_to_pixel(x: torch.Tensor, size: int) -> torch.Tensor:
    """Half-to-even rounding to an int32 pixel index (jnp.round semantics).
    Values are clamped to [-1, size] before the cast: every value outside
    the image is equally invalid, and the cast of a huge float is then
    defined on every backend."""
    return torch.clamp(torch.round(x), -1.0, float(size)).to(torch.int32)


def _observe_frame(vol: TSDFVolume, depth, color, extrinsic,
                   intr: PinholeIntrinsics):
    """Project every voxel into one frame; returns (tsdf_obs, w_obs, col_obs).

    depth (H, W) f32 meters (0 invalid); color (H, W, 3) f32 [0, 255];
    extrinsic (4, 4) world->camera."""
    X, Y, Z = vol.dims
    dt = vol.tsdf.dtype
    dev = vol.tsdf.device
    xs = _axis_coords(X, vol.origin[0], vol.voxel_size, dev)[:, None, None]
    ys = _axis_coords(Y, vol.origin[1], vol.voxel_size, dev)[None, :, None]
    zs = _axis_coords(Z, vol.origin[2], vol.voxel_size, dev)[None, None, :]

    E = extrinsic.to(torch.float32)
    px = E[0, 0] * xs + E[0, 1] * ys + E[0, 2] * zs + E[0, 3]
    py = E[1, 0] * xs + E[1, 1] * ys + E[1, 2] * zs + E[1, 3]
    pz = E[2, 0] * xs + E[2, 1] * ys + E[2, 2] * zs + E[2, 3]

    in_front = pz > 0
    zsafe = torch.where(in_front, pz, 1.0)
    u = _round_to_pixel(intr.fx * px / zsafe + intr.cx, intr.width)
    v = _round_to_pixel(intr.fy * py / zsafe + intr.cy, intr.height)
    inb = in_front & (u >= 0) & (u < intr.width) & (v >= 0) & (v < intr.height)
    flat = (torch.clamp(v, 0, intr.height - 1).long() * intr.width
            + torch.clamp(u, 0, intr.width - 1).long())
    d = depth.reshape(-1)[flat]

    sdf = d - pz
    valid = inb & (d > 0) & (sdf >= -vol.sdf_trunc)
    tsdf_obs = torch.clamp(sdf * recip32(vol.sdf_trunc), max=1.0).to(dt)
    w_obs = valid.to(dt)
    tsdf_obs = torch.where(valid, tsdf_obs, 0.0)

    cflat = color.reshape(-1, 3)
    col_obs = torch.stack([cflat[:, c][flat] for c in range(3)]).to(dt)
    col_obs = col_obs * w_obs[None]
    return tsdf_obs, w_obs, col_obs


def integrate_frame(vol: TSDFVolume, depth, color, extrinsic,
                    intr: PinholeIntrinsics) -> TSDFVolume:
    """Fuse one frame (running weighted mean, weight 1 per observation)."""
    tsdf_obs, w_obs, col_obs = _observe_frame(vol, depth, color, extrinsic,
                                              intr)
    w_new = vol.weight + w_obs
    denom = torch.clamp(w_new, min=1.0)
    tsdf = (vol.tsdf * vol.weight + tsdf_obs * w_obs) / denom
    color_new = (vol.color * vol.weight[None] + col_obs) / denom[None]
    return TSDFVolume(tsdf, w_new, color_new, vol.origin, vol.voxel_size,
                      vol.sdf_trunc)


def integrate_frames(vol: TSDFVolume, depths, colors, extrinsics,
                     intr: PinholeIntrinsics) -> TSDFVolume:
    """Fuse a batch: depths (N,H,W), colors (N,H,W,3), extrinsics (N,4,4),
    all on the volume's device."""
    for i in range(depths.shape[0]):
        vol = integrate_frame(vol, depths[i], colors[i], extrinsics[i], intr)
    return vol


def partial_integrate(depths, colors, extrinsics, intr: PinholeIntrinsics,
                      cfg: TSDFConfig):
    """Order-independent partial sums of a shard of frames, on the frames'
    device: (sum_tw (X,Y,Z), sum_w (X,Y,Z), sum_cw (3,X,Y,Z)). Shards
    combine by addition (an all-reduce over the data axis), then
    `merge_partials` folds them into a volume; equal to integrate_frames
    up to floating-point reassociation."""
    vol = make_volume(cfg, depths.device)
    sum_tw, sum_w, sum_cw = vol.tsdf, vol.weight, vol.color
    for i in range(depths.shape[0]):
        tsdf_obs, w_obs, col_obs = _observe_frame(
            vol, depths[i], colors[i], extrinsics[i], intr)
        sum_tw = sum_tw + tsdf_obs * w_obs
        sum_w = sum_w + w_obs
        sum_cw = sum_cw + col_obs
    return sum_tw, sum_w, sum_cw


def merge_partials(sum_tw, sum_w, sum_cw, cfg: TSDFConfig) -> TSDFVolume:
    """The volume of summed partials: weighted means over max(sum_w, 1)."""
    denom = torch.clamp(sum_w, min=1.0)
    return TSDFVolume(sum_tw / denom, sum_w, sum_cw / denom[None],
                      tuple(float(o) for o in cfg.origin),
                      float(cfg.voxel_size), float(cfg.sdf_trunc))


def _compact(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """Ascending flat indices of the set entries, at most `capacity` (the
    order of the JAX package's stable-argsort compaction)."""
    waited(mask)
    return torch.nonzero(mask.reshape(-1)).reshape(-1)[:capacity]


def extract_surface_points(vol: TSDFVolume, capacity: int = 1_000_000,
                           with_normals: bool = False):
    """TSDF zero-crossing surface points of a dense volume.

    Sign changes between +x/+y/+z neighbours (both observed), linearly
    interpolated. Returns (points (C,3), colors (C,3) in [0,1], mask (C,),
    [normals (C,3)]) for the C = min(count, capacity) crossings, in the
    JAX package's order (axis-major, then voxel index)."""
    X, Y, Z = vol.dims
    t = vol.tsdf
    w = vol.weight
    dev = t.device

    def axis_mask(axis: int):
        b = torch.roll(t, -1, dims=axis)
        wb = torch.roll(w, -1, dims=axis)
        m = (w > 0) & (wb > 0) & (t * b < 0)
        n = t.shape[axis]
        shape = [1, 1, 1]
        shape[axis] = n
        return m & (torch.arange(n, device=dev) < n - 1).reshape(shape)

    masks = torch.stack([axis_mask(0), axis_mask(1), axis_mask(2)])
    sel = _compact(masks, capacity)

    vol_sz = X * Y * Z
    axis = sel // vol_sz
    vox = sel % vol_sz
    ix = vox // (Y * Z)
    iy = (vox // Z) % Y
    iz = vox % Z

    strides = torch.tensor([Y * Z, Z, 1], device=dev)
    nbr = torch.clamp(vox + strides[axis], 0, vol_sz - 1)

    tf = t.reshape(-1)
    a = tf[vox]
    b = tf[nbr]
    denom = a - b
    frac = a / torch.where(torch.abs(denom) > 1e-12, denom, 1.0)
    frac = torch.clamp(frac, 0.0, 1.0)

    f32 = torch.float32
    base = torch.stack([
        vol.origin[0] + (ix.to(f32) + 0.5) * vol.voxel_size,
        vol.origin[1] + (iy.to(f32) + 0.5) * vol.voxel_size,
        vol.origin[2] + (iz.to(f32) + 0.5) * vol.voxel_size,
    ], dim=-1)
    onehot = torch.nn.functional.one_hot(axis, 3).to(f32)
    points = base + onehot * (frac * vol.voxel_size)[:, None]

    cf = vol.color.reshape(3, -1)
    ca = torch.stack([cf[c][vox] for c in range(3)], dim=-1)
    cb = torch.stack([cf[c][nbr] for c in range(3)], dim=-1)
    colors = (ca * (1.0 - frac[:, None]) + cb * frac[:, None]) * recip32(255.0)
    colors = torch.clamp(colors, 0.0, 1.0)
    mask = torch.ones(sel.shape[0], dtype=torch.bool, device=dev)

    if not with_normals:
        return points, colors, mask

    def grad_axis(stride: int, n: int, idx):
        up = torch.clamp(vox + torch.where(idx < n - 1, stride, 0),
                         0, vol_sz - 1)
        dn = torch.clamp(vox - torch.where(idx > 0, stride, 0), 0, vol_sz - 1)
        return tf[up] - tf[dn]

    g = torch.stack([grad_axis(Y * Z, X, ix), grad_axis(Z, Y, iy),
                     grad_axis(1, Z, iz)], dim=-1)
    norm = torch.linalg.norm(g, dim=-1, keepdim=True)
    normals = g / torch.where(norm > 1e-12, norm, 1.0)
    return points, colors, mask, normals
