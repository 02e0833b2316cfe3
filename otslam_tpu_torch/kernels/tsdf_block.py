"""Block-sparse TSDF fusion (counterpart of otslam_tpu/kernels/tsdf_block.py).

* The volume is a fixed grid of 8^3 voxel blocks stored block-major:
  ``tsdf/weight: (NB+1, 512)``, row b holds block b's voxels and row NB is a
  dead row that stays zero. Color is ``(NB+1, 1536)``, channel-major per row
  ([R*512 | G*512 | B*512], values in [0, 255]).
* A persistent ``created`` mask replaces Open3D's hash map: a block is
  created when it first falls within ``sdf_trunc`` (+ its bounding sphere)
  of an observed surface, and every created block inside the frustum is
  integrated each frame (free-space carving inside created blocks).
* Block activity comes from a dilated min/max depth mip pyramid
  (`_depth_mips`, `_active_blocks`).

Everything in this module is plain PyTorch. The public fusion entry point,
`integrate_frames_sparse`, runs the batched schedule of
kernels/tsdf_cuda.py, whose depth-mip, classify (K2), colour-pack and
fusion (K1) wrappers launch the hand-written CUDA kernels for CUDA tensors
and run the plain versions here for CPU tensors.

The op order of every function follows the JAX one, so both packages round
alike; tests state the tolerance of each comparison.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from otslam_tpu_torch.config import TSDFConfig
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.device import resolve_device
from otslam_tpu_torch.kernels.tsdf import (
    TSDFVolume, _compact, _round_to_pixel, recip32)
from otslam_tpu_torch.utils.profiling import waited

BLOCK = 8               # voxels per block edge
BLOCK_VOXELS = BLOCK ** 3
MIP_TILE = 16           # level-0 mip tile edge in pixels


@dataclass
class BlockTSDFVolume:
    """Block-major sparse TSDF volume (see the module docstring).

    tsdf/weight (NB+1, 512) f32, color (NB+1, 1536) f32, created (NB+1,)
    bool, all on one device."""

    tsdf: torch.Tensor
    weight: torch.Tensor
    color: torch.Tensor
    created: torch.Tensor
    origin: Tuple[float, float, float]
    voxel_size: float
    sdf_trunc: float
    grid_blocks: Tuple[int, int, int]

    @property
    def num_blocks(self) -> int:
        bx, by, bz = self.grid_blocks
        return bx * by * bz

    @property
    def device(self) -> torch.device:
        return self.tsdf.device

    @property
    def meta(self):
        """(grid_blocks, origin, voxel_size, sdf_trunc): the static geometry
        the classify and fusion passes need."""
        return (self.grid_blocks, self.origin, self.voxel_size,
                self.sdf_trunc)

    @classmethod
    def from_numpy(cls, tsdf, weight, color, created, origin, voxel_size,
                   sdf_trunc, grid_blocks, device="cuda") -> "BlockTSDFVolume":
        """Volume from numpy fields (e.g. np.asarray of a JAX volume's)."""
        dev = resolve_device(device)

        def t(a, dtype):
            return torch.tensor(np.asarray(a), dtype=dtype, device=dev)
        return cls(t(tsdf, torch.float32), t(weight, torch.float32),
                   t(color, torch.float32), t(created, torch.bool),
                   tuple(float(o) for o in origin), float(voxel_size),
                   float(sdf_trunc), tuple(int(g) for g in grid_blocks))

    def to_numpy(self) -> dict:
        return {"tsdf": self.tsdf.cpu().numpy(),
                "weight": self.weight.cpu().numpy(),
                "color": self.color.cpu().numpy(),
                "created": self.created.cpu().numpy(),
                "origin": self.origin, "voxel_size": self.voxel_size,
                "sdf_trunc": self.sdf_trunc, "grid_blocks": self.grid_blocks}


def make_block_volume(cfg: TSDFConfig, device="cuda") -> BlockTSDFVolume:
    X, Y, Z = cfg.dims
    if any(d % BLOCK for d in cfg.dims):
        raise ValueError(f"dims {cfg.dims} must be multiples of {BLOCK}")
    dev = resolve_device(device)
    gb = (X // BLOCK, Y // BLOCK, Z // BLOCK)
    nb = gb[0] * gb[1] * gb[2]
    f32 = torch.float32
    return BlockTSDFVolume(
        tsdf=torch.zeros((nb + 1, BLOCK_VOXELS), dtype=f32, device=dev),
        weight=torch.zeros((nb + 1, BLOCK_VOXELS), dtype=f32, device=dev),
        color=torch.zeros((nb + 1, 3 * BLOCK_VOXELS), dtype=f32, device=dev),
        created=torch.zeros((nb + 1,), dtype=torch.bool, device=dev),
        origin=tuple(float(o) for o in cfg.origin),
        voxel_size=float(cfg.voxel_size),
        sdf_trunc=float(cfg.sdf_trunc),
        grid_blocks=gb,
    )


def _block_centers(meta, device):
    """(NB,) world-space block center coordinates, one tensor per axis."""
    (bx, by, bz), origin, voxel_size, _ = meta
    ids = torch.arange(bx * by * bz, device=device)
    ix = ids // (by * bz)
    iy = (ids // bz) % by
    iz = ids % bz
    half = 0.5 * BLOCK * voxel_size
    f32 = torch.float32
    cx = origin[0] + ix.to(f32) * BLOCK * voxel_size + half
    cy = origin[1] + iy.to(f32) * BLOCK * voxel_size + half
    cz = origin[2] + iz.to(f32) * BLOCK * voxel_size + half
    return cx, cy, cz


MIP_BIG = 1.0e30  # finite "empty tile" min sentinel (tsdf_block._MIP_BIG)


def _bf16_conservative(v: torch.Tensor, is_max: bool) -> torch.Tensor:
    """Round mip bounds to bf16-representable f32 values, padded so the
    rounding only widens the bound (mins move down, maxes up). Part of the
    classification's exact semantics; torch's f32->bf16 cast rounds to
    nearest even, like JAX's."""
    pad = torch.abs(v) * 2.0 ** -8
    v2 = torch.where(torch.isfinite(v), v + pad if is_max else v - pad, v)
    return v2.to(torch.bfloat16).to(torch.float32)


def _pool3(m: torch.Tensor, reducer, pad_val: float) -> torch.Tensor:
    """3x3 min/max dilation over the last two axes with constant padding."""
    h, w = m.shape[-2:]
    p = torch.nn.functional.pad(m, (1, 1, 1, 1), value=pad_val)
    stack = torch.stack([p[..., i:i + h, j:j + w]
                         for i in range(3) for j in range(3)])
    return reducer(stack, dim=0).values


def _coarsen(mn, mx, f: int):
    """f-x coarser mip level with 3x3 dilation, broadcast back to level 0."""
    h, w = mn.shape[-2:]
    ph, pw = (-h) % f, (-w) % f
    mn_p = torch.nn.functional.pad(mn, (0, pw, 0, ph), value=MIP_BIG)
    mx_p = torch.nn.functional.pad(mx, (0, pw, 0, ph), value=0.0)
    lh, lw = (h + ph) // f, (w + pw) // f
    lead = mn.shape[:-2]
    mn_c = mn_p.reshape(*lead, lh, f, lw, f).amin(dim=(-3, -1))
    mx_c = mx_p.reshape(*lead, lh, f, lw, f).amax(dim=(-3, -1))
    mn_c = _pool3(mn_c, torch.min, MIP_BIG)
    mx_c = _pool3(mx_c, torch.max, 0.0)
    mn_f = mn_c.repeat_interleave(f, -2).repeat_interleave(f, -1)[..., :h, :w]
    mx_f = mx_c.repeat_interleave(f, -2).repeat_interleave(f, -1)[..., :h, :w]
    return mn_f, mx_f


def _depth_mips(depth: torch.Tensor, tile: int = MIP_TILE):
    """Dilated min/max depth mip of (..., H, W) depth, packed per tile.

    Returns ((..., th*tw, 8) table, th, tw): per level-0 tile the columns
    are [dmin0, dmax0, dmin1, dmax1, dmin2, dmax2, 0, 0], levels 1 and 2
    being 2x and 4x coarser tiles. Invalid pixels are excluded (min via the
    finite MIP_BIG sentinel, max via 0); a 3x3 dilation at every level makes
    border-straddling footprints conservative; every bound is bf16-safe."""
    H, W = depth.shape[-2:]
    lead = depth.shape[:-2]
    th, tw = -(-H // tile), -(-W // tile)
    dpad = torch.nn.functional.pad(depth, (0, tw * tile - W, 0, th * tile - H))
    d = dpad.reshape(*lead, th, tile, tw, tile)
    valid = d > 0
    dmin0 = torch.where(valid, d, MIP_BIG).amin(dim=(-3, -1))
    dmax0 = torch.where(valid, d, 0.0).amax(dim=(-3, -1))
    dmin0 = _pool3(dmin0, torch.min, MIP_BIG)
    dmax0 = _pool3(dmax0, torch.max, 0.0)
    dmin1, dmax1 = _coarsen(dmin0, dmax0, 2)
    dmin2, dmax2 = _coarsen(dmin0, dmax0, 4)
    levels = [_bf16_conservative(m, i % 2 == 1) for i, m in
              enumerate([dmin0, dmax0, dmin1, dmax1, dmin2, dmax2])]
    table = torch.stack(levels, dim=-1).reshape(*lead, th * tw, 6)
    table = torch.nn.functional.pad(table, (0, 2))
    return table, th, tw


def classify_constants(meta, intr: PinholeIntrinsics):
    """Host-side constants of the classification, as the JAX graph forms
    them: r = 0.8661*8*vs folds in double on the host; the pixel-slack
    numerator max(fx, fy)*r is a product of two f32 values rounded to f32
    (jnp.maximum of two Python floats is an f32 array)."""
    _, _, voxel_size, _ = meta
    r = 0.8661 * BLOCK * voxel_size
    slack_num = np.float32(np.float32(max(intr.fx, intr.fy)) * np.float32(r))
    return r, float(slack_num)


def _active_blocks(meta, depth: torch.Tensor, extrinsic: torch.Tensor,
                   intr: PinholeIntrinsics):
    """Per-frame block classification (plain version of kernel K2).

    depth (..., H, W), extrinsic (..., 4, 4) with the same leading shape.
    Returns (band, visible) bool (..., NB): band = block within the
    truncation band of the frame's surface (drives creation); visible =
    block in the frustum in front of the far surface (drives integration of
    created blocks). Bit-identical to tsdf_block._active_blocks."""
    _, _, _, sdf_trunc = meta
    cx, cy, cz = _block_centers(meta, depth.device)
    E = extrinsic.to(torch.float32)[..., None]      # (..., 4, 4, 1)
    px = E[..., 0, 0, :] * cx + E[..., 0, 1, :] * cy + E[..., 0, 2, :] * cz \
        + E[..., 0, 3, :]
    py = E[..., 1, 0, :] * cx + E[..., 1, 1, :] * cy + E[..., 1, 2, :] * cz \
        + E[..., 1, 3, :]
    pz = E[..., 2, 0, :] * cx + E[..., 2, 1, :] * cy + E[..., 2, 2, :] * cz \
        + E[..., 2, 3, :]

    r, slack_num = classify_constants(meta, intr)
    in_front = pz > r * 0.5
    zsafe = torch.where(pz > 1e-6, pz, 1e-6)
    u = intr.fx * px / zsafe + intr.cx
    v = intr.fy * py / zsafe + intr.cy
    # a tensor numerator: `float / tensor` would take the reciprocal first
    slack = torch.full_like(zsafe, slack_num) / zsafe + 1.0
    in_frustum = (in_front & (u + slack >= 0) & (u - slack < intr.width)
                  & (v + slack >= 0) & (v - slack < intr.height))

    tile = MIP_TILE
    table, th, tw = _depth_mips(depth, tile)
    # truncate toward zero, then clip; the pre-clamp to [-1, t] keeps the
    # cast defined for far-off projections and changes no clipped result
    tu0 = torch.clamp(torch.clamp(u / tile, -1.0, float(tw)).to(torch.int32),
                      0, tw - 1)
    tv0 = torch.clamp(torch.clamp(v / tile, -1.0, float(th)).to(torch.int32),
                      0, th - 1)
    flat = (tv0 * tw + tu0).long()
    rows = torch.gather(table, -2,
                        flat[..., None].expand(*flat.shape, 8))
    l1 = slack > tile
    l2 = slack > 2 * tile
    bmin = torch.where(l2, rows[..., 4],
                       torch.where(l1, rows[..., 2], rows[..., 0]))
    bmax = torch.where(l2, rows[..., 5],
                       torch.where(l1, rows[..., 3], rows[..., 1]))
    too_big = slack > 4 * tile
    gmin = table[..., 4].amin(dim=-1, keepdim=True)
    gmax = table[..., 5].amax(dim=-1, keepdim=True)
    bmin = torch.where(too_big, gmin, bmin)
    bmax = torch.where(too_big, gmax, bmax)

    has_depth = bmax > 0
    band = (in_frustum & has_depth
            & (pz + r >= bmin - sdf_trunc)
            & (pz - r <= bmax + sdf_trunc))
    visible = in_frustum & has_depth & (pz - r <= bmax + sdf_trunc)
    return band, visible


def _voxel_world_coords(meta, ids: torch.Tensor):
    """World coords of the 512 voxel centers of each block id: (A, 512) x 3."""
    (bx, by, bz), origin, vs, _ = meta
    ix = ids // (by * bz)
    iy = (ids // bz) % by
    iz = ids % bz
    l = torch.arange(BLOCK_VOXELS, device=ids.device)
    lx = (l // (BLOCK * BLOCK))[None, :]
    ly = ((l // BLOCK) % BLOCK)[None, :]
    lz = (l % BLOCK)[None, :]
    f32 = torch.float32
    wx = origin[0] + ((ix[:, None] * BLOCK + lx).to(f32) + 0.5) * vs
    wy = origin[1] + ((iy[:, None] * BLOCK + ly).to(f32) + 0.5) * vs
    wz = origin[2] + ((iz[:, None] * BLOCK + lz).to(f32) + 0.5) * vs
    return wx, wy, wz


def _sample_frame(wx, wy, wz, depth, color_packed, extrinsic,
                  intr: PinholeIntrinsics, sdf_trunc: float):
    """Voxel-projection sampling of one frame for (A, 512) voxel coords.

    color_packed: (H, W) int32 with RGB in the low 24 bits (`pack_rgb`).
    Returns (tsdf_obs, w_obs, col_obs (A, 1536) channel-major)."""
    E = extrinsic.to(torch.float32)
    px = E[0, 0] * wx + E[0, 1] * wy + E[0, 2] * wz + E[0, 3]
    py = E[1, 0] * wx + E[1, 1] * wy + E[1, 2] * wz + E[1, 3]
    pz = E[2, 0] * wx + E[2, 1] * wy + E[2, 2] * wz + E[2, 3]
    in_front = pz > 0
    zsafe = torch.where(in_front, pz, 1.0)
    u = _round_to_pixel(intr.fx * px / zsafe + intr.cx, intr.width)
    v = _round_to_pixel(intr.fy * py / zsafe + intr.cy, intr.height)
    inb = in_front & (u >= 0) & (u < intr.width) & (v >= 0) & (v < intr.height)
    flat = (torch.clamp(v, 0, intr.height - 1).long() * intr.width
            + torch.clamp(u, 0, intr.width - 1).long())
    d = depth.reshape(-1)[flat]
    packed = color_packed.reshape(-1)[flat]

    sdf = d - pz
    valid = inb & (d > 0) & (sdf >= -sdf_trunc)
    tsdf_obs = torch.where(valid,
                           torch.clamp(sdf * recip32(sdf_trunc), max=1.0), 0.0)
    w_obs = valid.to(torch.float32)
    r = (packed & 0xFF).to(torch.float32)
    g = ((packed >> 8) & 0xFF).to(torch.float32)
    b = ((packed >> 16) & 0xFF).to(torch.float32)
    col_obs = torch.cat([r, g, b], dim=-1) * w_obs.repeat(1, 3)
    return tsdf_obs, w_obs, col_obs


def compact_ids(active: torch.Tensor) -> torch.Tensor:
    """Ascending int64 indices of the set entries of a 1-D mask: the exact
    active list (the JAX package pads to a static capacity instead)."""
    waited(active)
    return torch.nonzero(active).reshape(-1)


def pack_rgb(color: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) float [0,255] or uint8 -> (..., H, W) int32 packed
    0x00BBGGRR (channels truncated to integers, as the JAX uint32 cast)."""
    c = torch.clamp(color.to(torch.float32), 0, 255).to(torch.int32)
    return c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)


def integrate_frames_sparse(vol: BlockTSDFVolume, depths, colors, extrinsics,
                            intr: PinholeIntrinsics,
                            max_active: int | None = None) -> BlockTSDFVolume:
    """Fuse a batch of frames through the block-sparse path.

    depths (N,H,W) f32 meters (0 invalid), colors (N,H,W,3) [0,255],
    extrinsics (N,4,4) world->camera, all on the volume's device. The
    volume's tensors are updated in place (the JAX function donates them)
    and the volume is returned. Same semantics as the JAX function:
    max_active integrates only each frame's max_active lowest active block
    ids; None (an exact active list) equals any capacity that never
    binds."""
    # tsdf_cuda builds on this module's plain functions, so it is imported
    # here rather than at the top
    from otslam_tpu_torch.kernels.tsdf_cuda import integrate_frames_cuda
    return integrate_frames_cuda(vol, depths, colors, extrinsics, intr,
                                 max_active)


def block_to_dense(vol: BlockTSDFVolume) -> TSDFVolume:
    """Expand the block volume to a dense TSDFVolume."""
    bx, by, bz = vol.grid_blocks
    X, Y, Z = bx * BLOCK, by * BLOCK, bz * BLOCK

    def expand(rows):  # (NB+1, 512) -> (X, Y, Z)
        g = rows[:-1].reshape(bx, by, bz, BLOCK, BLOCK, BLOCK)
        return g.permute(0, 3, 1, 4, 2, 5).reshape(X, Y, Z)

    color = torch.stack([
        expand(vol.color[:, c * BLOCK_VOXELS:(c + 1) * BLOCK_VOXELS])
        for c in range(3)])
    return TSDFVolume(expand(vol.tsdf), expand(vol.weight), color,
                      vol.origin, vol.voxel_size, vol.sdf_trunc)


def dense_to_block(dense: TSDFVolume, cfg: TSDFConfig) -> BlockTSDFVolume:
    """Pack a dense volume into block-major form (created = any weight > 0)."""
    vol = make_block_volume(cfg, dense.tsdf.device)
    bx, by, bz = vol.grid_blocks

    def collapse(g):  # (X, Y, Z) -> (NB, 512)
        r = g.reshape(bx, BLOCK, by, BLOCK, bz, BLOCK)
        return r.permute(0, 2, 4, 1, 3, 5).reshape(bx * by * bz, BLOCK_VOXELS)

    vol.tsdf[:-1] = collapse(dense.tsdf)
    vol.weight[:-1] = collapse(dense.weight)
    vol.color[:-1] = torch.cat([collapse(dense.color[c]) for c in range(3)],
                               dim=-1)
    vol.created[:-1] = torch.any(collapse(dense.weight) > 0, dim=1)
    return vol


# ---------------------------------------------------------------------------
# sparse surface extraction (created blocks only — no densification)
# ---------------------------------------------------------------------------

def _neighbor_block_ids(vol: BlockTSDFVolume, ids: torch.Tensor):
    """Per axis, the +1-neighbor block id of each id (dead row NB at the
    grid boundary)."""
    bx, by, bz = vol.grid_blocks
    nb = bx * by * bz
    ix = ids // (by * bz)
    iy = (ids // bz) % by
    iz = ids % bz
    nx = torch.where(ix < bx - 1, ids + by * bz, nb)
    ny = torch.where(iy < by - 1, ids + bz, nb)
    nz = torch.where(iz < bz - 1, ids + 1, nb)
    return nx, ny, nz


def _shifted3(arr: torch.Tensor, self_rows: torch.Tensor, nbr) -> torch.Tensor:
    """(3, M, 512): the field at voxel +1 along x, y, z of every voxel of the
    M blocks, taken from the block itself or from its +axis neighbor's
    first plane."""
    s = self_rows.reshape(-1, BLOCK, BLOCK, BLOCK)
    out = []
    for axis, nid in enumerate(nbr):
        n = arr[nid].reshape(-1, BLOCK, BLOCK, BLOCK)
        d = axis + 1
        out.append(torch.cat([s.narrow(d, 1, BLOCK - 1), n.narrow(d, 0, 1)],
                             dim=d).reshape(-1, BLOCK_VOXELS))
    return torch.stack(out)


def extract_surface_points_sparse(vol: BlockTSDFVolume,
                                  capacity: int = 1_000_000,
                                  with_normals: bool = False):
    """TSDF zero-crossing extraction directly from the block volume.

    Touches only created blocks (plus their +axis neighbor rows); semantics
    and output order match the JAX function with `max_blocks` at least the
    created count. Returns (points (C,3), colors (C,3) [0,1], mask (C,),
    [normals]) for the C = min(count, capacity) crossings."""
    nb = vol.num_blocks
    by, bz = vol.grid_blocks[1], vol.grid_blocks[2]
    V = BLOCK_VOXELS
    ids = compact_ids(vol.created[:nb])                     # (M,)
    M = ids.shape[0]
    nbr = _neighbor_block_ids(vol, ids)

    t_s = vol.tsdf[ids]                                      # (M, 512)
    w_s = vol.weight[ids]
    t_b = _shifted3(vol.tsdf, t_s, nbr)                      # (3, M, 512)
    w_b = _shifted3(vol.weight, w_s, nbr)

    cross = (w_s[None] > 0) & (w_b > 0) & (t_s[None] * t_b < 0)
    sel = _compact(cross, capacity)

    axis = sel // (M * V)
    ci = (sel // V) % M
    l = sel % V
    lx = l // (BLOCK * BLOCK)
    ly = (l // BLOCK) % BLOCK
    lz = l % BLOCK

    bid = ids[ci]
    ix = bid // (by * bz)
    iy = (bid // bz) % by
    iz = bid % bz
    f32 = torch.float32
    base = torch.stack([
        vol.origin[0] + ((ix * BLOCK + lx).to(f32) + 0.5) * vol.voxel_size,
        vol.origin[1] + ((iy * BLOCK + ly).to(f32) + 0.5) * vol.voxel_size,
        vol.origin[2] + ((iz * BLOCK + lz).to(f32) + 0.5) * vol.voxel_size,
    ], dim=-1)

    flat_sv = ci * V + l
    a = t_s.reshape(-1)[flat_sv]
    b = t_b.reshape(-1)[sel]
    denom = a - b
    frac = torch.clamp(a / torch.where(torch.abs(denom) > 1e-12, denom, 1.0),
                       0.0, 1.0)
    onehot = torch.nn.functional.one_hot(axis, 3).to(f32)
    points = base + onehot * (frac * vol.voxel_size)[:, None]

    cols_a, cols_b = [], []
    for c in range(3):
        ch = vol.color[:, c * V:(c + 1) * V]
        c_s = ch[ids]
        cols_a.append(c_s.reshape(-1)[flat_sv])
        cols_b.append(_shifted3(ch, c_s, nbr).reshape(-1)[sel])
    ca = torch.stack(cols_a, dim=-1)
    cb = torch.stack(cols_b, dim=-1)
    colors = torch.clamp(
        (ca * (1.0 - frac[:, None]) + cb * frac[:, None]) * recip32(255.0),
        0.0, 1.0)
    mask = torch.ones(sel.shape[0], dtype=torch.bool, device=sel.device)

    if not with_normals:
        return points, colors, mask

    # forward-difference gradient at the base voxel from the shifted fields
    grad = t_b - t_s[None]                                   # (3, M, 512)
    g = torch.stack([grad[k].reshape(-1)[flat_sv] for k in range(3)], dim=-1)
    norm = torch.linalg.norm(g, dim=-1, keepdim=True)
    normals = g / torch.where(norm > 1e-12, norm, 1.0)
    return points, colors, mask, normals
