"""The plain reference of the recon cells: per-object block-sparse TSDF
fusion, zero-crossing extraction, uniform resampling and the floor filter.

Plain PyTorch and NumPy, in float32 with TF32 off, importing nothing of the
program. The functions below are frozen copies of the port's plain
versions (kernels/tsdf.py, kernels/tsdf_block.py, the plain K1 of
kernels/tsdf_cuda.py, kernels/sampling.py and the auto-sized volume of
pipeline/reconstruct.py) with their imports repointed; `reconstruct`
recomputes an object from the benchmark's own capture arrays, so nothing
the program derived (volumes, work lists, packed colour) reaches it.

`dtype` stores the volume (tsdf, weight, colour) in another type: the
control runs it in bfloat16, the step below the float32 the configuration
states.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch



@dataclass(frozen=True)
class Intrinsics:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


@dataclass(frozen=True)
class TSDFParams:
    voxel_size: float
    sdf_trunc: float
    dims: Tuple[int, int, int]
    origin: Tuple[float, float, float]


@dataclass(frozen=True)
class ReconParams:
    z_filter_threshold: float
    surface_samples: int
    tsdf: TSDFParams


def params_from_config(cfg: dict) -> tuple:
    """(Intrinsics, ReconParams) from a configuration file's settings."""
    cam = cfg["camera"]
    t = cfg["tsdf"]
    intr = Intrinsics(cam["width"], cam["height"], cam["fx"], cam["fy"],
                      cam["cx"], cam["cy"])
    rp = ReconParams(cfg["z_filter_threshold"], cfg["surface_samples"],
                     TSDFParams(t["voxel_size"], t["sdf_trunc"],
                                tuple(t["dims"]), tuple(t["origin"])))
    return intr, rp


def recip32(x: float) -> float:
    """The f32 reciprocal of the f32-rounded constant x. Division by a
    constant is taken as multiplication by this value everywhere: XLA
    rewrites it so, PyTorch's CUDA division by a scalar does too, and the
    CUDA kernels do the same, so every backend rounds alike."""
    return float(np.float32(1.0) / np.float32(x))


def _round_to_pixel(x: torch.Tensor, size: int) -> torch.Tensor:
    """Half-to-even rounding to an int32 pixel index (jnp.round semantics).
    Values are clamped to [-1, size] before the cast: every value outside
    the image is equally invalid, and the cast of a huge float is then
    defined on every backend."""
    return torch.clamp(torch.round(x), -1.0, float(size)).to(torch.int32)


def _compact(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """Ascending flat indices of the set entries, at most `capacity` (the
    order of the JAX package's stable-argsort compaction)."""
    return torch.nonzero(mask.reshape(-1)).reshape(-1)[:capacity]


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


MIP_BIG = 1.0e30  # finite "empty tile" min sentinel (tsdf_block._MIP_BIG)


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


def classify_constants(meta, intr: Intrinsics):
    """Host-side constants of the classification, as the JAX graph forms
    them: r = 0.8661*8*vs folds in double on the host; the pixel-slack
    numerator max(fx, fy)*r is a product of two f32 values rounded to f32
    (jnp.maximum of two Python floats is an f32 array)."""
    _, _, voxel_size, _ = meta
    r = 0.8661 * BLOCK * voxel_size
    slack_num = np.float32(np.float32(max(intr.fx, intr.fy)) * np.float32(r))
    return r, float(slack_num)


def _active_blocks(meta, depth: torch.Tensor, extrinsic: torch.Tensor,
                   intr: Intrinsics):
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
                  intr: Intrinsics, sdf_trunc: float):
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


def pack_rgb(color: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) float [0,255] or uint8 -> (..., H, W) int32 packed
    0x00BBGGRR (channels truncated to integers, as the JAX uint32 cast)."""
    c = torch.clamp(color.to(torch.float32), 0, 255).to(torch.int32)
    return c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)


def compact_ids(active: torch.Tensor) -> torch.Tensor:
    """Ascending int64 indices of the set entries of a 1-D mask."""
    return torch.nonzero(active).reshape(-1)


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


def created_and_active(band, visible, created_in):
    """(created (N, NB), active (N, NB)) from the classification and the
    volume's created mask (NB,): created_f = created_in | OR_{f'<=f} band."""
    created = torch.cummax(band.to(torch.uint8), dim=0).values.bool()
    created = created | created_in[None]
    return created, created & visible


def fuse_blocks_torch(vol: BlockTSDFVolume, ids, ptr, frames, depths,
                      cpacked, extrinsics, intr: Intrinsics) -> None:
    """Plain version of K1: the block-sparse running mean, in place.

    Frames are applied in ascending order; at frame f, every listed block
    whose frame list holds f is sampled and updated (the update runs for
    every active pair, valid or not, exactly as the JAX scan does)."""
    counts = (ptr[1:] - ptr[:-1]).long()
    slot = torch.repeat_interleave(
        torch.arange(ids.shape[0], device=ids.device), counts)
    frames = frames.long()
    for f in torch.unique(frames).tolist():
        bid = ids[slot[frames == f]].long()
        wx, wy, wz = _voxel_world_coords(vol.meta, bid)
        tsdf_obs, w_obs, col_obs = _sample_frame(
            wx, wy, wz, depths[f], cpacked[f], extrinsics[f], intr,
            vol.sdf_trunc)
        t_rows = vol.tsdf[bid]
        w_rows = vol.weight[bid]
        c_rows = vol.color[bid]
        w_new = w_rows + w_obs
        denom = torch.clamp(w_new, min=1.0)
        dt = vol.tsdf.dtype           # the volume's storage type
        vol.tsdf[bid] = ((t_rows * w_rows + tsdf_obs * w_obs) / denom).to(dt)
        vol.weight[bid] = w_new.to(dt)
        vol.color[bid] = ((c_rows * w_rows.repeat(1, 3) + col_obs)
                          / denom.repeat(1, 3)).to(dt)


def resample_points(points: torch.Tensor, mask: torch.Tensor,
                    num_samples: int, colors: torch.Tensor | None = None,
                    normals: torch.Tensor | None = None,
                    generator: torch.Generator | None = None,
                    draws: torch.Tensor | None = None):
    """Uniformly sample ``num_samples`` valid rows (with replacement).

    Valid rows must be compacted to the front (row i valid iff i < count),
    as the extraction functions return them. The uniform [0, 1) draws come
    from `draws` (shape (num_samples,)) when given — e.g. the JAX package's
    ``jax.random.uniform(key, (num_samples,))``, which makes the chosen
    indices identical to its — else from `generator` on the points' device.
    Returns (points, colors or None, normals or None)."""
    count = torch.clamp(mask.to(torch.int64).sum(), min=1)
    if draws is None:
        u = torch.rand(num_samples, generator=generator,
                       device=points.device)
    else:
        if draws.shape != (num_samples,):
            raise ValueError(f"draws shape {tuple(draws.shape)} != "
                             f"({num_samples},)")
        u = draws.to(device=points.device, dtype=torch.float32)
    # f32 product then truncation, as (u * count).astype(int32) in JAX
    idx = torch.minimum((u * count.to(torch.float32)).to(torch.int64),
                        count - 1)
    return (points[idx],
            None if colors is None else colors[idx],
            None if normals is None else normals[idx])


def _observed_world_points(batch, intr: Intrinsics,
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


def auto_volume_origin(batch, intr: Intrinsics,
                       cfg: ReconParams) -> tuple:
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


def auto_volume_config(batch, intr: Intrinsics,
                       cfg: ReconParams,
                       near_radius: float = 4.0,
                       max_dim: int = 512) -> ReconParams:
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


def make_block_volume(tp: TSDFParams, device, dtype=torch.float32):
    X, Y, Z = tp.dims
    gb = (X // BLOCK, Y // BLOCK, Z // BLOCK)
    nb = gb[0] * gb[1] * gb[2]
    return BlockTSDFVolume(
        tsdf=torch.zeros((nb + 1, BLOCK_VOXELS), dtype=dtype, device=device),
        weight=torch.zeros((nb + 1, BLOCK_VOXELS), dtype=dtype,
                           device=device),
        color=torch.zeros((nb + 1, 3 * BLOCK_VOXELS), dtype=dtype,
                          device=device),
        created=torch.zeros((nb + 1,), dtype=torch.bool, device=device),
        origin=tuple(float(o) for o in tp.origin),
        voxel_size=float(tp.voxel_size), sdf_trunc=float(tp.sdf_trunc),
        grid_blocks=gb)


def fuse(vol: BlockTSDFVolume, depths, colors, extrinsics,
         intr: Intrinsics) -> BlockTSDFVolume:
    """Every frame in order into the created, visible blocks (creation is
    the running OR of each frame's truncation band)."""
    nb = vol.num_blocks
    band, visible = _active_blocks(vol.meta, depths, extrinsics, intr)
    created, active = created_and_active(band, visible, vol.created[:nb])
    cpacked = pack_rgb(colors)
    n_f = len(depths)
    nz = torch.nonzero(active.t())               # block-major (block, frame)
    ids, counts = torch.unique(nz[:, 0], return_counts=True)
    ptr = torch.zeros(len(ids) + 1, dtype=torch.int64, device=depths.device)
    ptr[1:] = torch.cumsum(counts, 0)
    fuse_blocks_torch(vol, ids, ptr, nz[:, 1], depths, cpacked, extrinsics,
                      intr)
    vol.created[:nb] = created[-1] if n_f else vol.created[:nb]
    return vol


def reconstruct(cap, intr: Intrinsics, params: ReconParams, draws, device,
                output: str = "cloud", dtype=torch.float32) -> dict:
    """One object from its capture arrays: auto-sized volume -> fusion ->
    cloud (extraction, resampling with `draws`, floor filter) or welded
    mesh. Host arrays out, keyed as the comparison reads them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = auto_volume_config(cap, intr, params)
    f32 = torch.float32
    depths = torch.as_tensor(cap.depths, dtype=f32, device=device)
    colors = torch.as_tensor(cap.colors, dtype=f32, device=device)
    exts = torch.as_tensor(cap.extrinsics, dtype=f32, device=device)
    vol = fuse(make_block_volume(params.tsdf, device, dtype), depths, colors,
               exts, intr)
    del depths, colors
    if output == "mesh":
        from benchmark.reference import mesh
        v, f, c, n = mesh.extract_mesh(vol)
        return {"vertices": v, "faces": f, "colors": c, "normals": n,
                "dims": params.tsdf.dims}
    pts, cols, mask, nrm = extract_surface_points_sparse(
        vol, capacity=2_000_000, with_normals=True)
    raw = int(mask.sum())
    s_pts, s_cols, s_nrm = resample_points(
        pts, mask, params.surface_samples, colors=cols, normals=nrm,
        draws=draws)
    p = s_pts.float().cpu().numpy()
    c = s_cols.float().cpu().numpy()
    n = s_nrm.float().cpu().numpy()
    keep = p[:, 2] >= params.z_filter_threshold
    return {"points": p[keep], "colors": c[keep], "normals": n[keep],
            "raw_surface_count": raw, "dims": params.tsdf.dims}

