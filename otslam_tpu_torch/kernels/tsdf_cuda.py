"""Batched block-sparse fusion with the hand-written CUDA kernels K1 and K2.

Counterpart of otslam_tpu/kernels/tsdf_pallas.py. The schedule:

1. the dilated min/max depth mips of every frame and their global bounds
   (`depth_mips`, csrc/depth_mips.cu);
2. classify every (frame, block) pair (`classify_blocks`, kernel K2,
   csrc/tsdf_classify.cu) into band (drives creation) and visible (drives
   integration);
3. the creation recurrence ``created_f = created_in | OR_{f' <= f} band_f'``
   as a cumulative max over the frame axis (the JAX package's tril matmul,
   `_cumulative_or`); ``active = created & visible``;
4. a CSR work list from the (N, NB) active mask, with one host sync:
   ids (blocks active in any frame, ascending), ptr (A+1,), frames (nnz,)
   ascending per block;
5. the colour pack (`pack_rgb`, csrc/pack_rgb.cu) into K1's int32 plane;
6. fuse (`fuse_blocks`, kernel K1, csrc/tsdf_fuse.cu): per listed block,
   the running weighted mean over its frames in order, written once;
   `fuse_launch` gives its launch shape.

Each kernel wrapper takes its plain PyTorch version for CPU tensors only;
for CUDA tensors it launches the kernel or raises; `_build.check` counts each
launch. `integrate_frames_cuda` opens the spans ``fuse.schedule`` (steps
1-4), ``fuse.pack`` and ``fuse.k1`` (step 6 and the volume's created mask;
utils/profiling.py).

Not ported, because each exists only for Mosaic, VMEM, SMEM or the MXU: the
bf16 hi/lo depth split, lane-shifted planes and the half-res colour
pyramid; auto_patch_rows / auto_depth_config / auto_depth_win /
auto_color_rows; the window starts and the slab-coverage test with its
near-field fallback; smem_max_active and VMEM sizing; FPC frame chunking;
auto_max_active (the work list is exact). An explicit `max_active` keeps
the JAX package's capacity semantics: each frame integrates only its
`max_active` lowest active block ids.
"""

from __future__ import annotations

import numpy as np
import torch

from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.kernels import _build
from otslam_tpu_torch.kernels.tsdf import recip32
from otslam_tpu_torch.kernels.tsdf_block import (
    BLOCK, BLOCK_VOXELS, MIP_TILE, BlockTSDFVolume, _active_blocks,
    _depth_mips, _sample_frame, _voxel_world_coords, classify_constants)
from otslam_tpu_torch.kernels.tsdf_block import pack_rgb as pack_rgb_torch
from otslam_tpu_torch.utils.profiling import count, span, waited


def _f32(x: float) -> float:
    """x rounded to f32, as the JAX graph embeds a Python constant."""
    return float(np.float32(x))


def _ext12(extrinsics: torch.Tensor) -> torch.Tensor:
    """(N, 12) f32 rows of E[:3, :4]."""
    return extrinsics.to(torch.float32)[:, :3, :].reshape(-1, 12).contiguous()


# ---------------------------------------------------------------------------
# K2's pre-passes: the depth mips and the colour pack
# ---------------------------------------------------------------------------

MAX_SHARED_BYTES = 232448    # shared memory a CUDA block may opt in to
MAX_GRID_Y = 65535           # a CUDA grid's y dimension


def mips_shared_bytes(th: int, tw: int) -> int:
    """Shared memory of the mip pass's finishing kernel for a th x tw tile
    grid (csrc/depth_mips.cu): the dilated level 0 and levels 1 and 2
    before and after their dilation, 8 bytes a cell."""
    c1 = -(-th // 2) * -(-tw // 2)
    c2 = -(-th // 4) * -(-tw // 4)
    return (th * tw + 2 * c1 + 2 * c2) * 8


def depth_mips_torch(depths: torch.Tensor):
    """Plain version of the mip pass: (table (N, th*tw, 8), gbounds (N, 2),
    th, tw), the table of `_depth_mips` and each frame's (min of column 4,
    max of column 5), the bounds of a footprint too big for level 2."""
    table, th, tw = _depth_mips(depths)
    gbounds = torch.stack([table[..., 4].amin(dim=-1),
                           table[..., 5].amax(dim=-1)], dim=-1)
    return table, gbounds, th, tw


def depth_mips(depths: torch.Tensor):
    """(table, gbounds, th, tw) of (N, H, W) depth: the mip kernels on
    CUDA tensors, the plain version on CPU tensors. Bit-identical either
    way."""
    if depths.device.type == "cpu":
        return depth_mips_torch(depths)
    depths = depths.to(torch.float32).contiguous()
    n, H, W = depths.shape
    th, tw = -(-H // MIP_TILE), -(-W // MIP_TILE)
    table = torch.empty((n, th * tw, 8), dtype=torch.float32,
                        device=depths.device)
    gbounds = torch.empty((n, 2), dtype=torch.float32, device=depths.device)
    if n == 0:
        return table, gbounds, th, tw
    if n > MAX_GRID_Y:
        raise ValueError(f"at most {MAX_GRID_Y} frames a call, got {n}")
    if mips_shared_bytes(th, tw) > MAX_SHARED_BYTES:
        raise ValueError(f"frames {H}x{W} give a {th}x{tw} tile grid, too "
                         f"big for the mip pass's shared memory")
    raw = torch.empty((n, th * tw, 2), dtype=torch.float32,
                      device=depths.device)
    _build.check_operands(depths, raw, table, gbounds)
    lib = _build.load()
    code = lib.otslam_depth_mips(
        depths.data_ptr(), raw.data_ptr(), table.data_ptr(),
        gbounds.data_ptr(), n, H, W, th, tw, _build.stream_ptr(depths.device))
    _build.check(code, "otslam_depth_mips")
    return table, gbounds, th, tw


def pack_rgb(colors: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) colour in [0, 255] -> (..., H, W) int32 0x00BBGGRR:
    the pack kernel on CUDA tensors, the plain `tsdf_block.pack_rgb` on
    CPU tensors. Bit-identical for every colour that is not NaN; the
    kernel packs a NaN channel as 0."""
    if colors.device.type == "cpu":
        return pack_rgb_torch(colors)
    if colors.shape[-1] != 3:
        raise ValueError(f"colours must end in 3 channels, got "
                         f"{tuple(colors.shape)}")
    colors = colors.to(torch.float32).contiguous()
    out = torch.empty(colors.shape[:-1], dtype=torch.int32,
                      device=colors.device)
    if out.numel() == 0:
        return out
    _build.check_operands(colors, out)
    lib = _build.load()
    code = lib.otslam_pack_rgb(colors.data_ptr(), out.data_ptr(), out.numel(),
                               _build.stream_ptr(colors.device))
    _build.check(code, "otslam_pack_rgb")
    return out


# ---------------------------------------------------------------------------
# K2: block classification
# ---------------------------------------------------------------------------

def classify_blocks_torch(meta, depths, extrinsics, intr: PinholeIntrinsics):
    """Plain version of K2: (band, visible) bool (N, NB)."""
    return _active_blocks(meta, depths, extrinsics, intr)


def classify_blocks(meta, depths: torch.Tensor, extrinsics: torch.Tensor,
                    intr: PinholeIntrinsics):
    """(band, visible) bool (N, NB) for a frame batch: the mip pass and
    kernel K2 on CUDA tensors, the plain version on CPU tensors.
    Bit-identical either way."""
    if depths.device.type == "cpu":
        return classify_blocks_torch(meta, depths, extrinsics, intr)
    (gbx, gby, gbz), origin, vs, trunc = meta
    nb = gbx * gby * gbz
    n = depths.shape[0]
    band = torch.empty((n, nb), dtype=torch.bool, device=depths.device)
    vis = torch.empty_like(band)
    if n == 0:
        return band, vis
    ext = extrinsics.to(torch.float32).contiguous()   # read in place
    if ext.shape != (n, 4, 4):
        raise ValueError(f"extrinsics {tuple(ext.shape)} for {n} frames: "
                         f"need ({n}, 4, 4)")
    table, gbounds, th, tw = depth_mips(depths)
    _build.check_operands(table, gbounds, ext, band, vis)
    r, slack_num = classify_constants(meta, intr)
    lib = _build.load()
    code = lib.otslam_classify(
        table.data_ptr(), gbounds.data_ptr(), ext.data_ptr(),
        band.data_ptr(), vis.data_ptr(), n, nb, gby, gbz, th, tw,
        intr.width, intr.height, _f32(origin[0]), _f32(origin[1]),
        _f32(origin[2]), _f32(vs), _f32(0.5 * BLOCK * vs), _f32(r),
        _f32(r * 0.5), slack_num, _f32(intr.fx), _f32(intr.fy),
        _f32(intr.cx), _f32(intr.cy), _f32(trunc),
        _build.stream_ptr(depths.device))
    _build.check(code, "otslam_classify")
    return band, vis


# ---------------------------------------------------------------------------
# schedule: creation recurrence and CSR work list
# ---------------------------------------------------------------------------

def created_and_active(band, visible, created_in):
    """(created (N, NB), active (N, NB)) from the classification and the
    volume's created mask (NB,): created_f = created_in | OR_{f'<=f} band."""
    created = torch.cummax(band.to(torch.uint8), dim=0).values.bool()
    created = created | created_in[None]
    return created, created & visible


def active_worklist(active: torch.Tensor):
    """CSR work list of an (N, NB) active mask: (ids (A,), ptr (A+1,),
    frames (nnz,)) int32, blocks ascending, frames ascending per block.
    One host sync fetches both sizes (A, nnz); the compactions then run
    at those static sizes."""
    counts = active.sum(dim=0)                         # frames per block
    listed = counts > 0
    waited(active)
    n_ids, nnz = torch.stack([listed.sum(), counts.sum()]).tolist()
    ids = torch.nonzero_static(listed, size=n_ids)[:, 0]
    frames = torch.nonzero_static(active.t(), size=nnz)[:, 1]  # block-major
    ptr = torch.zeros(n_ids + 1, dtype=torch.int32, device=active.device)
    ptr[1:] = torch.cumsum(counts[ids], 0)
    return (ids.to(torch.int32), ptr, frames.to(torch.int32).contiguous())


# ---------------------------------------------------------------------------
# K1: fusion
# ---------------------------------------------------------------------------

VOXELS_PER_THREAD = 2        # K1's voxels a thread (csrc/tsdf_fuse.cu's V)
MAX_GRID_BLOCKS = 2**31 - 1  # a CUDA grid's x dimension


def fuse_launch(n_ids: int):
    """(blocks, threads) of a K1 launch: one block of 512 / V threads per
    listed block. Refuses a count a grid cannot hold."""
    if not 0 <= n_ids <= MAX_GRID_BLOCKS:
        raise ValueError(f"listed block count must be in [0, "
                         f"{MAX_GRID_BLOCKS}], got {n_ids}")
    return n_ids, BLOCK_VOXELS // VOXELS_PER_THREAD


def fuse_blocks_torch(vol: BlockTSDFVolume, ids, ptr, frames, depths,
                      cpacked, extrinsics, intr: PinholeIntrinsics) -> None:
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
        vol.tsdf[bid] = (t_rows * w_rows + tsdf_obs * w_obs) / denom
        vol.weight[bid] = w_new
        vol.color[bid] = ((c_rows * w_rows.repeat(1, 3) + col_obs)
                          / denom.repeat(1, 3))


def fuse_blocks(vol: BlockTSDFVolume, ids, ptr, frames, depths, cpacked,
                extrinsics, intr: PinholeIntrinsics) -> None:
    """Fuse the CSR work list into `vol` in place: kernel K1 on CUDA
    tensors, the plain version on CPU tensors. Counts the list's blocks
    (``k1_blocks``) and (block, frame) pairs (``k1_pairs``)."""
    count("k1_blocks", ids.shape[0])
    count("k1_pairs", frames.shape[0])
    if vol.device.type == "cpu":
        fuse_blocks_torch(vol, ids, ptr, frames, depths, cpacked,
                          extrinsics, intr)
        return
    (_, gby, gbz), origin, vs, trunc = vol.meta
    depths = depths.to(torch.float32).contiguous()
    cpacked = cpacked.to(torch.int32).contiguous()
    ext = _ext12(extrinsics)
    ids, ptr, frames = (x.to(torch.int32).contiguous()
                        for x in (ids, ptr, frames))
    _build.check_operands(vol.tsdf, vol.weight, vol.color, ids, ptr, frames,
                          depths, cpacked, ext)
    n, H, W = depths.shape
    if ptr.shape[0] != ids.shape[0] + 1:
        raise ValueError("ptr must hold len(ids) + 1 offsets")
    if ids.numel():
        waited(ids)         # one host sync: the kernel trusts the list
        if bool((ids.min() < 0) | (ids.max() >= vol.num_blocks)
                | (frames.min() < 0) | (frames.max() >= n)
                | (ptr[-1] != frames.shape[0])):
            raise ValueError("work list out of range for this volume/batch")
    if (H, W) != (intr.height, intr.width):
        raise ValueError(f"frames {H}x{W} != intrinsics "
                         f"{intr.height}x{intr.width}")
    if (vol.tsdf.shape[1] != BLOCK_VOXELS
            or vol.color.shape[1] != 3 * BLOCK_VOXELS):
        raise ValueError("block volume rows must be (NB+1, 512)/(NB+1, 1536)")
    if ext.data_ptr() % 16:
        raise ValueError("extrinsic rows must be 16-byte aligned")
    n_ids, _ = fuse_launch(ids.shape[0])
    lib = _build.load()
    code = lib.otslam_fuse(
        vol.tsdf.data_ptr(), vol.weight.data_ptr(), vol.color.data_ptr(),
        ids.data_ptr(), ptr.data_ptr(), frames.data_ptr(), n_ids,
        depths.data_ptr(), cpacked.data_ptr(), ext.data_ptr(), H, W, gby,
        gbz, _f32(origin[0]), _f32(origin[1]), _f32(origin[2]), _f32(vs),
        _f32(intr.fx), _f32(intr.fy), _f32(intr.cx), _f32(intr.cy),
        _f32(trunc), recip32(trunc), _build.stream_ptr(vol.device))
    _build.check(code, "otslam_fuse")


def integrate_frames_cuda(vol: BlockTSDFVolume, depths, colors, extrinsics,
                          intr: PinholeIntrinsics,
                          max_active: int | None = None) -> BlockTSDFVolume:
    """Fuse a frame batch into `vol` in place (see the module docstring);
    returns `vol`. depths (N,H,W), colors (N,H,W,3) in [0,255], extrinsics
    (N,4,4) world->camera, on the volume's device. max_active caps each
    frame's active blocks to its max_active lowest ids, as the JAX
    package's compact_ids does; None integrates every active block.
    Creation is not capped: it takes the whole band."""
    nb = vol.num_blocks
    depths = depths.to(torch.float32)
    if depths.shape[0] == 0:
        return vol
    with span("fuse.schedule"):
        band, visible = classify_blocks(vol.meta, depths, extrinsics, intr)
        created, active = created_and_active(band, visible, vol.created[:nb])
        if max_active is not None:
            active &= torch.cumsum(active, dim=1) <= max_active
        ids, ptr, frames = active_worklist(active)
    with span("fuse.pack"):
        cpacked = pack_rgb(colors)
    with span("fuse.k1"):
        fuse_blocks(vol, ids, ptr, frames, depths, cpacked, extrinsics, intr)
        vol.created[:nb] = created[-1]
        # the work list never names the dead row; keep its zero invariant
        # even for a volume that arrived with it dirtied
        vol.tsdf[nb] = 0.0
        vol.weight[nb] = 0.0
        vol.color[nb] = 0.0
    return vol
