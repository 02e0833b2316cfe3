"""Batched block-sparse fusion with the hand-written CUDA kernels K1 and K2.

Counterpart of otslam_tpu/kernels/tsdf_pallas.py. The schedule:

1. classify every (frame, block) pair (`classify_blocks`, kernel K2,
   csrc/tsdf_classify.cu) into band (drives creation) and visible (drives
   integration);
2. the creation recurrence ``created_f = created_in | OR_{f' <= f} band_f'``
   as a cumulative max over the frame axis (the JAX package's tril matmul,
   `_cumulative_or`); ``active = created & visible``;
3. a CSR work list from the (N, NB) active mask, with one host sync:
   ids (blocks active in any frame, ascending), ptr (A+1,), frames (nnz,)
   ascending per block;
4. fuse (`fuse_blocks`, kernel K1, csrc/tsdf_fuse.cu): per listed block,
   the running weighted mean over its frames in order, written once;
   `fuse_launch` gives its launch shape.

Each kernel wrapper takes its plain PyTorch version for CPU tensors only;
for CUDA tensors it launches the kernel or raises. `launches` on each
wrapper counts kernel launches.

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
    BLOCK, BLOCK_VOXELS, BlockTSDFVolume, _active_blocks, _depth_mips,
    _sample_frame, _voxel_world_coords, classify_constants, pack_rgb)


def _f32(x: float) -> float:
    """x rounded to f32, as the JAX graph embeds a Python constant."""
    return float(np.float32(x))


def _ext12(extrinsics: torch.Tensor) -> torch.Tensor:
    """(N, 12) f32 rows of E[:3, :4]."""
    return extrinsics.to(torch.float32)[:, :3, :].reshape(-1, 12).contiguous()


# ---------------------------------------------------------------------------
# K2: block classification
# ---------------------------------------------------------------------------

def classify_blocks_torch(meta, depths, extrinsics, intr: PinholeIntrinsics):
    """Plain version of K2: (band, visible) bool (N, NB)."""
    return _active_blocks(meta, depths, extrinsics, intr)


def classify_blocks(meta, depths: torch.Tensor, extrinsics: torch.Tensor,
                    intr: PinholeIntrinsics):
    """(band, visible) bool (N, NB) for a frame batch: kernel K2 on CUDA
    tensors, the plain version on CPU tensors. Bit-identical either way."""
    if depths.device.type == "cpu":
        return classify_blocks_torch(meta, depths, extrinsics, intr)
    (gbx, gby, gbz), origin, vs, trunc = meta
    nb = gbx * gby * gbz
    n = depths.shape[0]
    table, th, tw = _depth_mips(depths)             # (N, th*tw, 8), on card
    table = table.contiguous()
    gbounds = torch.stack([table[..., 4].amin(dim=-1),
                           table[..., 5].amax(dim=-1)], dim=-1).contiguous()
    ext = _ext12(extrinsics)
    band = torch.empty((n, nb), dtype=torch.uint8, device=depths.device)
    vis = torch.empty_like(band)
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
    classify_blocks.launches += 1
    return band.bool(), vis.bool()


classify_blocks.launches = 0


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
    tensors, the plain version on CPU tensors."""
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
    if ids.numel() and bool(  # one host sync: the kernel trusts the list
            (ids.min() < 0) | (ids.max() >= vol.num_blocks)
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
    fuse_blocks.launches += 1


fuse_blocks.launches = 0


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
    band, visible = classify_blocks(vol.meta, depths, extrinsics, intr)
    created, active = created_and_active(band, visible, vol.created[:nb])
    if max_active is not None:
        active &= torch.cumsum(active, dim=1) <= max_active
    ids, ptr, frames = active_worklist(active)
    fuse_blocks(vol, ids, ptr, frames, depths, pack_rgb(colors), extrinsics,
                intr)
    vol.created[:nb] = created[-1]
    # the work list never names the dead row; keep its zero invariant even
    # for a volume that arrived with it dirtied
    vol.tsdf[nb] = 0.0
    vol.weight[nb] = 0.0
    vol.color[nb] = 0.0
    return vol
