"""Nearest-neighbour distances between point clouds (counterpart of
otslam_tpu/kernels/nn.py).

Reproduces Open3D ``compute_point_cloud_distance`` (the eval protocol,
eval_table_chair.py:106-119) by brute force: for each source point, the
minimum squared distance over the valid destination points and the lowest
index among ties (`nn_min`, kernel K3 in csrc/nn.cu on CUDA tensors, its
plain version `nn_min_torch` on CPU tensors), then the exact recompute of
the winning pair (`nn_distance`).

The radius-limited variant `nn_distance_radius` (ICP, trajectory
refinement, scan localization) scans, for each 256-row source tile, only
the 1024-row destination chunks that can hold a neighbour within the
radius: `window_ranges` computes each tile's chunk range [c0, c1) on the
device, and `nn_min_windowed` (kernel K4 in csrc/nn.cu on CUDA tensors, its
plain version `nn_min_windowed_torch` on CPU tensors) scans it.

Both kernels give a block to each 256-row source tile. When the tiles
alone cannot fill the card (`split_count`, from the sizes and the SM count
only), each tile's range is split over S blocks whose results merge by the
exact 64-bit key (bits(d2) << 32) | index (`pack_keys` states it in torch),
so the lowest-index rule holds whatever the split.

Not ported, because each exists only for the TPU's MXU and VMEM: the 3-way
bf16 operand split (_hilo3) and K=24 packing, destination slabbing, the
VMEM size routing (_WINDOWED_MAX_DST, _nn_vmem_params), the 128-aligned
window reads and the traced fit flag with its fall-back to the full kernel
(K4 scans exactly the range each tile needs, and an unsorted destination
gives every tile the whole range).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from otslam_tpu_torch.kernels import _build

BIG = 3.0e38        # f32 "no valid destination" distance (nn._BIG)
SRC_CHUNK = 4096    # source rows per step of the plain version
SRC_TILE = 256      # source rows per window (nn._SRC_TILE, a K3/K4 block)
DST_CHUNK = 1024    # destination rows per window chunk (nn._DST_CHUNK)
BLOCKS_PER_SM = 2   # K3/K4 split each tile's range below this many blocks
SPLIT_BLOCKS_PER_SM = 8  # ... into enough splits for this many blocks
MIN_SPLIT_DST = 256  # ... but give a split at least this many destinations


def split_count(n: int, m: int, sms: int) -> int:
    """Blocks S that share each source tile's destination range in K3/K4.

    1 when the ceil(n / 256) tiles give at least BLOCKS_PER_SM blocks an
    SM; else enough splits for SPLIT_BLOCKS_PER_SM blocks an SM (many
    short blocks balance tiles whose ranges differ), but no fewer than
    MIN_SPLIT_DST of the m destinations a split on average."""
    tiles = -(-n // SRC_TILE)
    if tiles == 0 or tiles >= BLOCKS_PER_SM * sms:
        return 1
    want = SPLIT_BLOCKS_PER_SM * sms
    return max(1, min(-(-want // tiles), m // MIN_SPLIT_DST))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device, read once per device."""
    dev = torch.device(device)
    return _sm_count(torch.cuda.current_device() if dev.index is None
                     else dev.index)


def pack_keys(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The 64-bit merge key of csrc/nn.cu, (bits(d2) << 32) | idx, as int64:
    for d2 >= +0 (inf included) the top bit is 0, so int64 order is the
    kernel's unsigned order: least d2 first, then least index."""
    bits = d2.to(torch.float32).contiguous().view(torch.int32)
    return (bits.to(torch.int64) << 32) | idx.to(torch.int64)


def unpack_keys(keys: torch.Tensor):
    """(d2 f32, idx int64) of pack_keys' keys."""
    d2 = (keys >> 32).to(torch.int32).contiguous().view(torch.float32)
    return d2, keys & 0xFFFFFFFF


def _operands(src, dst, mask):
    """The kernels' inputs as they take them: f32 (n, 3), f32 (m, 3), bool
    (m,), contiguous (no copy when they already are)."""
    return (src.to(torch.float32).contiguous(),
            dst.to(torch.float32).contiguous(),
            mask.to(torch.bool).contiguous())


def _outputs(n: int, splits: int, device):
    """best_d (n,) f32, best_i (n,) int64, and the (splits, n) key scratch
    of a split launch (empty when splits == 1)."""
    return (torch.empty(n, dtype=torch.float32, device=device),
            torch.empty(n, dtype=torch.int64, device=device),
            torch.empty((splits, n) if splits > 1 else (0,),
                        dtype=torch.int64, device=device))


def nn_min_torch(src: torch.Tensor, dst: torch.Tensor,
                 dst_mask: torch.Tensor):
    """Plain version of K3: (best_d2 (N,) f32, best_i (N,) int64).

    The squared distance is ((dx*dx + dy*dy) + dz*dz) in f32, masked
    destinations count as BIG, ties keep the lowest index; no valid
    destination gives (BIG, 0)."""
    out_d, out_i = [], []
    for s in range(0, src.shape[0], SRC_CHUNK):
        a = src[s:s + SRC_CHUNK]
        dx = a[:, None, 0] - dst[None, :, 0]
        dy = a[:, None, 1] - dst[None, :, 1]
        dz = a[:, None, 2] - dst[None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz
        d2 = torch.where(dst_mask[None, :], d2, BIG)
        idx = torch.argmin(d2, dim=1)           # first minimum on ties
        out_d.append(torch.gather(d2, 1, idx[:, None])[:, 0])
        out_i.append(idx)
    if not out_d:
        return (torch.empty(0, device=src.device),
                torch.empty(0, dtype=torch.int64, device=src.device))
    return torch.cat(out_d), torch.cat(out_i)


def nn_min(src: torch.Tensor, dst: torch.Tensor, dst_mask: torch.Tensor):
    """(best_d2, best_i) of each source point: kernel K3 on CUDA tensors,
    the plain version on CPU tensors. Identical results either way."""
    if src.device.type == "cpu":
        return nn_min_torch(src, dst, dst_mask)
    n, m = src.shape[0], dst.shape[0]
    srcc, dstc, maskc = _operands(src, dst, dst_mask)
    splits = split_count(n, m, sm_count(src.device))
    best_d, best_i, parts = _outputs(n, splits, src.device)
    _build.check_operands(srcc, dstc, maskc, best_d, best_i, parts)
    lib = _build.load()
    code = lib.otslam_nn(srcc.data_ptr(), dstc.data_ptr(), maskc.data_ptr(),
                         n, m, splits, best_d.data_ptr(), best_i.data_ptr(),
                         parts.data_ptr(), _build.stream_ptr(src.device))
    _build.check(code, "otslam_nn")
    nn_min.launches += 1
    return best_d, best_i


nn_min.launches = 0


def nn_distance(src: torch.Tensor, dst: torch.Tensor,
                src_mask: torch.Tensor | None = None,
                dst_mask: torch.Tensor | None = None,
                with_index: bool = False):
    """For each src point, the distance to (and optionally the index of)
    the nearest valid dst point. src (N,3), dst (M,3) on one device; masks
    select valid rows. Invalid src rows get distance 0 and index 0.
    Returns dists (N,) [, indices (N,)]."""
    n = src.shape[0]
    dev = src.device
    smask = (torch.ones(n, dtype=torch.bool, device=dev) if src_mask is None
             else src_mask)
    if dst.shape[0] == 0:
        dists = torch.where(smask, torch.sqrt(torch.tensor(BIG, device=dev)),
                            0.0)
        if with_index:
            return dists, torch.zeros(n, dtype=torch.int64, device=dev)
        return dists
    dmask = (torch.ones(dst.shape[0], dtype=torch.bool, device=dev)
             if dst_mask is None else dst_mask)
    best_d, best_i = nn_min(src, dst, dmask)
    # exact recompute of the winning pair (nn_distance's tail)
    diff = src - dst[best_i]
    exact = torch.sum(diff * diff, dim=-1)
    exact = torch.where(best_d >= 0.5 * BIG, best_d, exact)
    dists = torch.sqrt(torch.clamp(torch.where(smask, exact, 0.0), min=0.0))
    if with_index:
        return dists, torch.where(smask, best_i, 0)
    return dists


def nn_window_bounds(dst, axis: int | None = None):
    """Host-side dst precompute for auto_nn_window: (axis, chunk_lo,
    chunk_hi, nchunks) of the sorted dst's per-chunk sort-coordinate
    bounds. Callers registering many scans against one fixed cloud (e.g.
    ScanLocalizer) compute this once and pass it as dst_bounds."""
    d = np.asarray(dst, np.float32)
    if axis is None:
        axis = int(np.argmax(d.max(axis=0) - d.min(axis=0)))
    dc = DST_CHUNK
    m = d.shape[0]
    zd = np.sort(d[:, axis])
    zd = np.pad(zd, (0, (-m) % dc), mode="edge")
    return axis, zd[::dc], zd[dc - 1::dc], -(-m // dc)


def auto_nn_window(src, dst, radius, axis: int | None = None,
                   margin: int = 1, round_to: int = 1,
                   dst_bounds=None) -> tuple[int, int]:
    """Host-side (window_chunks, axis) sizing for nn_distance_radius /
    icp(..., nn_window=...): the widest-spread dst coordinate and the
    per-tile chunk-window requirement for these concrete clouds (both
    sorted on that axis), plus `margin` chunks, rounded up to a multiple
    of `round_to` and capped at the chunk count. The port's K4 scans
    exactly the range each tile needs, so the window only routes: a
    window that covers the whole cloud takes the full scan (K3).
    dst_bounds: precomputed nn_window_bounds(dst); both clouds must be
    non-empty. Host numpy, identical to the JAX package's."""
    s = np.asarray(src, np.float32)
    if dst_bounds is None:
        dst_bounds = nn_window_bounds(dst, axis)
    axis, chunk_lo, chunk_hi, nchunks = dst_bounds
    ts = SRC_TILE
    n = s.shape[0]
    zs = np.sort(s[:, axis])
    zs = np.pad(zs, (0, (-n) % ts), mode="edge").reshape(-1, ts)
    r = float(radius)
    c0 = np.searchsorted(chunk_hi, zs[:, 0] - r, side="left")
    c1 = np.searchsorted(chunk_lo, zs[:, -1] + r, side="right")
    need = int((c1 - c0).max()) if len(c0) else nchunks
    need = -(-(need + margin) // round_to) * round_to
    return min(need, nchunks), axis


def window_ranges(src: torch.Tensor, dst: torch.Tensor, dst_mask,
                  radius: float, axis: int):
    """Operands of the windowed scan, all on the clouds' device with no
    host sync: (dstp (Mp, 3), dmaskp (Mp,), c0 (T,), c1 (T,)) with Mp the
    destination padded to whole chunks by repeating its last row (masked
    off; the sort axis stays monotone) and [c0, c1) int32 the chunks that
    can hold a neighbour within `radius` of each source tile (the source
    is padded with its last row likewise). When dst is not sorted
    ascending on `axis`, every tile gets the whole range [0, Mp/1024)."""
    n, m = src.shape[0], dst.shape[0]
    ts, dc = SRC_TILE, DST_CHUNK
    mpad = -(-m // dc) * dc
    npad = -(-n // ts) * ts
    dstp = torch.cat([dst, dst[-1:].expand(mpad - m, 3)])
    dmaskp = torch.nn.functional.pad(dst_mask, (0, mpad - m))
    srcp = torch.cat([src, src[-1:].expand(npad - n, 3)])
    sz = srcp[:, axis].reshape(npad // ts, ts)
    tile_lo = sz.amin(dim=1) - radius
    tile_hi = sz.amax(dim=1) + radius
    dz = dstp[:, axis]
    chunk_lo = dz[::dc].contiguous()          # first row of each chunk
    chunk_hi = dz[dc - 1::dc].contiguous()    # last row of each chunk
    c0 = torch.searchsorted(chunk_hi, tile_lo, side="left")
    c1 = torch.searchsorted(chunk_lo, tile_hi, side="right")
    sorted_ok = torch.all(dz[1:] >= dz[:-1])
    c0 = torch.where(sorted_ok, c0, 0).to(torch.int32)
    c1 = torch.where(sorted_ok, c1, mpad // dc).to(torch.int32)
    return dstp, dmaskp, c0, c1


def nn_min_windowed_torch(src: torch.Tensor, dstp: torch.Tensor,
                          dmaskp: torch.Tensor, c0: torch.Tensor,
                          c1: torch.Tensor):
    """Plain version of K4: nn_min_torch with every destination outside
    the source tile's chunk range [c0, c1) counted as BIG. Returns
    (best_d2 (N,) f32, best_i (N,) int64); a tile with no valid
    destination in range gives (BIG, 0)."""
    out_d, out_i = [], []
    col_chunk = torch.arange(dstp.shape[0], device=src.device) // DST_CHUNK
    tiles = torch.arange(src.shape[0], device=src.device) // SRC_TILE
    for s in range(0, src.shape[0], SRC_CHUNK):
        a = src[s:s + SRC_CHUNK]
        t = tiles[s:s + SRC_CHUNK]
        dx = a[:, None, 0] - dstp[None, :, 0]
        dy = a[:, None, 1] - dstp[None, :, 1]
        dz = a[:, None, 2] - dstp[None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz
        keep = (dmaskp[None, :] & (col_chunk[None, :] >= c0[t][:, None])
                & (col_chunk[None, :] < c1[t][:, None]))
        d2 = torch.where(keep, d2, BIG)
        idx = torch.argmin(d2, dim=1)           # first minimum on ties
        out_d.append(torch.gather(d2, 1, idx[:, None])[:, 0])
        out_i.append(idx)
    if not out_d:
        return (torch.empty(0, device=src.device),
                torch.empty(0, dtype=torch.int64, device=src.device))
    return torch.cat(out_d), torch.cat(out_i)


def nn_min_windowed(src: torch.Tensor, dstp: torch.Tensor,
                    dmaskp: torch.Tensor, c0: torch.Tensor,
                    c1: torch.Tensor):
    """(best_d2, best_i) of each source point over its tile's chunk range
    (window_ranges' operands): kernel K4 on CUDA tensors, the plain
    version on CPU tensors. Identical results either way."""
    if src.device.type == "cpu":
        return nn_min_windowed_torch(src, dstp, dmaskp, c0, c1)
    n, mp = src.shape[0], dstp.shape[0]
    ntiles = -(-n // SRC_TILE)
    if mp % DST_CHUNK or c0.shape[0] != ntiles or c1.shape[0] != ntiles:
        raise ValueError("nn_min_windowed: dst must be chunk-padded and "
                         "c0/c1 hold one range per 256-row source tile")
    srcc, dstc, maskc = _operands(src, dstp, dmaskp)
    c0, c1 = (c.to(torch.int32).contiguous() for c in (c0, c1))
    splits = split_count(n, mp, sm_count(src.device))
    best_d, best_i, parts = _outputs(n, splits, src.device)
    _build.check_operands(srcc, dstc, maskc, c0, c1, best_d, best_i, parts)
    lib = _build.load()
    code = lib.otslam_nn_window(srcc.data_ptr(), dstc.data_ptr(),
                                maskc.data_ptr(), c0.data_ptr(),
                                c1.data_ptr(), n, mp, splits,
                                best_d.data_ptr(), best_i.data_ptr(),
                                parts.data_ptr(),
                                _build.stream_ptr(src.device))
    _build.check(code, "otslam_nn_window")
    nn_min_windowed.launches += 1
    return best_d, best_i


nn_min_windowed.launches = 0


def nn_distance_radius(src: torch.Tensor, dst: torch.Tensor, radius: float,
                       src_mask: torch.Tensor | None = None,
                       dst_mask: torch.Tensor | None = None,
                       window_chunks: int = 8, axis: int = 2,
                       with_index: bool = False):
    """nn_distance exact only within `radius`: for src points whose true
    NN is farther than radius, the returned distance is merely guaranteed
    >= the true distance (hence >= radius) and the index is that of some
    scanned point, or 0. The contract ICP needs: correspondences beyond
    the inlier threshold carry zero weight.

    dst should be sorted ascending on coordinate `axis` and src at least
    tile-coherent on it (e.g. also sorted); neither is required for
    correctness (an unsorted dst scans every chunk). window_chunks routes
    as in the JAX package: a window that covers the whole dst
    (window_chunks * 1024 >= M) takes nn_distance (K3)."""
    n, m = src.shape[0], dst.shape[0]
    if window_chunks * DST_CHUNK >= m:
        return nn_distance(src, dst, src_mask, dst_mask,
                           with_index=with_index)
    dev = src.device
    smask = (torch.ones(n, dtype=torch.bool, device=dev) if src_mask is None
             else src_mask)
    dmask = (torch.ones(m, dtype=torch.bool, device=dev) if dst_mask is None
             else dst_mask)
    dstp, dmaskp, c0, c1 = window_ranges(src, dst, dmask, radius, axis)
    best_d, best_i = nn_min_windowed(src, dstp, dmaskp, c0, c1)
    # exact recompute of the winning pair (nn_distance's tail)
    diff = src - dstp[best_i]
    exact = torch.sum(diff * diff, dim=-1)
    exact = torch.where(best_d >= 0.5 * BIG, best_d, exact)
    dists = torch.sqrt(torch.clamp(torch.where(smask, exact, 0.0), min=0.0))
    if with_index:
        return dists, torch.where(smask, best_i, 0)
    return dists


def chamfer_metrics(map_pts: torch.Tensor, gt_pts: torch.Tensor,
                    map_mask: torch.Tensor | None = None,
                    gt_mask: torch.Tensor | None = None):
    """(accuracy, completeness) in meters as 0-dim tensors: mean NN distance
    map->gt and gt->map over valid points (eval_table_chair.py:106-119;
    x100 for cm)."""
    dev = map_pts.device
    mm = (torch.ones(map_pts.shape[0], dtype=torch.bool, device=dev)
          if map_mask is None else map_mask)
    gm = (torch.ones(gt_pts.shape[0], dtype=torch.bool, device=dev)
          if gt_mask is None else gt_mask)
    d_mg = nn_distance(map_pts, gt_pts, mm, gm)
    d_gm = nn_distance(gt_pts, map_pts, gm, mm)
    acc = torch.sum(d_mg * mm) / torch.clamp(mm.sum(), min=1)
    comp = torch.sum(d_gm * gm) / torch.clamp(gm.sum(), min=1)
    return acc, comp
