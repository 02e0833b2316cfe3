"""Nearest-neighbour distances between point clouds (counterpart of
otslam_tpu/kernels/nn.py).

Reproduces Open3D ``compute_point_cloud_distance`` (the eval protocol,
eval_table_chair.py:106-119) by brute force: for each source point, the
minimum squared distance over the valid destination points and the lowest
index among ties (`nn_min`, kernel K3 in csrc/nn.cu on CUDA tensors, its
plain version `nn_min_torch` on CPU tensors), then the exact recompute of
the winning pair (`nn_distance`).

Not ported, because each exists only for the TPU's MXU and VMEM: the 3-way
bf16 operand split (_hilo3) and K=24 packing, destination slabbing and the
VMEM size routing. The radius-limited variant (nn_distance_radius, kernel
K4) arrives with the registration slice.
"""

from __future__ import annotations

import torch

from otslam_tpu_torch.kernels import _build

BIG = 3.0e38        # f32 "no valid destination" distance (nn._BIG)
SRC_CHUNK = 4096    # source rows per step of the plain version


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
    srcc = src.to(torch.float32).contiguous()
    dst4 = torch.cat([dst.to(torch.float32),
                      dst_mask.to(torch.float32)[:, None]], dim=1).contiguous()
    best_d = torch.empty(n, dtype=torch.float32, device=src.device)
    best_i = torch.empty(n, dtype=torch.int32, device=src.device)
    _build.check_operands(srcc, dst4, best_d, best_i)
    lib = _build.load()
    code = lib.otslam_nn(srcc.data_ptr(), dst4.data_ptr(), n, m,
                         best_d.data_ptr(), best_i.data_ptr(),
                         _build.stream_ptr(src.device))
    _build.check(code, "otslam_nn")
    nn_min.launches += 1
    return best_d, best_i.to(torch.int64)


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
