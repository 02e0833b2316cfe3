"""Batched perception: K ticks per call (counterpart of
otslam_tpu/mapping/perception.py).

One perception tick is ray cast -> windowed scan diff -> dwell/decay
evidence update -> confident-cell compaction (virtual_scan_node.cpp:258-287,
diff_node.cpp:102-185). The K virtual scans and the K scan diffs do not
depend on the carried grids, so `perception_ticks` casts all K virtual
scans in one K5 launch and diffs and scatters all K scans at once; only the
dwell update runs tick by tick. Per-tick confident cells are compacted to a
static capacity on the device (a cumsum and a scatter), so a caller moves
K ticks of detections to the host in one transfer, and nothing inside the
loop waits for the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from otslam_tpu_torch.config import ChangeDetectConfig
from otslam_tpu_torch.kernels.evidence import cell_centers, update_evidence
from otslam_tpu_torch.kernels.raycast import raycast_grid_fast
from otslam_tpu_torch.mapping.change_detect import scan_hits


class PerceptionBatch(NamedTuple):
    new_grid: torch.Tensor       # (GH, GW) updated added-evidence dwell grid
    gone_grid: torch.Tensor      # (GH, GW) updated removed-evidence grid
    virtual: torch.Tensor        # (K, B) per-tick virtual scans
    added_pts: torch.Tensor      # (K, P, 2) compacted confident added cells
    added_cnt: torch.Tensor      # (K,) valid counts
    removed_pts: torch.Tensor    # (K, P, 2)
    removed_cnt: torch.Tensor    # (K,)


def compact_ids(active: torch.Tensor, max_ids: int) -> torch.Tensor:
    """Ascending indices of the first `max_ids` True entries along the last
    axis of `active` (..., n), padded with n: (..., max_ids) int64. The
    contract of the JAX package's compact_ids/_compact_ids_hier, built from
    a cumsum and a scatter into the static capacity plus one dead slot."""
    n = active.shape[-1]
    lead = active.shape[:-1]
    rows = active.reshape(-1, n)
    pos = torch.cumsum(rows, dim=1) - 1                 # rank of each hit
    slot = torch.where(rows & (pos < max_ids), pos, max_ids)
    out = torch.full((rows.shape[0], max_ids + 1), n, dtype=torch.int64,
                     device=active.device)
    ids = torch.arange(n, device=active.device).expand_as(slot)
    out.scatter_(1, slot, ids)       # the dead slot takes any loser; dropped
    return out[:, :max_ids].reshape(*lead, max_ids)


def _compact_confident(dwell: torch.Tensor, resolution: float,
                       time_threshold: float, max_points: int):
    """Confident cell centres compacted to a static capacity: points
    (..., max_points, 2) zero beyond the count, and counts (...,) clipped
    at max_points. dwell (..., GH, GW). Cell centres follow
    evidence_points: centre = signed key * res + res/2."""
    GH, GW = dwell.shape[-2:]
    n = GH * GW
    conf = (dwell > time_threshold).reshape(*dwell.shape[:-2], n)
    ids = compact_ids(conf, max_points)
    cnt = torch.clamp(conf.sum(dim=-1, dtype=torch.int32), max=max_points)
    idc = torch.clamp(ids, max=n - 1)
    ky = idc // GW - GH // 2
    kx = idc % GW - GW // 2
    out = torch.stack([cell_centers(kx, resolution),
                       cell_centers(ky, resolution)], dim=-1)
    mask = (torch.arange(max_points, device=dwell.device)
            < cnt[..., None])[..., None]
    return torch.where(mask, out, 0.0), cnt


def perception_ticks(grid_data: torch.Tensor, resolution: float,
                     origin_x: float, origin_y: float,
                     new_grid: torch.Tensor, gone_grid: torch.Tensor,
                     reals: torch.Tensor, poses: torch.Tensor,
                     dts: torch.Tensor, angles: torch.Tensor,
                     cfg: ChangeDetectConfig, range_max: float,
                     max_points: int = 256) -> PerceptionBatch:
    """Run K full perception ticks on the grid's device.

    grid_data: (H, W) int8 saved occupancy map; reals: (K, B) real scans;
    poses: (K, 3) believed (x, y, yaw) per tick; dts: (K,) evidence time
    steps; angles: (B,) beam angles. Per tick the result equals
    VirtualScanner.scan + ChangeDetector.on_scan (tested for parity)."""
    dev = grid_data.device
    poses = poses.to(device=dev, dtype=torch.float32)
    dts = dts.to(device=dev, dtype=torch.float32)
    reals = reals.to(device=dev, dtype=torch.float32)
    # all K virtual scans: one K5 launch on the card
    virt = raycast_grid_fast(grid_data, resolution, origin_x, origin_y,
                             poses[:, 0], poses[:, 1], poses[:, 2], angles,
                             range_max)
    new_hits, gone_hits = scan_hits(new_grid, reals, virt, angles, poses,
                                    cfg, range_max)
    k = reals.shape[0]
    ng_ticks = torch.empty((k, *new_grid.shape), dtype=torch.float32,
                           device=dev)
    gg_ticks = torch.empty_like(ng_ticks)
    ng, gg = new_grid, gone_grid
    for i in range(k):
        ng = update_evidence(ng, new_hits[i], dts[i], cfg.time_threshold,
                             cfg.decay_rate)
        gg = update_evidence(gg, gone_hits[i], dts[i], cfg.time_threshold,
                             cfg.decay_rate)
        ng_ticks[i] = ng
        gg_ticks[i] = gg
    apts, acnt = _compact_confident(ng_ticks, cfg.grid_resolution,
                                    cfg.time_threshold, max_points)
    rpts, rcnt = _compact_confident(gg_ticks, cfg.grid_resolution,
                                    cfg.time_threshold, max_points)
    return PerceptionBatch(ng, gg, virt, apts, acnt, rpts, rcnt)
