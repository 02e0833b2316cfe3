"""1-D LiDAR gap clustering, PCA linearity and wall/object classification
(counterpart of otslam_tpu/kernels/cluster.py).

Behavioural contracts:
* Gap clustering: consecutive points further apart than ``gap_threshold``
  start a new cluster (lidar_cluster_publisher.cpp:151-183,
  3_multi_object_goal_selector.cpp:178-190). The scan's wrap-around pair
  (last beam -> first beam) merges the first and last clusters
  (lidar_cluster_publisher.cpp:186-199).
* Per cluster: point count, bbox, centroid, bbox-diagonal "length"
  (lidar_cluster_publisher.cpp:113-127) and PCA linearity
  lambda_min / (lambda_max + 1e-6) from the 2x2 covariance with n-1
  normalization (lidar_cluster_publisher.cpp:129-148).
* Classification (lidar_cluster_publisher.cpp:243-256): WALL if
  linearity < wal_lin_max and length > wal_len_min and n > wal_nmp_min;
  else OBJECT if length < obj_len_max and n > obj_nmp_min; else UNKNOWN.

The device functions (``cluster_scan_points``, ``analyze_clusters``,
``scan_to_points``) serve the initial-mapping classifier: segment ids from
a cumsum over gap flags, per-cluster sums and extrema scattered into
``max_clusters + 1`` slots (the last one collects invalid points), and the
2x2 eigenvalues in closed form, on the CPU or the card. The host functions
serve the object tracker, which clusters the per-tick change clouds (a few
hundred cells) without a device round trip.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from otslam_tpu_torch.config import ClusterConfig
from otslam_tpu_torch.kernels.tsdf import fma32

WALL, OBJECT, UNKNOWN, INVALID = 0, 1, 2, 3


class ClusterStats(NamedTuple):
    count: torch.Tensor      # (C,) i32
    min_xy: torch.Tensor     # (C, 2)
    max_xy: torch.Tensor     # (C, 2)
    centroid: torch.Tensor   # (C, 2) mean of member points
    length: torch.Tensor     # (C,) bbox diagonal
    linearity: torch.Tensor  # (C,) PCA ratio (near 0 = line)
    valid: torch.Tensor      # (C,) bool
    labels: torch.Tensor     # (N,) per-point cluster id (C = invalid)
    classes: torch.Tensor    # (C,) WALL / OBJECT / UNKNOWN / INVALID


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first set entry of a 1-D mask (0 when none is set), as
    jnp.argmax of a bool array; argmax runs on an int32 view."""
    return torch.argmax(mask.to(torch.int32))


def cluster_scan_points(points: torch.Tensor, mask: torch.Tensor,
                        gap_threshold: float, max_clusters: int = 64,
                        merge_wraparound: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Assign consecutive-gap cluster labels.

    points (N, 2) f32 in scan order; mask (N,) valid beams, on one device.
    Invalid beams break adjacency exactly like the reference (points out of
    range are absent from its vector): adjacency is between consecutive
    valid points. Returns (labels (N,) i32 in [0, C], num_clusters, a 0-d
    i32 tensor), where label == max_clusters marks invalid points.
    """
    n = points.shape[0]
    dev = points.device
    idx = torch.arange(n, device=dev)
    # previous valid index of each point: cummax of the valid indices
    marked = torch.where(mask, idx, -1)[:-1]
    prev = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if n > 1:
        prev[1:] = torch.cummax(marked, dim=0).values
    has_prev = mask & (prev >= 0)
    prev_pts = points[torch.clamp(prev, 0, n - 1)]
    dist = torch.hypot(points[:, 0] - prev_pts[:, 0],
                       points[:, 1] - prev_pts[:, 1])
    # the first valid point starts cluster 0 (its gap flag, then -1)
    gap = torch.where(has_prev, dist > gap_threshold, mask).to(torch.int32)
    seg = torch.cumsum(gap, dim=0, dtype=torch.int32) - 1
    seg = torch.where(mask, torch.clamp(seg, 0, max_clusters - 1),
                      max_clusters).to(torch.int32)
    num = torch.clamp(gap.sum(dtype=torch.int32), max=max_clusters)

    if merge_wraparound:
        # wrap-around: if the last valid point is close to the first valid
        # point, the last cluster becomes cluster 0
        first_i = _first_true(mask)
        last_i = n - 1 - _first_true(torch.flip(mask, (0,)))
        d_wrap = torch.hypot(points[first_i, 0] - points[last_i, 0],
                             points[first_i, 1] - points[last_i, 1])
        close = (mask.sum() > 1) & (d_wrap <= gap_threshold)
        last_label = seg[last_i]
        do_merge = close & (last_label > 0)
        seg = torch.where(do_merge & (seg == last_label), 0, seg)
        num = torch.where(do_merge, num - 1, num)
    return seg.to(torch.int32), num.to(torch.int32)


def analyze_clusters(points: torch.Tensor, labels: torch.Tensor,
                     cfg: ClusterConfig) -> ClusterStats:
    """Per-cluster statistics and classification at the static capacity
    cfg.max_clusters. points (N, 2) f32, labels (N,) from
    cluster_scan_points (label >= C: not in a cluster)."""
    C = cfg.max_clusters
    dev = points.device
    valid_pt = labels < C
    w = valid_pt.to(torch.float32)
    seg = torch.where(valid_pt, labels, C).to(torch.int64)
    x, y = points[:, 0], points[:, 1]

    def seg_sums(v):
        # (K, N) -> (K, C): each slot's values added one at a time in index
        # order from 0, the order XLA:CPU's scatter adds in. The adds are
        # elementwise, so every device rounds them alike and the card's
        # sums equal the CPU's bit for bit (a scatter-add on CUDA adds in
        # no fixed order). Step j adds the j-th member of every cluster.
        order = torch.argsort(seg, stable=True)
        s = seg[order]
        sizes = torch.bincount(seg, minlength=C + 1)
        rank = torch.arange(seg.shape[0], device=dev) - (
            torch.cumsum(sizes, 0) - sizes)[s]
        inside = s < C
        longest = int(sizes[:C].max())
        cols = torch.zeros((longest, v.shape[0], C), device=dev)
        cols[rank[inside], :, s[inside]] = v[:, order[inside]].t()
        acc = torch.zeros((v.shape[0], C), device=dev)
        for col in cols:
            acc = acc + col
        return acc

    def seg_max(v):
        out = torch.full((C + 1,), -torch.inf, device=dev)
        return out.scatter_reduce_(0, seg, v, reduce="amax",
                                   include_self=True)[:C]

    count, sx, sy, sxx, syy, sxy = seg_sums(torch.stack(
        [w, x * w, y * w, x ** 2 * w, y ** 2 * w, x * y * w]))
    big = 3.0e38
    minx = -seg_max(torch.where(valid_pt, -x, -big))
    miny = -seg_max(torch.where(valid_pt, -y, -big))
    maxx = seg_max(torch.where(valid_pt, x, -big))
    maxy = seg_max(torch.where(valid_pt, y, -big))

    cnt_safe = torch.clamp(count, min=1.0)
    cx = sx / cnt_safe
    cy = sy / cnt_safe
    # covariance with the n-1 divisor (the Eigen code divides by size()-1);
    # the fused multiply-adds are those XLA:CPU contracts the JAX graph
    # into, which matters where the sums cancel
    nm1 = torch.clamp(count - 1.0, min=1.0)
    cov_xx = fma32(-(count * cx), cx, sxx) / nm1
    cov_yy = fma32(-(count * cy), cy, syy) / nm1
    cov_xy = fma32(-(count * cx), cy, sxy) / nm1
    tr2 = (cov_xx + cov_yy) * 0.5
    half = (cov_xx - cov_yy) * 0.5
    det_term = torch.sqrt(torch.clamp(fma32(cov_xy, cov_xy, half * half),
                                      min=0.0))
    lam_min = tr2 - det_term
    lam_max = tr2 + det_term
    linearity = torch.where((count >= 3) & (lam_min + lam_max >= 1e-6),
                            lam_min / (lam_max + 1e-6), 0.0)

    dx = maxx - minx
    dy = maxy - miny
    length = torch.sqrt(fma32(dx, dx, dy * dy))
    valid = count > 0

    is_wall = ((linearity < cfg.wal_lin_max) & (length > cfg.wal_len_min)
               & (count > cfg.wal_nmp_min))
    is_obj = (length < cfg.obj_len_max) & (count > cfg.obj_nmp_min)
    classes = torch.where(~valid, INVALID,
                          torch.where(is_wall, WALL,
                                      torch.where(is_obj, OBJECT, UNKNOWN)))
    return ClusterStats(
        count=count.to(torch.int32),
        min_xy=torch.stack([minx, miny], dim=-1),
        max_xy=torch.stack([maxx, maxy], dim=-1),
        centroid=torch.stack([cx, cy], dim=-1),
        length=torch.where(valid, length, 0.0),
        linearity=linearity,
        valid=valid,
        labels=labels,
        classes=classes.to(torch.int32),
    )


def scan_to_points(ranges: torch.Tensor, angles: torch.Tensor,
                   range_max: float, max_range_ratio: float = 0.9):
    """Polar scan -> (N, 2) points and validity (lidar_cluster_publisher
    uses returns below range_max * max_range_ratio)."""
    valid = (torch.isfinite(ranges) & (ranges > 0)
             & (ranges < range_max * max_range_ratio))
    # sin and cos correctly rounded to f32 (from f64): the same on every
    # device, and within one ulp of XLA's
    a = angles.double()
    x = ranges * torch.cos(a).to(torch.float32)
    y = ranges * torch.sin(a).to(torch.float32)
    pts = torch.stack([torch.where(valid, x, 0.0),
                       torch.where(valid, y, 0.0)], dim=-1)
    return pts, valid


def cluster_points_host(pts, gap_threshold: float, max_clusters: int = 64):
    """Host numpy mirror of ``cluster_scan_points`` for all-valid points
    without wrap-around merging — the control plane's case
    (3_multi_object_goal_selector.cpp:178-190 clusters tiny per-tick change
    clouds). Identical labels/num to the JAX package's kernel
    (parity-tested there); runs in microseconds on the host, twice per
    perception tick (one call per tracker).
    """
    pts = np.asarray(pts, np.float32).reshape(-1, 2)
    n = len(pts)
    if n == 0:
        return np.zeros(0, np.int32), 0
    d = np.hypot(pts[1:, 0] - pts[:-1, 0], pts[1:, 1] - pts[:-1, 1])
    # compare in f32 like the JAX package's device kernel (a float64
    # compare could flip the ulp boundary case and break label parity)
    gap = np.concatenate([[True], d > np.float32(gap_threshold)])
    labels = np.minimum(np.cumsum(gap) - 1,
                        max_clusters - 1).astype(np.int32)
    return labels, min(int(gap.sum()), max_clusters)


def cluster_points_spatial_host(pts, distance_threshold: float,
                                max_clusters: int = 64):
    """Order-independent single-linkage clustering: points within
    ``distance_threshold`` of each other (transitively) share a label.

    The reference's goal selector gap-clusters the change-cell cloud in
    *received order* (3_multi_object_goal_selector.cpp:178-190), but that
    cloud is an unordered_map dump (diff_node.cpp:188-204) — with cells
    from two distant objects interleaved (our evidence-grid compaction
    emits row-major order), consecutive-pair clustering shatters each
    object into per-row fragments that the wall-thickness filter then
    rejects. Single-linkage implements the selector's documented intent
    ("merge change clouds closer than the threshold into one object")
    independent of cloud order; on scan-ordered input with separated
    objects it produces the same partition as ``cluster_points_host``.

    Labels are renumbered by first occurrence (matching the sequential
    labeling on well-ordered input) and clamped to ``max_clusters`` like
    the kernel. Host-side: the tracker clusters <= a few hundred cells.
    """
    pts = np.asarray(pts, np.float32).reshape(-1, 2)
    n = len(pts)
    if n == 0:
        return np.zeros(0, np.int32), 0
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    adj = d2 <= np.float32(distance_threshold) ** 2      # includes self
    # connected components by iterative min-label propagation
    labels = np.arange(n)
    while True:
        nxt = np.where(adj, labels[None, :], n).min(axis=1)
        if np.array_equal(nxt, labels):
            break
        labels = nxt
    # renumber by first occurrence, clamp overflow like the kernel
    _, first_idx, inv = np.unique(labels, return_index=True,
                                  return_inverse=True)
    order = np.argsort(np.argsort(first_idx))
    labels = np.minimum(order[inv], max_clusters - 1).astype(np.int32)
    return labels, min(len(first_idx), max_clusters)
