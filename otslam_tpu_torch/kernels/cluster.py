"""LiDAR point clustering on the host (counterpart of the host half of
otslam_tpu/kernels/cluster.py).

Gap clustering: consecutive points further apart than ``gap_threshold``
start a new cluster (lidar_cluster_publisher.cpp:151-183,
3_multi_object_goal_selector.cpp:178-190). The object tracker clusters the
per-tick change clouds, a few hundred cells at most, with these numpy
functions. The device functions of the JAX module (cluster_scan_points,
analyze_clusters, scan_to_points) serve only the initial-mapping workflow,
which is not ported yet.
"""

from __future__ import annotations

import numpy as np


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
