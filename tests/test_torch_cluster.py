"""The device half of LiDAR clustering and the initial-mapping classifier of
the port against otslam_tpu (CPU).

Labels, cluster counts and classes are compared exactly, the statistics
within 1e-5 relative (2e-6 absolute for values near zero). On these
inputs they come out bit for bit: the segment sums run in the same order
in both packages, the port takes the fused multiply-adds XLA:CPU
contracts the covariance, eigenvalue and length arithmetic into, and its
correctly rounded sin/cos met XLA's on these beams (XLA's may differ by
one ulp elsewhere, moving a point by an ulp). The classifier's point sets
per class agree to 1e-6 m.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otslam_tpu.config import ClusterConfig as JCfg
from otslam_tpu.config import LidarConfig as JLidar
from otslam_tpu.kernels import cluster as jcl
from otslam_tpu.mapping.initial_mapping import \
    LidarClusterClassifier as JClassifier
from otslam_tpu.sim.sensors import render_lidar
from otslam_tpu.sim.world import cardboard_room
from otslam_tpu_torch.config import ClusterConfig, LidarConfig
from otslam_tpu_torch.kernels import cluster as tcl
from otslam_tpu_torch.mapping.initial_mapping import LidarClusterClassifier

LIDAR = dict(num_beams=360)
RTOL, ATOL = 1e-5, 2e-6


def angles(n=360):
    return np.linspace(0, 2 * np.pi, n, endpoint=False).astype(np.float32)


def both_labels(pts, mask, gap, **kw):
    jl, jn = jcl.cluster_scan_points(jnp.asarray(pts), jnp.asarray(mask),
                                     gap, **kw)
    tl, tn = tcl.cluster_scan_points(torch.from_numpy(pts),
                                     torch.from_numpy(mask), gap, **kw)
    assert tl.dtype == torch.int32 and tn.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert int(tn) == int(jn)
    return tl, int(tn)


def assert_stats_equal(t, j):
    for name in ("count", "valid", "labels", "classes"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    for name in ("min_xy", "max_xy", "centroid", "length", "linearity"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def both_stats(pts, labels, **cfg):
    j = jcl.analyze_clusters(jnp.asarray(pts), jnp.asarray(labels),
                             JCfg(**cfg))
    t = tcl.analyze_clusters(torch.from_numpy(pts),
                             torch.as_tensor(labels, dtype=torch.int32),
                             ClusterConfig(**cfg))
    assert_stats_equal(t, j)
    return t


def test_gap_clustering_and_stats():
    pts = np.array([[0.0, 0], [0.1, 0], [0.2, 0],
                    [2.0, 0], [2.1, 0.1], [2.2, 0]], np.float32)
    labels, num = both_labels(pts, np.ones(6, bool), 0.4,
                              merge_wraparound=False)
    assert num == 2
    np.testing.assert_array_equal(labels.numpy(), [0, 0, 0, 1, 1, 1])
    st = both_stats(pts, labels.numpy(), max_clusters=8)
    assert int(st.count[0]) == 3 and int(st.count[1]) == 3
    np.testing.assert_allclose(st.centroid[0].numpy(), [0.1, 0.0], atol=1e-6)
    np.testing.assert_allclose(float(st.length[0]), 0.2, atol=1e-6)
    assert (st.classes[2:].numpy() == tcl.INVALID).all()


def test_random_scans_match_jax(rng):
    """Random polar scans with a fifth of the beams invalid, with and
    without the wrap-around merge: labels, counts and every statistic."""
    for n in (1, 2, 7, 64, 360):
        r = rng.uniform(0.5, 4.0, n).astype(np.float32)
        mask = rng.uniform(size=n) > 0.2
        a = angles(n)
        pts = np.stack([r * np.cos(a), r * np.sin(a)], -1).astype(np.float32)
        for wrap in (False, True):
            labels, _ = both_labels(pts, mask, 0.3, merge_wraparound=wrap)
            both_stats(pts, labels.numpy(), max_clusters=64, obj_nmp_min=1)


def test_host_mirror_matches_device(rng):
    """cluster_points_host (the tracker's path) gives the device function's
    labels and count on all-valid points without the wrap-around merge."""
    for n in (1, 2, 7, 64, 200):
        pts = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
        hl, hn = tcl.cluster_points_host(pts, 0.4)
        tl, tn = both_labels(pts, np.ones(n, bool), 0.4,
                             merge_wraparound=False)
        assert hn == tn
        np.testing.assert_array_equal(hl, tl.numpy())


def test_invalid_points_break_adjacency():
    pts = np.array([[0.0, 0], [0.1, 0], [0.0, 0], [0.2, 0]], np.float32)
    mask = np.array([True, True, False, True])
    labels, num = both_labels(pts, mask, 0.4, merge_wraparound=False)
    # the invalid point is skipped: points 0, 1, 3 form one cluster
    assert num == 1
    assert labels[2] == 64            # invalid label = max_clusters
    # an all-invalid scan: no cluster, every label the invalid one
    labels, num = both_labels(pts, np.zeros(4, bool), 0.4)
    assert num == 0 and (labels.numpy() == 64).all()


def test_wraparound_merge():
    a = angles(60)
    pts = np.stack([np.cos(a), np.sin(a)], -1).astype(np.float32)
    labels, num = both_labels(pts, np.ones(60, bool), 0.2,
                              merge_wraparound=True)
    assert num == 1 and (labels.numpy() == 0).all()
    # a gap in the middle of the ring: two clusters before the merge, one
    # after it, the last cluster relabelled 0
    ring = pts.copy()
    ring[30:] *= 1.5
    labels, num = both_labels(ring, np.ones(60, bool), 0.2)
    assert num == 2
    np.testing.assert_array_equal(labels.numpy(), np.arange(60) >= 30)
    ring[45:] = pts[45:]
    labels, num = both_labels(ring, np.ones(60, bool), 0.2)
    assert num == 2 and (labels.numpy()[45:] == 0).all()


def test_sums_add_members_in_index_order(rng):
    """Each cluster's sums are its members' values added one at a time in
    index order from 0 (XLA:CPU's scatter order; the same elementwise adds
    on every device): the centroids equal a numpy f32 loop bit for bit,
    also with a wrapped-around tail in cluster 0."""
    C = 8
    pts = rng.normal(0, 4, (500, 2)).astype(np.float32)
    labels = np.sort(rng.integers(0, C + 1, 500)).astype(np.int32)
    labels[-40:] = 0
    st = tcl.analyze_clusters(torch.from_numpy(pts),
                              torch.from_numpy(labels),
                              ClusterConfig(max_clusters=C))
    sums = np.zeros((C, 2), np.float32)
    count = np.zeros(C, np.float32)
    for p, label in zip(pts, labels):
        if label < C:
            sums[label] += p
            count[label] += 1
    np.testing.assert_array_equal(st.centroid.numpy(),
                                  sums / np.maximum(count, 1)[:, None])


def test_overflow_at_max_clusters():
    """More gaps than max_clusters: labels clamp to C - 1, num to C; the
    wrap-around merge then folds the clamped last cluster into 0."""
    x = np.arange(20, dtype=np.float32)       # every neighbour 1 m apart
    pts = np.stack([x, np.zeros(20, np.float32)], -1)
    labels, num = both_labels(pts, np.ones(20, bool), 0.5, max_clusters=8,
                              merge_wraparound=False)
    assert num == 8
    np.testing.assert_array_equal(labels.numpy(),
                                  np.minimum(np.arange(20), 7))
    both_stats(pts, labels.numpy(), max_clusters=8)
    ring = np.stack([np.cos(angles(40)), np.sin(angles(40))], -1) * 0.5
    ring = ring.astype(np.float32)
    ring[::4] *= 3.0                          # 10 isolated beams
    labels, num = both_labels(ring, np.ones(40, bool), 0.2, max_clusters=8)
    assert num <= 8
    both_stats(ring, labels.numpy(), max_clusters=8)


def test_classification_wall_vs_object(rng):
    wall = np.stack([np.linspace(0, 3, 60), np.zeros(60)], -1)
    blob = rng.normal(0, 0.05, (15, 2)) + [5.0, 5.0]
    pts = np.concatenate([wall, blob]).astype(np.float32)
    labels = np.concatenate([np.zeros(60), np.ones(15)]).astype(np.int32)
    st = both_stats(pts, labels)
    assert int(st.classes[0]) == tcl.WALL
    assert int(st.classes[1]) == tcl.OBJECT


def test_scan_to_points_range_gate():
    r = np.array([1.0, 9.5, np.inf, 0.0, np.nan, 3.0], np.float32)
    a = np.array([0.0, 0.1, 0.2, 0.3, 0.4, 2.5], np.float32)
    jp, jv = jcl.scan_to_points(jnp.asarray(r), jnp.asarray(a), 10.0, 0.9)
    tp, tv = tcl.scan_to_points(torch.from_numpy(r), torch.from_numpy(a),
                                10.0, 0.9)
    np.testing.assert_array_equal(tv.numpy(),
                                  [True, False, False, False, False, True])
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)


def classify_both(cfg, ranges, pose):
    j = JClassifier(JCfg(**cfg), JLidar(**LIDAR)).classify(
        jnp.asarray(ranges), jnp.asarray(angles()), pose)
    t = LidarClusterClassifier(ClusterConfig(**cfg), LidarConfig(**LIDAR),
                               device="cpu").classify(ranges, angles(), pose)
    for k in ("wall", "object", "unknown"):
        assert t[k].dtype == np.float32 and t[k].shape == j[k].shape, k
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert_stats_equal(t["stats"], j["stats"])
    return t


def test_classifier_object_vs_walls():
    """The cardboard room from near the box with the initial-mapping
    profile: the box is the OBJECT, the closed wall ring one UNKNOWN."""
    pose = (0.3, 0.3, 0.2)
    r = np.asarray(render_lidar(cardboard_room(), *pose,
                                jnp.asarray(angles()), 0.3, 10.0))
    profile = ClusterConfig.initial_mapping_profile().__dict__
    out = classify_both(profile, r, pose)
    assert len(out["object"]) > 3
    c = out["object"].mean(axis=0)
    assert np.hypot(c[0] - 1.5, c[1] - 0.5) < 0.5
    assert len(out["unknown"]) > 100


def test_classifier_wall_segment():
    """A straight wall across the 0-degree wrap-around: WALL class with the
    node's default thresholds."""
    a = angles()
    r = np.full(360, np.inf, np.float32)
    deg = np.degrees(a)
    sel = (deg < 55) | (deg > 305)
    r[sel] = 2.0 / np.cos(a[sel])
    out = classify_both({}, r, (0.0, 0.0, 0.0))
    assert len(out["wall"]) > 100
    np.testing.assert_allclose(out["wall"][:, 0], 2.0, atol=0.02)


def test_classifier_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LidarClusterClassifier()
