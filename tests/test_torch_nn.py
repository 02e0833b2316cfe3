"""otslam_tpu_torch nearest neighbour, chamfer eval and resampling vs
otslam_tpu (CPU; the port's plain path of kernel K3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otslam_tpu.eval.metrics import evaluate_map as j_evaluate_map
from otslam_tpu.kernels import nn as jnn
from otslam_tpu.kernels.sampling import resample_points as j_resample
from otslam_tpu_torch.eval.metrics import evaluate_map
from otslam_tpu_torch.kernels import nn as tnn
from otslam_tpu_torch.kernels.sampling import resample_points

N_SRC, N_DST = 3000, 4000


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(11)
    dst = rng.uniform(-1.0, 1.0, (N_DST, 3)).astype(np.float32)
    dst[100:200] = dst[:100]            # exact duplicates: lowest index wins
    src = (dst[rng.integers(0, N_DST, N_SRC)]
           + rng.normal(0, 0.01, (N_SRC, 3))).astype(np.float32)
    src[:50] = dst[:50]                 # zero distances, tied with 100..149
    smask = rng.random(N_SRC) > 0.05
    dmask = rng.random(N_DST) > 0.05
    dmask[:100] = True
    return src, dst, smask, dmask


def reference(src, dst, smask, dmask):
    """float64 (nearest squared distance, gap to the second nearest)."""
    d2 = ((src[:, None, :].astype(np.float64) - dst[None]) ** 2).sum(-1)
    d2[:, ~dmask] = np.inf
    part = np.partition(d2, 1, axis=1)
    return part[:, 0], part[:, 1] - part[:, 0]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_nn_distance_matches_jax(clouds, impl):
    src, dst, smask, dmask = clouds
    jd, ji = jnn.nn_distance(jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(smask), jnp.asarray(dmask),
                             with_index=True, impl=impl)
    td, ti = tnn.nn_distance(torch.from_numpy(src), torch.from_numpy(dst),
                             torch.from_numpy(smask), torch.from_numpy(dmask),
                             with_index=True)
    jd, ji, td, ti = (np.asarray(x) for x in (jd, ji, td, ti))
    best, gap = reference(src, dst, smask, dmask)
    # indices agree wherever the two nearest squared distances differ by
    # more than the JAX expansion's cancellation error (~1e-7 m^2 here)
    clear = smask & (gap > 1e-6)
    assert clear.mean() > 0.8         # 5 % masked, 5 % duplicated dst
    np.testing.assert_array_equal(ti[clear], ji[clear])
    same = smask & (ti == ji)
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-6, atol=1e-12)
    # at near ties both picks are within the tie gap of the true nearest
    np.testing.assert_allclose(td[smask] ** 2, best[smask], rtol=0,
                               atol=1e-6)
    assert np.all(td[~smask] == 0) and np.all(ti[~smask] == 0)
    # exact duplicates: the port takes the lowest index
    assert np.all(ti[:50][smask[:50]] == np.arange(50)[smask[:50]])


def test_nn_min_empty_and_fully_masked_destinations(clouds):
    src = torch.from_numpy(clouds[0][:10])
    dst = torch.from_numpy(clouds[1][:20])
    d2, idx = tnn.nn_min(src, dst, torch.zeros(20, dtype=torch.bool))
    assert torch.all(d2 == tnn.BIG) and torch.all(idx == 0)
    d = tnn.nn_distance(src, dst[:0])
    jd = jnn.nn_distance(jnp.asarray(clouds[0][:10]),
                         jnp.zeros((0, 3), jnp.float32))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_chamfer_and_evaluate_map_match_jax(clouds):
    src, dst, _, _ = clouds
    ja, jc = jnn.chamfer_metrics(jnp.asarray(src), jnp.asarray(dst))
    ta, tcm = tnn.chamfer_metrics(torch.from_numpy(src),
                                  torch.from_numpy(dst))
    # means over 3-4k f32 distances, summed in other orders
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    np.testing.assert_allclose(float(tcm), float(jc), rtol=1e-5)
    jm = j_evaluate_map(src, dst)
    tm = evaluate_map(src, dst, device="cpu")
    assert abs(tm.accuracy_cm - jm.accuracy_cm) <= 1e-3
    assert abs(tm.completeness_cm - jm.completeness_cm) <= 1e-3
    # the ICP-aligned protocol runs too (held against JAX in
    # test_torch_refine.py)
    tm_icp = evaluate_map(src, dst, use_icp=True, device="cpu")
    assert 0.0 < tm_icp.icp_fitness <= 1.0
    assert np.isfinite([tm_icp.accuracy_cm, tm_icp.completeness_cm]).all()


def test_resample_with_jax_draws_is_index_exact():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(5000, 3)).astype(np.float32)
    cols = rng.uniform(size=(5000, 3)).astype(np.float32)
    nrm = rng.normal(size=(5000, 3)).astype(np.float32)
    mask = np.arange(5000) < 4321
    key = jax.random.PRNGKey(3)
    jp, jc, jn = j_resample(key, jnp.asarray(pts), jnp.asarray(mask), 20000,
                            colors=jnp.asarray(cols), normals=jnp.asarray(nrm))
    draws = torch.tensor(np.asarray(jax.random.uniform(key, (20000,))))
    tp, tc_, tn = resample_points(torch.from_numpy(pts),
                                  torch.from_numpy(mask), 20000,
                                  colors=torch.from_numpy(cols),
                                  normals=torch.from_numpy(nrm), draws=draws)
    for a, b in ((tp, jp), (tc_, jc), (tn, jn)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_resample_with_generator_is_seeded_and_in_range():
    pts = torch.arange(300, dtype=torch.float32).reshape(100, 3)
    mask = torch.arange(100) < 60

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return resample_points(pts, mask, 1000, generator=g)[0]

    a, b = draw(0), draw(0)
    assert torch.equal(a, b) and not torch.equal(a, draw(1))
    assert float(a[:, 0].max()) <= 59 * 3       # only the 60 valid rows
    with pytest.raises(ValueError):
        resample_points(pts, mask, 10, draws=torch.zeros(9))


def test_merge_keys_order_by_d2_then_index():
    """The 64-bit key K3/K4 merge split launches by: its order is d2's
    (over +0, denormals, ordinary values, BIG and inf), then the index's,
    and it unpacks to what was packed."""
    d2 = torch.tensor([0.0, 1e-45, 1e-40, 1.2e-38, 1e-10, 0.25, 0.25, 3.0,
                       tnn.BIG, float("inf")], dtype=torch.float32)
    idx = torch.tensor([7, 5, 0, 3, 2**31 - 1, 9, 4, 0, 0, 1])
    keys = tnn.pack_keys(d2, idx)
    lex = sorted(range(len(d2)), key=lambda k: (float(d2[k]), int(idx[k])))
    assert torch.argsort(keys).tolist() == lex
    back_d2, back_idx = tnn.unpack_keys(keys)
    assert torch.equal(back_d2.view(torch.int32), d2.view(torch.int32))
    assert torch.equal(back_idx, idx)


def split_merge_mirror(src, dst, mask, splits):
    """The kernels' split launch in plain torch: each of `splits` blocks
    scans its slice of the destination (nothing in range gives (BIG, 0)),
    and the least packed key of each row wins."""
    m = dst.shape[0]
    per = -(-m // splits)
    keys = []
    for s in range(splits):
        lo, hi = min(s * per, m), min((s + 1) * per, m)
        d, i = tnn.nn_min_torch(src, dst[lo:hi], mask[lo:hi])
        if hi == lo:
            d = torch.full((src.shape[0],), tnn.BIG)
            i = torch.zeros(src.shape[0], dtype=torch.int64)
        keys.append(tnn.pack_keys(d, torch.where(d < tnn.BIG, i + lo, 0)))
    return tnn.unpack_keys(torch.stack(keys).amin(dim=0))


@pytest.mark.parametrize("splits", [1, 2, 7])
def test_split_merge_equals_the_full_scan(splits):
    """Split and merged by the key, the scan equals nn_min_torch bit for
    bit, on duplicated destinations at indices across every slice boundary
    and on rows whose only valid neighbours lie in one slice."""
    rng = np.random.default_rng(splits)
    m = 701
    dst = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    per = -(-m // splits)
    for s in range(1, splits):             # ties straddling each boundary
        dst[s * per] = dst[s * per - 1]
        dst[min(s * per + 3, m - 1)] = dst[2]
    edges = [s * per - 1 for s in range(1, splits)]
    src = np.concatenate([dst[:40], dst[edges].reshape(-1, 3),
                          rng.uniform(-1, 1, (300, 3))]).astype(np.float32)
    mask = rng.random(m) > 0.2
    mask[2] = True
    for e in edges:
        mask[e] = mask[e + 1] = True
    src_t, dst_t, mask_t = (torch.from_numpy(a) for a in (src, dst, mask))
    for mk in (mask_t, torch.zeros_like(mask_t)):
        d, i = split_merge_mirror(src_t, dst_t, mk, splits)
        dp, ip = tnn.nn_min_torch(src_t, dst_t, mk)
        assert torch.equal(d, dp) and torch.equal(i, ip)


@pytest.mark.parametrize("n, m, splits", [
    (100_000, 50_000, 1),        # the eval's chamfer: 391 tiles fill it
    (1440, 1694, 6),             # the localizer: 6 tiles, 256 dst a split
    (19_200, 19_456, 15),        # pair ICP: 75 tiles
    (50_000, 50_176, 6),         # the eval's GT alignment (K4)
])
def test_split_count_at_the_path_shapes(n, m, splits):
    """Splits on a 132-SM H100 at the shapes the paths launch."""
    assert tnn.split_count(n, m, 132) == splits
    assert tnn.split_count(0, m, 132) == 1
    assert tnn.split_count(n, 0, 132) == 1
