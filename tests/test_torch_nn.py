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
