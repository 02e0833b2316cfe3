"""Kernels K1, K2, K3, K4, K5 of otslam_tpu_torch against their plain
PyTorch versions, on a CUDA GPU. Every test here is marked `cuda` and skips on a
machine without one; the same comparisons at the main path's full size are
phases of chip_smoke.py.

This file imports neither jax nor otslam_tpu, so it also runs where JAX is
not installed. The repository's tests/conftest.py imports jax, so there run
it without conftests:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from otslam_tpu_torch.config import TSDFConfig
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.kernels import nn, raycast, tsdf_cuda as tc
from otslam_tpu_torch.kernels import tsdf_block as ttb
from otslam_tpu_torch.sim.sensors import look_at_pose, render_rgbd
from otslam_tpu_torch.sim.world import cardboard_room

pytestmark = pytest.mark.cuda

INTR = PinholeIntrinsics(160, 120, 141.400225, 141.400225, 80.5, 60.5)
VOL = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, dims=(64, 64, 32),
                 origin=(0.86, -0.14, -0.02))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def frames():
    """8 frames of a capture circle around the cardboard box (CPU)."""
    c = np.array([1.5, 0.5, 0.15])
    ds, cs, es = [], [], []
    for i in range(8):
        a = 2 * np.pi * i / 8
        pose = look_at_pose([c[0] + np.cos(a), c[1] + np.sin(a), 0.5], c)
        d, col = render_rgbd(cardboard_room(), pose, INTR, far=5.0,
                             device="cpu")
        ds.append(torch.where(d <= 3.0, d, 0.0))
        cs.append(col)
        es.append(torch.as_tensor(np.linalg.inv(pose), dtype=torch.float32))
    return torch.stack(ds), torch.stack(cs), torch.stack(es)


def test_classify_kernel_matches_plain(dev, frames):
    depths, _, exts = (x.to(dev) for x in frames)
    meta = ttb.make_block_volume(VOL, dev).meta
    before = tc.classify_blocks.launches
    band_k, vis_k = tc.classify_blocks(meta, depths, exts, INTR)
    band_p, vis_p = tc.classify_blocks_torch(meta, depths, exts, INTR)
    assert tc.classify_blocks.launches == before + 1
    assert band_p.any() and torch.equal(band_k, band_p)
    assert torch.equal(vis_k, vis_p)


def test_fuse_kernel_matches_plain(dev, frames):
    depths, colors, exts = (x.to(dev) for x in frames)
    kv = ttb.make_block_volume(VOL, dev)
    pv = ttb.make_block_volume(VOL, dev)
    band, vis = tc.classify_blocks_torch(kv.meta, depths, exts, INTR)
    _, active = tc.created_and_active(band, vis, kv.created[:-1])
    ids, ptr, frames_ = tc.active_worklist(active)
    cpk = ttb.pack_rgb(colors)
    tc.fuse_blocks(kv, ids, ptr, frames_, depths, cpk, exts, INTR)
    tc.fuse_blocks_torch(pv, ids, ptr, frames_, depths, cpk, exts, INTR)
    assert pv.weight.sum() > 0 and torch.equal(kv.weight, pv.weight)
    assert float((kv.tsdf - pv.tsdf).abs().max()) <= 1e-5
    assert float((kv.color - pv.color).abs().max()) <= 1e-3
    with pytest.raises(ValueError, match="out of range"):
        tc.fuse_blocks(kv, ids + kv.num_blocks, ptr, frames_, depths, cpk,
                       exts, INTR)


def test_fusion_on_the_card_matches_the_cpu_path(dev, frames):
    """The whole schedule with both kernels equals the plain CPU path."""
    gpu = ttb.integrate_frames_sparse(ttb.make_block_volume(VOL, dev),
                                      *(x.to(dev) for x in frames), INTR)
    cpu = ttb.integrate_frames_sparse(
        ttb.make_block_volume(VOL, device="cpu"), *frames, INTR)
    assert torch.equal(gpu.created.cpu(), cpu.created)
    assert torch.equal(gpu.weight.cpu(), cpu.weight)
    assert float((gpu.tsdf.cpu() - cpu.tsdf).abs().max()) <= 1e-5
    assert float((gpu.color.cpu() - cpu.color).abs().max()) <= 1e-3


def test_nn_kernel_matches_plain(dev):
    rng = np.random.default_rng(11)
    dst = rng.uniform(-1, 1, (5000, 3)).astype(np.float32)
    dst[100:200] = dst[:100]                # exact ties: lowest index wins
    src = (dst[rng.integers(0, 5000, 3000)]
           + rng.normal(0, 0.01, (3000, 3))).astype(np.float32)
    mask = rng.random(5000) > 0.05
    src, dst, mask = (torch.as_tensor(a, device=dev)
                      for a in (src, dst, mask))
    before = nn.nn_min.launches
    dk, ik = nn.nn_min(src, dst, mask)
    dp, ip = nn.nn_min_torch(src, dst, mask)
    assert nn.nn_min.launches == before + 1
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
    d_all, i_all = nn.nn_min(src, dst, torch.zeros_like(mask))
    assert torch.all(d_all == nn.BIG) and torch.all(i_all == 0)


def windowed_clouds(n, m, seed=5):
    """src and dst sorted on z, as ICP sorts them for the windowed scan."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    dst = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    dst[100:200] = dst[:100]                # exact ties: lowest index wins
    return src[np.argsort(src[:, 2])], dst[np.argsort(dst[:, 2])]


@pytest.mark.parametrize("case", ["sorted", "unsorted", "masked",
                                  "ragged"])
def test_windowed_nn_kernel_matches_plain(dev, case):
    """K4 against its plain version: bit-identical d^2 and index on every
    row, on sorted and unsorted destinations, a fully masked one, and a
    source whose length is no multiple of the 256-row tile."""
    n = 3000 if case == "ragged" else 2816
    src, dst = windowed_clouds(n, 6000)
    if case == "unsorted":
        dst = dst[np.random.default_rng(1).permutation(len(dst))]
    mask = np.ones(len(dst), bool)
    if case == "masked":
        mask[:] = False
    src, dst, mask = (torch.as_tensor(a, device=dev)
                      for a in (src, dst, mask))
    dstp, dmaskp, c0, c1 = nn.window_ranges(src, dst, mask, 0.1, 2)
    spans = c1 - c0
    if case == "unsorted":
        assert torch.all(spans == dstp.shape[0] // nn.DST_CHUNK)
    else:
        assert int(spans.max()) < dstp.shape[0] // nn.DST_CHUNK
    before = nn.nn_min_windowed.launches
    dk, ik = nn.nn_min_windowed(src, dstp, dmaskp, c0, c1)
    dp, ip = nn.nn_min_windowed_torch(src, dstp, dmaskp, c0, c1)
    assert nn.nn_min_windowed.launches == before + 1
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
    if case == "masked":
        assert torch.all(dk == nn.BIG) and torch.all(ik == 0)
        return
    # against the full scan (K3): exact wherever the NN is within radius
    d3, i3 = nn.nn_min(src, dst, mask)
    inl = d3.sqrt() < 0.1
    assert inl.any()
    assert torch.equal(dk[inl], d3[inl]) and torch.equal(ik[inl], i3[inl])
    assert torch.all(dk[~inl].sqrt() >= 0.1)


def test_windowed_nn_refuses_bad_operands(dev):
    src, dst = windowed_clouds(512, 2048)
    src, dst = torch.as_tensor(src, device=dev), torch.as_tensor(dst,
                                                                 device=dev)
    mask = torch.ones(2048, dtype=torch.bool, device=dev)
    dstp, dmaskp, c0, c1 = nn.window_ranges(src, dst, mask, 0.1, 2)
    with pytest.raises(ValueError, match="chunk-padded"):
        nn.nn_min_windowed(src, dstp[:-1], dmaskp[:-1], c0, c1)
    with pytest.raises(ValueError, match="one CUDA device"):
        nn.nn_min_windowed(src, dstp, dmaskp, c0.cpu(), c1)


def test_wrappers_refuse_mixed_devices(dev, frames):
    depths, _, exts = frames
    meta = ttb.make_block_volume(VOL, dev).meta
    with pytest.raises(ValueError, match="one CUDA device"):
        tc.classify_blocks(meta, depths.to(dev), exts, INTR)


@pytest.mark.parametrize("beams, poses", [(360, 1), (1440, 8), (1000, 5)])
def test_raycast_kernel_matches_plain(dev, beams, poses):
    """K5 against its plain version on random grids and poses (some off
    the map), at a beam count that is no multiple of 32: bit-identical
    step keys."""
    rng = np.random.default_rng(beams)
    grid = ((rng.random((150, 190)) < 0.02) * 100).astype(np.int8)
    angles = torch.as_tensor(np.sort(rng.uniform(0, 2 * np.pi, beams))
                             .astype(np.float32), device=dev)
    pose = rng.uniform([-2.0, -2.0, -np.pi], [11.0, 9.0, np.pi],
                       (poses, 3)).astype(np.float32)
    grid_t = torch.as_tensor(grid, device=dev)
    cos_a, sin_a = raycast.beam_trig(torch.as_tensor(pose[:, 2],
                                                     device=dev), angles)
    xy = torch.as_tensor(pose[:, :2], device=dev).contiguous()
    args = (0.05, -0.7, -0.4, 160)
    before = raycast.ray_keys.launches
    fs, fo = raycast.ray_keys(grid_t, cos_a, sin_a, xy, *args)
    ps, po = raycast.ray_keys_torch(grid_t, cos_a, sin_a, xy, *args)
    assert raycast.ray_keys.launches == before + 1
    assert torch.equal(fs, ps) and torch.equal(fo, po)
    assert bool((fs < 160).any()) and bool((fo < 160).any())
    ranges = raycast.raycast_grid_fast(grid_t, 0.05, -0.7, -0.4,
                                       *torch.as_tensor(pose.T, device=dev),
                                       angles, 8.0)
    plain = raycast.raycast_grid(grid_t, 0.05, -0.7, -0.4,
                                 *torch.as_tensor(pose.T, device=dev),
                                 angles, 8.0)
    assert ranges.shape == (poses, beams) and torch.equal(ranges, plain)


def test_raycast_refuses_bad_operands(dev):
    grid = torch.zeros((10, 10), dtype=torch.int8, device=dev)
    cos_a = torch.ones((1, 8), device=dev)
    xy = torch.zeros((1, 2), device=dev)
    with pytest.raises(ValueError, match="int8"):
        raycast.ray_keys(grid.float(), cos_a, cos_a, xy, 0.1, 0, 0, 5)
    with pytest.raises(ValueError, match="float32"):
        raycast.ray_keys(grid, cos_a.double(), cos_a.double(), xy, 0.1, 0,
                         0, 5)
    with pytest.raises(ValueError, match="one CUDA device"):
        raycast.ray_keys(grid, cos_a, cos_a, xy.cpu(), 0.1, 0, 0, 5)


def test_render_lidar_path_rows_equal_render_lidar_on_the_card(dev):
    from otslam_tpu_torch.sim.sensors import render_lidar, render_lidar_path
    rng = np.random.default_rng(3)
    angles = np.linspace(0, 2 * np.pi, 1440, endpoint=False).astype(
        np.float32)
    poses = rng.uniform([-4, -4, -np.pi], [4, 4, np.pi], (8, 3)).astype(
        np.float32)
    path = render_lidar_path(cardboard_room(), *poses.T, angles, device=dev)
    for k in range(8):
        one = render_lidar(cardboard_room(), *map(float, poses[k]), angles,
                           device=dev)
        assert torch.equal(path[k], one)
