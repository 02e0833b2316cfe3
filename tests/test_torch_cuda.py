"""Kernels K1, K2, K3, K4, K5 of otslam_tpu_torch against their plain
PyTorch versions, on a CUDA GPU. Every test here is marked `cuda` and skips on a
machine without one; the same comparisons at the main path's full size are
phases of chip_smoke.py.

This file imports neither jax nor otslam_tpu, so it also runs where JAX is
not installed. The repository's tests/conftest.py imports jax, so there run
it without conftests:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import copy

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


def same_volume(a, b):
    return (torch.equal(a.tsdf, b.tsdf) and torch.equal(a.weight, b.weight)
            and torch.equal(a.color, b.color))


def fuse_both(base, ids, ptr, frames_, depths, colors, exts):
    """(kernel, plain) volumes: the work list fused into copies of `base`
    by K1 and by its plain version."""
    kv, pv = copy.deepcopy(base), copy.deepcopy(base)
    before = tc.fuse_blocks.launches
    cpk = ttb.pack_rgb(colors)
    tc.fuse_blocks(kv, ids, ptr, frames_, depths, cpk, exts, INTR)
    assert tc.fuse_blocks.launches == before + 1
    tc.fuse_blocks_torch(pv, ids, ptr, frames_, depths, cpk, exts, INTR)
    return kv, pv


def test_fuse_kernel_matches_plain(dev, frames):
    """K1 bit-identical to its plain version: tsdf, weight and colour."""
    depths, colors, exts = (x.to(dev) for x in frames)
    base = ttb.make_block_volume(VOL, dev)
    band, vis = tc.classify_blocks_torch(base.meta, depths, exts, INTR)
    _, active = tc.created_and_active(band, vis, base.created[:-1])
    ids, ptr, frames_ = tc.active_worklist(active)
    kv, pv = fuse_both(base, ids, ptr, frames_, depths, colors, exts)
    assert pv.weight.sum() > 0 and same_volume(kv, pv)
    with pytest.raises(ValueError, match="out of range"):
        tc.fuse_blocks(kv, ids + kv.num_blocks, ptr, frames_, depths,
                       ttb.pack_rgb(colors), exts, INTR)


def test_fuse_kernel_one_frame_into_a_volume_with_max_active(dev, frames):
    """The f2m shape: one frame fused into the volume of the frames before
    it, its active blocks capped at max_active, as integrate_frames_cuda
    caps them; bit-identical to the plain version."""
    depths, colors, exts = (x.to(dev) for x in frames)
    base = ttb.make_block_volume(VOL, dev)
    for i in range(5):
        ttb.integrate_frames_sparse(base, depths[i:i + 1], colors[i:i + 1],
                                    exts[i:i + 1], INTR, max_active=200)
    f = slice(5, 6)
    band, vis = tc.classify_blocks(base.meta, depths[f], exts[f], INTR)
    _, active = tc.created_and_active(band, vis, base.created[:-1])
    cap = int(active.sum()) * 2 // 3
    active &= torch.cumsum(active, dim=1) <= cap
    ids, ptr, frames_ = tc.active_worklist(active)
    assert ids.shape[0] == cap and base.weight.sum() > 0
    kv, pv = fuse_both(base, ids, ptr, frames_, depths[f], colors[f],
                       exts[f])
    assert same_volume(kv, pv) and not same_volume(kv, base)


@pytest.mark.parametrize("repeats", [1, 5])
def test_fuse_kernel_blocks_in_every_frame(dev, frames, repeats):
    """Blocks active in all 8 frames of the batch, and in all 40 of a batch
    that repeats them (more frames than K1 stages at once): bit-identical
    to the plain version."""
    depths, colors, exts = (x.to(dev).repeat(repeats, *[1] * (x.dim() - 1))
                            for x in frames)
    base = ttb.make_block_volume(VOL, dev)
    band, vis = tc.classify_blocks_torch(base.meta, depths, exts, INTR)
    listed = vis.any(dim=0).nonzero()[:, 0][::7]
    active = torch.zeros_like(vis)
    active[:, listed] = True
    ids, ptr, frames_ = tc.active_worklist(active)
    assert torch.all(ptr[1:] - ptr[:-1] == 8 * repeats)
    kv, pv = fuse_both(base, ids, ptr, frames_, depths, colors, exts)
    assert pv.weight.sum() > 0 and same_volume(kv, pv)


def test_fusion_on_the_card_matches_the_cpu_path(dev, frames):
    """The whole schedule with both kernels equals the plain CPU path bit
    for bit, uncapped and with max_active."""
    for cap in (None, 150):
        gpu = ttb.integrate_frames_sparse(ttb.make_block_volume(VOL, dev),
                                          *(x.to(dev) for x in frames), INTR,
                                          max_active=cap)
        cpu = ttb.integrate_frames_sparse(
            ttb.make_block_volume(VOL, device="cpu"), *frames, INTR,
            max_active=cap)
        assert torch.equal(gpu.created.cpu(), cpu.created)
        assert torch.equal(gpu.weight.cpu(), cpu.weight)
        assert torch.equal(gpu.tsdf.cpu(), cpu.tsdf)
        assert torch.equal(gpu.color.cpu(), cpu.color)


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


def split_clouds(case, sms):
    """(src, dst, mask) for the split-and-merge cases; `sms` sizes the
    eval case so its tiles alone fill the card (S = 1)."""
    rng = np.random.default_rng(len(case))
    n, m = {"localizer": (1440, 1694),
            "eval": (nn.BLOCKS_PER_SM * sms * nn.SRC_TILE + 1000, 4000)}.get(
                case, (3000, 1999))       # no multiple of the tile or stage
    dst = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    src = (dst[rng.integers(0, m, n)]
           + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    mask = np.ones(m, bool)
    if case == "masked":
        mask[:] = False
    if case == "ties":
        # equal points at indices on both sides of a split boundary
        per = -(-m // nn.split_count(n, m, sms))
        dst[per] = dst[per - 1]
        dst[per + 5] = dst[3]
        src[:10] = dst[per - 1]
        src[10:20] = dst[3]
    return src, dst, mask


@pytest.mark.parametrize("case", ["localizer", "eval", "ragged", "ties",
                                  "masked"])
def test_nn_kernels_split_and_merge_match_plain(dev, case):
    """K3 and K4 in both launch regimes (one block a tile, S = 1, and a
    split range merged by the 64-bit key, S > 1): d^2 and index
    bit-identical to the plain versions, lowest index on ties across a
    split boundary, (BIG, 0) with every destination masked, and K4 equal
    to K3 on every in-radius row."""
    sms = nn.sm_count(dev)
    src, dst, mask = split_clouds(case, sms)
    n, m = len(src), len(dst)
    splits = nn.split_count(n, m, sms)
    if case == "eval":
        assert splits == 1
    elif case in ("localizer", "ties"):
        assert splits > 1
    src, dst, mask = (torch.as_tensor(a, device=dev)
                      for a in (src, dst, mask))
    dk, ik = nn.nn_min(src, dst, mask)
    dp, ip = nn.nn_min_torch(src, dst, mask)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
    if case == "ties":
        per = -(-m // splits)
        assert torch.all(ik[:10] == per - 1) and torch.all(ik[10:20] == 3)
    if case == "masked":
        assert torch.all(dk == nn.BIG) and torch.all(ik == 0)
    # K4 on the clouds sorted on z, as ICP sorts them
    src = src[torch.argsort(src[:, 2], stable=True)]
    order = torch.argsort(dst[:, 2], stable=True)
    dst, mask = dst[order], mask[order]
    dstp, dmaskp, c0, c1 = nn.window_ranges(src, dst, mask, 0.1, 2)
    dk, ik = nn.nn_min_windowed(src, dstp, dmaskp, c0, c1)
    dp, ip = nn.nn_min_windowed_torch(src, dstp, dmaskp, c0, c1)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
    d3, i3 = nn.nn_min(src, dst, mask)
    inl = d3.sqrt() < 0.1
    assert torch.equal(dk[inl], d3[inl]) and torch.equal(ik[inl], i3[inl])


def test_windowed_nn_kernel_empty_ranges(dev):
    """K4 tiles whose chunk range is empty (c0 == c1) or inverted
    (c0 > c1) scan nothing and give (BIG, 0), as the plain version does,
    in a split launch."""
    src, dst = windowed_clouds(3000, 6000)
    src, dst = torch.as_tensor(src, device=dev), torch.as_tensor(dst,
                                                                 device=dev)
    mask = torch.ones(6000, dtype=torch.bool, device=dev)
    dstp, dmaskp, c0, c1 = nn.window_ranges(src, dst, mask, 0.1, 2)
    c1[::2] = c0[::2]
    c0[1] = c1[1] + 1
    assert nn.split_count(3000, dstp.shape[0], nn.sm_count(dev)) > 1
    dk, ik = nn.nn_min_windowed(src, dstp, dmaskp, c0, c1)
    dp, ip = nn.nn_min_windowed_torch(src, dstp, dmaskp, c0, c1)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
    tiles = torch.arange(3000, device=dev) // nn.SRC_TILE
    empty = (c1 <= c0)[tiles]
    assert torch.all(dk[empty] == nn.BIG) and torch.all(ik[empty] == 0)
    assert torch.all(dk[~empty] < nn.BIG)


def test_wrappers_refuse_mixed_devices(dev, frames):
    depths, _, exts = frames
    meta = ttb.make_block_volume(VOL, dev).meta
    with pytest.raises(ValueError, match="one CUDA device"):
        tc.classify_blocks(meta, depths.to(dev), exts, INTR)


RAY_VARIANTS = [{"lanes": n} for n in raycast.LANE_CHOICES]


@pytest.mark.parametrize("beams, poses", [(360, 1), (1440, 8), (1000, 5)])
def test_raycast_kernel_matches_plain(dev, beams, poses):
    """K5 against its plain version on random grids and poses (some off
    the map), at a beam count that is no multiple of 32 and at every lane
    count a ray: bit-identical step keys."""
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
    ps, po = raycast.ray_keys_torch(grid_t, cos_a, sin_a, xy, *args)
    for variant in RAY_VARIANTS:
        before = raycast.ray_keys.launches
        fs, fo = raycast.ray_keys(grid_t, cos_a, sin_a, xy, *args, **variant)
        assert raycast.ray_keys.launches == before + 1
        assert torch.equal(fs, ps) and torch.equal(fo, po), variant
    assert bool((fs < 160).any()) and bool((fo < 160).any())
    ranges = raycast.raycast_grid_fast(grid_t, 0.05, -0.7, -0.4,
                                       *torch.as_tensor(pose.T, device=dev),
                                       angles, 8.0)
    plain = raycast.raycast_grid(grid_t, 0.05, -0.7, -0.4,
                                 *torch.as_tensor(pose.T, device=dev),
                                 angles, 8.0)
    assert ranges.shape == (poses, beams) and torch.equal(ranges, plain)


@pytest.mark.parametrize("steps", [1, 37, 160])
def test_raycast_kernel_step_counts_and_chunk_edges(dev, steps):
    """K5 at S = 1 and at an S that is no multiple of any lane count, on
    rays that start off the map and enter it at every offset within a
    chunk (entry steps 0-40), and on rays that enter and leave a 3 x 3
    grid within one chunk, with and without an occupied cell in their
    way: keys bit-identical to the plain version at every lane count."""
    res, ox, oy = 0.05, -0.7, -0.4
    big = np.zeros((150, 190), np.int8)
    big[75, 120] = 100
    tiny = np.zeros((3, 3), np.int8)
    cases = []
    # rays along +x entering the big grid from the left after e + 0.25
    # cells; half of them hit the occupied cell in row 75
    e = np.arange(41, dtype=np.float32)
    rows = np.where(e % 2 == 0, 75.5, 40.5).astype(np.float32)
    cases.append((big, np.stack([ox - res * (e + 0.25),
                                 oy + res * rows], 1), 0.0))
    # rays crossing the 3 x 3 grid (origin 0, 0) in a few steps
    yy = np.array([0.025, 0.075, 0.125, 0.175, -0.02], np.float32)
    cases.append((tiny, np.stack([np.full(5, -0.2, np.float32), yy], 1),
                  0.0))
    tiny_occ = tiny.copy()
    tiny_occ[1, 2] = 100
    cases.append((tiny_occ, np.stack([np.full(5, -0.2, np.float32), yy], 1),
                  0.0))
    for grid, xy, yaw in cases:
        origin = (ox, oy) if grid is big else (0.0, 0.0)
        angles = torch.linspace(-0.02, 0.02, 24, device=dev)
        grid_t = torch.as_tensor(grid, device=dev)
        xy_t = torch.as_tensor(xy, device=dev).contiguous()
        cos_a, sin_a = raycast.beam_trig(
            torch.full((len(xy),), yaw, device=dev), angles)
        args = (grid_t, cos_a.contiguous(), sin_a.contiguous(), xy_t, res,
                *origin, steps)
        ps, po = raycast.ray_keys_torch(*args)
        for variant in RAY_VARIANTS:
            fs, fo = raycast.ray_keys(*args, **variant)
            assert torch.equal(fs, ps) and torch.equal(fo, po), variant
    assert steps == 1 or bool((po < steps).any())


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
    with pytest.raises(ValueError, match="lanes a ray"):
        raycast.ray_keys(grid, cos_a, cos_a, xy, 0.1, 0, 0, 5, lanes=4)


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
