"""Kernels K1, K2, K3, K4, K5 of otslam_tpu_torch against their plain
PyTorch versions, the mesh weld on the card against numpy's, and pair
ICP's fused kernels (csrc/icp_plane.cu) against its host loop, on a CUDA
GPU. Every test here is marked `cuda` and skips on a
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
from otslam_tpu_torch.utils.profiling import COUNTS
from torch_cases import MIP_CASES, MIP_SIZES, colours, mip_depth

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
    """K2 (with the mip pass before it) writes torch.bool band and
    visible, bit-identical to the plain version, for the whole batch and
    for one frame."""
    depths, _, exts = (x.to(dev) for x in frames)
    meta = ttb.make_block_volume(VOL, dev).meta
    for f in (slice(None), slice(5, 6)):
        keys = ("launches.otslam_depth_mips", "launches.otslam_classify")
        before = [COUNTS[k] for k in keys]
        band_k, vis_k = tc.classify_blocks(meta, depths[f], exts[f], INTR)
        band_p, vis_p = tc.classify_blocks_torch(meta, depths[f], exts[f],
                                                 INTR)
        assert [COUNTS[k] for k in keys] == [before[0] + 1, before[1] + 1]
        assert band_k.dtype == vis_k.dtype == torch.bool
        assert band_p.any() and torch.equal(band_k, band_p)
        assert torch.equal(vis_k, vis_p)


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("case", MIP_CASES)
def test_mip_kernel_matches_plain(dev, case, n):
    """The mip pass's table and global bounds bit-identical to the plain
    version at tile-aligned and ragged sizes, without depth, and with inf,
    negative and NaN pixels; then on rows that are not 16-byte aligned
    (scalar loads)."""
    d = torch.as_tensor(mip_depth(case, n, seed=n), device=dev)
    store = torch.empty(d.numel() + 1, device=dev)
    unaligned = store[1:].view(d.shape)
    unaligned.copy_(d)
    want = tc.depth_mips_torch(d)
    for depths in (d, unaligned):
        before = COUNTS["launches.otslam_depth_mips"]
        table, gbounds, th, tw = tc.depth_mips(depths)
        assert COUNTS["launches.otslam_depth_mips"] == before + 1
        assert (th, tw) == want[2:]
        assert torch.equal(table, want[0]) and torch.equal(gbounds, want[1])


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("case", MIP_CASES)
def test_pack_kernel_matches_plain(dev, case, n):
    """The colour pack bit-identical to tsdf_block.pack_rgb (values out of
    range and +-inf clamped), on whole frames and on a pixel list that
    starts one pixel in (not 16-byte aligned) and is no multiple of 4."""
    h, w = MIP_SIZES[case]
    c = torch.as_tensor(colours(n, h, w, seed=n), device=dev)
    for cols in (c, c.reshape(-1, 3)[1:]):
        before = COUNTS["launches.otslam_pack_rgb"]
        got = tc.pack_rgb(cols)
        assert COUNTS["launches.otslam_pack_rgb"] == before + 1
        assert got.dtype == torch.int32
        assert torch.equal(got, ttb.pack_rgb(cols))


def test_pack_kernel_packs_nan_as_zero(dev):
    """A NaN channel packs as 0 (the plain version's cast of a NaN has no
    defined value, so the equality tests leave NaN out)."""
    c = torch.tensor([[float("nan"), 7.9, 300.0],
                      [12.0, float("nan"), float("nan")]], device=dev)
    assert tc.pack_rgb(c).tolist() == [(255 << 16) | (7 << 8), 12]


def test_integration_launches_each_kernel_once(dev, frames):
    """One integrate_frames_cuda call on the card runs the mip pass, K2,
    the colour pack and K1 once each, and no plain pass."""
    counters = ["launches." + name for name in (
        "otslam_depth_mips", "otslam_classify", "otslam_pack_rgb",
        "otslam_fuse")]
    before = [COUNTS[k] for k in counters]
    vol = tc.integrate_frames_cuda(ttb.make_block_volume(VOL, dev),
                                   *(x.to(dev) for x in frames), INTR)
    assert [COUNTS[k] - b for k, b in zip(counters, before)] == [1] * 4
    assert vol.weight.sum() > 0


def same_volume(a, b):
    return (torch.equal(a.tsdf, b.tsdf) and torch.equal(a.weight, b.weight)
            and torch.equal(a.color, b.color))


def fuse_both(base, ids, ptr, frames_, depths, colors, exts):
    """(kernel, plain) volumes: the work list fused into copies of `base`
    by K1 and by its plain version."""
    kv, pv = copy.deepcopy(base), copy.deepcopy(base)
    before = COUNTS["launches.otslam_fuse"]
    cpk = ttb.pack_rgb(colors)
    tc.fuse_blocks(kv, ids, ptr, frames_, depths, cpk, exts, INTR)
    assert COUNTS["launches.otslam_fuse"] == before + 1
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
    before = COUNTS["launches.otslam_nn"]
    dk, ik = nn.nn_min(src, dst, mask)
    dp, ip = nn.nn_min_torch(src, dst, mask)
    assert COUNTS["launches.otslam_nn"] == before + 1
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
    before = COUNTS["launches.otslam_nn_window"]
    dk, ik = nn.nn_min_windowed(src, dstp, dmaskp, c0, c1)
    dp, ip = nn.nn_min_windowed_torch(src, dstp, dmaskp, c0, c1)
    assert COUNTS["launches.otslam_nn_window"] == before + 1
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
        before = COUNTS["launches.otslam_raycast"]
        fs, fo = raycast.ray_keys(grid_t, cos_a, sin_a, xy, *args, **variant)
        assert COUNTS["launches.otslam_raycast"] == before + 1
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


@pytest.fixture(scope="module")
def table_object(dev):
    """The recon.mesh benchmark's object of the most triangles: full_room's
    table on its capture circle, 9 VGA frames, with the benchmark's
    settings (program config, intrinsics, host FrameBatch)."""
    import json
    from pathlib import Path

    from benchmark.drivers.recon import program_config
    from benchmark.inputs.captures import make_captures
    from otslam_tpu_torch.pipeline.dataset import FrameBatch
    bench = Path(__file__).resolve().parents[1] / "benchmark"
    cfg = json.loads((bench / "configs/object_recon.json").read_text())
    traffic = json.loads((bench / "traffic/captures.mesh.json").read_text())
    traffic["objects"] = ["table_marble"]
    cap = make_captures(traffic, cfg["camera"], 2 ** 31 + 17,
                        dev)[0]["table_marble"]
    pcfg = program_config(cfg)
    batch = FrameBatch(cap.depths, cap.colors, cap.extrinsics, cap.poses,
                       [f"table_marble_{i + 1}.jpg"
                        for i in range(len(cap.depths))])
    return batch, PinholeIntrinsics.from_config(pcfg.camera), pcfg, \
        cfg["backend"]


@pytest.mark.parametrize("route", ["packed", "lexsort"])
def test_weld_on_the_card_matches_numpy(dev, table_object, route):
    """On the fused table: the card weld's keys, vertices, faces and
    colours equal numpy `_weld`'s of the same soup, normals within 1e-5
    (the card's atomic adds reorder the sums)."""
    from otslam_tpu_torch.kernels import marching as mt
    from otslam_tpu_torch.pipeline import reconstruct as rc
    batch, intr, pcfg, backend = table_object
    cfg = rc.auto_volume_config(batch, intr, pcfg)
    vol = rc.fuse_frames(batch.depths, batch.colors, batch.extrinsics, intr,
                         cfg, backend, densify=False, device=dev)
    soup = mt.extract_mesh_soup_block(vol, *mt.auto_mesh_block_config(vol))
    rows = soup[0][soup[2]].reshape(-1, 3)
    v = rows.cpu().numpy()
    assert len(v) > 500_000
    np.testing.assert_array_equal(mt._weld_keys(rows).cpu().numpy(),
                                  np.round(v / 1e-5).astype(np.int64))
    before = dict(COUNTS)
    got = mt._weld_mesh(*soup, extent=mt._extent(vol) if route == "packed"
                        else None)
    assert {r: COUNTS[f"weld.{r}"] - before.get(f"weld.{r}", 0)
            for r in ("packed", "lexsort")} == {
        "packed": int(route == "packed"), "lexsort": int(route == "lexsort")}
    want = mt._weld_mesh(*(a.cpu().numpy() for a in soup))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
    for k in range(3):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5)


def test_mesh_object_syncs_are_the_waits_pytorch_reports(dev, table_object):
    """One untraced mesh reconstruction of the table: `syncs` equals the
    synchronizing calls torch.cuda.set_sync_debug_mode reports, at most
    21, and the weld took the packed key."""
    import warnings

    from otslam_tpu_torch.pipeline import reconstruct as rc
    batch, intr, pcfg, backend = table_object

    def mesh():
        return rc.reconstruct_frames(batch, intr, pcfg, backend=backend,
                                     output="mesh", auto_origin=True,
                                     device=dev)
    mesh()                                           # warms up
    torch.cuda.synchronize()
    before = dict(COUNTS)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        del seen[:]             # the mode's own notice, the first time on
        try:
            res = mesh()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = [w for w in seen if "synchroniz" in str(w.message)]
    syncs = COUNTS["syncs"] - before["syncs"]
    assert syncs == len(waits) <= 21, [f"{w.filename}:{w.lineno}"
                                       for w in waits]
    assert COUNTS["weld.packed"] - before.get("weld.packed", 0) == 1
    assert COUNTS["weld.lexsort"] == before.get("weld.lexsort", 0)
    assert len(res.faces) > 100_000


# ---------------------------------------------------------------------------
# Pair ICP's fused kernels (kernels/icp.py icp_plane_annealed) against the
# plain host loop, both on the card: equal bit for bit
# ---------------------------------------------------------------------------

THRESHOLDS = (0.1, 0.05, 0.02)      # refine_trajectory's
BOX_THRESHOLDS = (0.05, 0.02, 0.01)  # the box's few-mm motion


def box_clouds(shift=(0.0012, -0.001, 0.0008), seed=4):
    """dst: a jittered lattice on a 0.5 x 0.4 x 0.3 m box's faces with
    outward normals; src: dst moved by -shift and a small turn, with 0.2 mm
    noise, 300 outliers 0.2 m off the surface, shuffled; a src mask drops
    5 % (float32, host)."""
    rng = np.random.default_rng(seed)
    half = np.array([0.25, 0.2, 0.15])
    pts, nrm = [], []
    for axis in range(3):
        u, v = [k for k in range(3) if k != axis]
        gu = np.arange(-half[u] + 0.012, half[u] - 0.006, 0.012)
        gv = np.arange(-half[v] + 0.012, half[v] - 0.006, 0.012)
        uu, vv = np.meshgrid(gu, gv, indexing="ij")
        for sign in (-1.0, 1.0):
            p = np.zeros((uu.size, 3))
            p[:, u], p[:, v] = uu.ravel(), vv.ravel()
            p[:, axis] = sign * half[axis]
            p[:, [u, v]] += rng.uniform(-0.001, 0.001, (uu.size, 2))
            n = np.zeros((uu.size, 3))
            n[:, axis] = sign
            pts.append(p)
            nrm.append(n)
    dst = np.concatenate(pts) + [1.5, 0.5, 0.15]
    nrm = np.concatenate(nrm)
    a = 0.003
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]])
    src = (dst - [1.5, 0.5, 0.15]) @ R.T + [1.5, 0.5, 0.15] - shift
    src = src + rng.normal(0, 0.0002, src.shape)
    src = np.concatenate([src, dst[:300] + 0.2 * nrm[:300]])
    src = src[rng.permutation(len(src))]
    smask = rng.random(len(src)) > 0.05
    return (src.astype(np.float32), dst.astype(np.float32),
            nrm.astype(np.float32), smask)


def covering(dst, axis=2):
    """A window of every chunk: the host loop takes K3, the fused loop
    K4 over the whole destination."""
    return -(-dst.shape[0] // nn.DST_CHUNK), axis


def host_loop(src, dst, nrm, smask, dmask, thresholds, window, **kw):
    """The plain annealed loop, icp_point_to_plane chained over the
    thresholds (refine._annealed_icp_plain), with each stage's
    iterations."""
    from otslam_tpu_torch.kernels.icp import icp_point_to_plane
    T = torch.eye(4, dtype=torch.float32, device=src.device)
    its = []
    for thr in thresholds:
        res = icp_point_to_plane(src, dst, nrm, threshold=thr, init=T,
                                 src_mask=smask, dst_mask=dmask,
                                 nn_window=window[0], nn_axis=window[1],
                                 **kw)
        T = res.transformation
        its.append(res.iterations)
    return res, its


def assert_loops_agree(src, dst, nrm, smask, dmask, thresholds, window,
                       **kw):
    """The fused kernels against the host loop: the transformation,
    fitness and RMSE bit for bit, every stage's iterations equal, and a
    second run the same. Returns (fused result, host iterations)."""
    from otslam_tpu_torch.kernels.icp import icp_plane_annealed
    want, its = host_loop(src, dst, nrm, smask, dmask, thresholds, window,
                          **kw)

    def fused():
        before = COUNTS["icp.iterations"]
        res = icp_plane_annealed(src, dst, nrm, thresholds, src_mask=smask,
                                 dst_mask=dmask, nn_window=window[0],
                                 nn_axis=window[1], **kw)
        return ([t.clone() for t in res[:3]],
                COUNTS["icp.iterations"] - before, res.iterations)
    got, total, last = fused()
    again, _, _ = fused()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for a, b in zip(got, want[:3]):
        assert torch.equal(a, b), float((a - b).abs().max())
    assert (total, last) == (sum(its), its[-1])
    return got, its


@pytest.fixture(scope="module")
def box_on_card(dev):
    src, dst, nrm, smask = box_clouds()
    return (torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev),
            torch.as_tensor(nrm, device=dev),
            torch.as_tensor(smask, device=dev))


@pytest.mark.parametrize("windowed", [False, True])
def test_icp_fused_matches_host_loop(dev, box_on_card, windowed):
    """The box clouds at the pair thresholds, through K4's windows (sized
    as the refiner sizes them) or over the whole destination."""
    src, dst, nrm, smask = box_on_card
    window = (nn.auto_nn_window(src.cpu().numpy(), dst.cpu().numpy(),
                                max(BOX_THRESHOLDS))
              if windowed else covering(dst))
    if windowed:
        assert window[0] * nn.DST_CHUNK < dst.shape[0]
    assert_loops_agree(src, dst, nrm, smask, None, BOX_THRESHOLDS, window,
                       max_iterations=15)


def test_icp_fused_converges_early(dev, box_on_card):
    """A pair whose stages converge within a few of their 30 iterations."""
    src, dst, nrm, smask = box_on_card
    _, its = assert_loops_agree(src, dst, nrm, smask, None, BOX_THRESHOLDS,
                                covering(dst), max_iterations=30)
    assert max(its) < 30


def test_icp_fused_runs_every_iteration(dev, box_on_card):
    """Criteria that never stop the loop: each stage runs all 15."""
    src, dst, nrm, smask = box_on_card
    _, its = assert_loops_agree(src, dst, nrm, smask, None, BOX_THRESHOLDS,
                                covering(dst), max_iterations=15,
                                relative_fitness=-1.0, relative_rmse=-1.0)
    assert its == [15, 15, 15]


def test_icp_fused_collapse_keeps_the_best_rmse_pose(dev):
    """Only 3 % of the source on the box, the rest 1 m away: the fitness
    ends below 0.05 and the iterate of least RMSE is returned."""
    src, dst, nrm, smask = box_clouds()
    src[len(src) * 3 // 100:, 0] += 1.0
    src, dst, nrm, smask = (torch.as_tensor(a, device=dev)
                            for a in (src, dst, nrm, smask))
    got, _ = assert_loops_agree(src, dst, nrm, smask, None, BOX_THRESHOLDS,
                                covering(dst), max_iterations=15)
    assert 0 < float(got[1]) < 0.05


def test_icp_fused_without_inliers(dev):
    """The source 1 m away: no inliers at any stage, the identity back."""
    src, dst, nrm, smask = (torch.as_tensor(a, device=dev) for a in
                            box_clouds(shift=(1.0, 0.0, 0.0)))
    got, its = assert_loops_agree(src, dst, nrm, smask, None,
                                  BOX_THRESHOLDS, covering(dst),
                                  max_iterations=15)
    assert float(got[1]) == 0.0 and its == [2, 2, 2]
    assert torch.equal(got[0], torch.eye(4, device=dev))


def grown(before, name):
    return COUNTS[name] - before.get(name, 0)


def smaller_box(box):
    """The box clouds with 700 source and 900 destination rows fewer."""
    src, dst, nrm, smask = box
    return src[:-700], dst[:-900], nrm[:-900], smask[:-700]


@pytest.mark.parametrize("case", ["capped", "one_step", "first_evaluation",
                                  "two_shapes"])
def test_icp_fused_graph_cases(dev, box_on_card, case):
    """The captured iteration at its edges, each run equal to the host
    loop: stages that end at max_iterations 3 and 1 (one replay a stage),
    stages that stop at their first evaluation (max_iterations 0: no step,
    so nothing is captured or replayed), and pairs of two shapes in turn
    (A, B, A), each shape with a graph of its own. Every iteration is one
    replay; a key of shapes and settings captures once, at its first
    pair's first step, and its later pairs replay that graph (A's key may
    be kept from the tests before)."""
    box = box_on_card
    runs = {"capped": [(box, 3)], "one_step": [(box, 1)],
            "first_evaluation": [(box, 0)],
            "two_shapes": [(box, 15), (smaller_box(box), 15), (box, 15)]}
    before = dict(COUNTS)
    steps = 0
    for (src, dst, nrm, smask), cap in runs[case]:
        _, its = assert_loops_agree(src, dst, nrm, smask, None,
                                    BOX_THRESHOLDS, covering(dst),
                                    max_iterations=cap)
        if case == "first_evaluation":
            assert its == [0, 0, 0]
        elif case != "two_shapes":
            assert cap in its
        steps += 2 * sum(its)       # assert_loops_agree runs it twice
    assert grown(before, "icp.graph_replays") == steps
    captures = grown(before, "icp.graph_captures")
    if case == "first_evaluation":
        assert captures == 0
    elif case == "two_shapes":
        assert 1 <= captures <= 2
    else:                           # a key no other test uses
        assert captures == 1


@pytest.fixture(scope="module")
def refine_capture(dev):
    """The recon.captures.refine cell's chair_1 at its VGA size and
    settings, its poses moved by the cell's planar localization error."""
    import json
    from pathlib import Path

    from benchmark.drivers.recon_refine import noisy, program_config
    from benchmark.inputs.captures import make_captures
    from otslam_tpu_torch.pipeline.dataset import FrameBatch
    bench = Path(__file__).resolve().parents[1] / "benchmark"
    cfg = json.loads(
        (bench / "configs/object_recon.refine_icp.json").read_text())
    traffic = json.loads((bench / "traffic/captures.refine.json").read_text())
    traffic["objects"] = ["chair_1"]
    seed = 2 ** 31 + 19
    truth = make_captures(traffic, cfg["camera"], seed, dev)[0]["chair_1"]
    cap = noisy(truth, np.random.default_rng([seed, 1]),
                traffic["pose_noise_xy_m"], traffic["pose_noise_yaw_rad"])
    pcfg = program_config(cfg)
    batch = FrameBatch(cap.depths, cap.colors, cap.extrinsics, cap.poses,
                       [f"chair_1_{i + 1}.jpg"
                        for i in range(len(cap.depths))])
    return batch, PinholeIntrinsics.from_config(pcfg.camera), pcfg


def test_icp_fused_on_a_capture_pair(dev, refine_capture):
    """Frames 1 onto 0 of a full_room capture, prepared as
    refine_trajectory prepares a pair, through refine._annealed_icp (the
    fused kernels) against refine._annealed_icp_plain's host loop."""
    from otslam_tpu_torch.core.se3 import invert_se3
    from otslam_tpu_torch.pipeline import refine
    batch, intr, _ = refine_capture
    depths = torch.as_tensor(batch.depths[:2], device=dev)
    pp, pn, pv = refine._frame_points_normals(depths[0], intr)
    cp, _, cv = refine._frame_points_normals(depths[1], intr)
    window = refine._pair_nn_window(cp, pp, max(THRESHOLDS))
    ext = np.asarray(batch.extrinsics, np.float64)
    src = refine._moved(cp, ext[0] @ invert_se3(ext[1]))
    assert_loops_agree(src, pp, pn, cv, pv, THRESHOLDS, window,
                       max_iterations=refine.PAIR_ICP_ITERATIONS)
    plain = refine._annealed_icp_plain(src, pp, pn, pv, cv, THRESHOLDS,
                                       window)
    res = refine._annealed_icp(src, pp, pn, pv, cv, THRESHOLDS, window)
    for a, b in zip(res, plain):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_icp_fused_counters_are_the_profiled_launches(dev, refine_capture):
    """One capture pair's fused ICP under torch.profiler, replaying the
    graph the same pair captured before: each of its kernels launches in
    the trace as often as its ``launches.*`` counter says, the graph's
    replays are the iterations (a rotation kernel each), K4's launches are
    the tallied scans, and the scans' rows and count are the host loop's
    for the same pair. The fused loop's cuBLAS kernels (the sgemm, its
    split-K reduce, the sgemv) are among those PyTorch runs for the host
    loop."""
    from benchmark.trace import Trace, kernel
    from otslam_tpu_torch.core.se3 import invert_se3
    from otslam_tpu_torch.pipeline import refine
    batch, intr, _ = refine_capture
    depths = torch.as_tensor(batch.depths[:2], device=dev)
    pp, pn, pv = refine._frame_points_normals(depths[0], intr)
    cp, _, cv = refine._frame_points_normals(depths[1], intr)
    window = refine._pair_nn_window(cp, pp, max(THRESHOLDS))
    ext = np.asarray(batch.extrinsics, np.float64)
    src = refine._moved(cp, ext[0] @ invert_se3(ext[1]))

    def traced(loop):
        before = dict(COUNTS)
        tracer = Trace(dev)
        tracer.start()
        with nn.window_tally() as tally:
            res = loop(src, pp, pn, pv, cv, THRESHOLDS, window)
        refine._pair_result(res, tally)
        summary = tracer.stop()
        return summary, {k: grown(before, k) for k in list(COUNTS)}
    refine._annealed_icp(src, pp, pn, pv, cv, THRESHOLDS, window)  # warms
    host, host_counts = traced(refine._annealed_icp_plain)
    fused, got = traced(refine._annealed_icp)
    names = {"otslam_icp_prep": "icp_prep_kernel",
             "otslam_nn_window": "nn_window_kernel",
             "otslam_icp_terms": "icp_terms_kernel",
             "otslam_icp_eval": "icp_eval_kernel",
             "otslam_icp_rotation": "icp_rotation_kernel",
             "otslam_icp_dt": "icp_dt_kernel"}
    for entry, name in names.items():
        assert kernel(fused, name)[0] == got["launches." + entry] > 0, name
    assert got["icp.graph_captures"] == 0    # the warm-up's graph replays
    assert got["icp.graph_replays"] == got["icp.iterations"] == \
        got["launches.otslam_icp_rotation"]
    assert got["nn.window_scans"] == got["launches.otslam_nn_window"] == \
        got["icp.iterations"] + len(THRESHOLDS)
    if window[0] * nn.DST_CHUNK < pp.shape[0]:     # the host loop's K4 too
        assert got["nn.window_scans"] == host_counts["nn.window_scans"]
        assert got["nn.window_pairs"] == host_counts["nn.window_pairs"] > 0
    blas = [k for k in fused["kernels"]
            if "gemm" in k or "splitKreduce" in k or "dot_kernel" in k]
    assert any("splitKreduce" in k for k in blas)
    assert set(blas) <= set(host["kernels"]), set(blas) - set(host["kernels"])


def test_refined_object_waits_are_counted(dev, refine_capture):
    """One untraced refined object: `syncs` equals the synchronizing calls
    set_sync_debug_mode reports, and inside each pair's ICP the one wait
    is the loop's condition, once an evaluation."""
    import warnings

    from otslam_tpu_torch.pipeline import reconstruct as rc
    from otslam_tpu_torch.pipeline import refine
    batch, intr, pcfg = refine_capture
    orig = refine._annealed_icp
    inside = []

    def counted(*a, **k):
        s0, i0 = COUNTS["syncs"], COUNTS["icp.iterations"]
        res = orig(*a, **k)
        inside.append((COUNTS["syncs"] - s0, COUNTS["icp.iterations"] - i0))
        return res

    def refined():
        return rc.reconstruct_frames(batch, intr, pcfg, auto_origin=True,
                                     refine="icp", device=dev)
    refined()                                        # warms up
    torch.cuda.synchronize()
    before = dict(COUNTS)
    refine._annealed_icp = counted
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        del seen[:]             # the mode's own notice, the first time on
        try:
            res = refined()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            refine._annealed_icp = orig
    waits = [w for w in seen if "synchroniz" in str(w.message)]
    syncs = COUNTS["syncs"] - before["syncs"]
    assert syncs == len(waits), [f"{w.filename}:{w.lineno}" for w in waits]
    assert len(inside) == len(batch.depths) - 1
    stages = len(THRESHOLDS)
    assert all(n == its + stages for n, its in inside), inside
    assert len(res.points) > 100
