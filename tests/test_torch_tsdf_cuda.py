"""The batched fusion schedule of otslam_tpu_torch/kernels/tsdf_cuda.py.

On the CPU the kernel wrappers take their plain versions; the tests here
hold the schedule around them (creation recurrence, CSR work list) against
the JAX package and against its own definition. The kernels themselves are
compared with their plain versions by tests/test_torch_cuda.py (on a CUDA
GPU) and, at full size, by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otslam_tpu.kernels.tsdf_pallas import _cumulative_or
from otslam_tpu_torch.config import TSDFConfig
from otslam_tpu_torch.kernels import tsdf_block as ttb
from otslam_tpu_torch.kernels import tsdf_cuda as tc
from torch_parity import T_SMALL, capture

VOL = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, dims=(64, 64, 32),
                 origin=(0.86, -0.14, -0.02))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_creation_recurrence_matches_cumulative_or(seed):
    rng = np.random.default_rng(seed)
    band = rng.random((24, 300)) < 0.05
    visible = rng.random((24, 300)) < 0.5
    created_in = rng.random(300) < 0.1
    created_j = np.asarray(_cumulative_or(jnp.asarray(band))) | created_in
    created, active = tc.created_and_active(
        torch.from_numpy(band), torch.from_numpy(visible),
        torch.from_numpy(created_in))
    np.testing.assert_array_equal(created.numpy(), created_j)
    np.testing.assert_array_equal(active.numpy(), created_j & visible)


@pytest.mark.parametrize("density", [0.0, 0.02, 0.5])
def test_worklist_is_the_exact_csr_of_the_mask(density):
    rng = np.random.default_rng(7)
    active = rng.random((16, 500)) < density
    ids, ptr, frames = tc.active_worklist(torch.from_numpy(active))
    ids, ptr, frames = ids.numpy(), ptr.numpy(), frames.numpy()
    assert ptr[0] == 0 and len(ptr) == len(ids) + 1
    assert np.all(np.diff(ids) > 0)
    rebuilt = np.zeros_like(active)
    for a, b in enumerate(ids):
        fr = frames[ptr[a]:ptr[a + 1]]
        assert len(fr) > 0 and np.all(np.diff(fr) > 0)
        rebuilt[fr, b] = True
    np.testing.assert_array_equal(rebuilt, active)


def test_empty_batch_leaves_the_volume():
    vol = ttb.make_block_volume(VOL, device="cpu")
    out = tc.integrate_frames_cuda(
        vol, torch.zeros((0, 120, 160)), torch.zeros((0, 120, 160, 3)),
        torch.zeros((0, 4, 4)), T_SMALL)
    assert out is vol and not vol.created.any()


def test_dead_row_restored_and_cpu_never_launches():
    depths, colors, exts = (torch.from_numpy(a) for a in capture(3))
    vol = ttb.make_block_volume(VOL, device="cpu")
    vol.tsdf[-1] = 5.0                     # a dirtied dead row
    launches = (tc.classify_blocks.launches, tc.fuse_blocks.launches)
    ttb.integrate_frames_sparse(vol, depths, colors, exts, T_SMALL)
    assert (tc.classify_blocks.launches, tc.fuse_blocks.launches) == launches
    assert vol.weight.sum() > 0
    assert float(vol.tsdf[-1].abs().sum()) == 0.0


@pytest.fixture(scope="module")
def small_capture():
    return tuple(torch.from_numpy(a) for a in capture(3))


def test_pack_rgb_is_the_little_endian_bytes_of_the_colour(small_capture):
    """K1's colour plane: pack_rgb of float colours (clamped to [0, 255]
    and truncated) and of bytes is the int32 whose little-endian bytes are
    R, G, B, 0, the layout csrc/tsdf_fuse.cu unpacks."""
    _, colors, _ = small_capture
    noisy = colors * 1.7 - 40.0 + 0.49             # out of range, fractions
    for c in (colors, noisy, colors.to(torch.uint8)):
        rgb = torch.clamp(c.to(torch.float32), 0, 255).to(torch.uint8)
        zero = torch.zeros(rgb.shape[:-1] + (1,), dtype=torch.uint8)
        want = torch.cat([rgb, zero], dim=-1).view(torch.int32)[..., 0]
        got = ttb.pack_rgb(c)
        assert got.dtype == torch.int32 and torch.equal(got, want)
    assert (ttb.pack_rgb(noisy) != ttb.pack_rgb(colors)).any()


def test_fuse_blocks_on_the_cpu_is_the_plain_version(small_capture):
    """On CPU tensors fuse_blocks is fuse_blocks_torch and launches
    nothing: the same volume, bit for bit."""
    depths, colors, exts = small_capture
    a = ttb.make_block_volume(VOL, device="cpu")
    b = ttb.make_block_volume(VOL, device="cpu")
    band, vis = tc.classify_blocks(a.meta, depths, exts, T_SMALL)
    _, active = tc.created_and_active(band, vis, a.created[:-1])
    ids, ptr, frames = tc.active_worklist(active)
    cpk = ttb.pack_rgb(colors)
    launches = tc.fuse_blocks.launches
    tc.fuse_blocks(a, ids, ptr, frames, depths, cpk, exts, T_SMALL)
    tc.fuse_blocks_torch(b, ids, ptr, frames, depths, cpk, exts, T_SMALL)
    assert tc.fuse_blocks.launches == launches and b.weight.sum() > 0
    for k in ("tsdf", "weight", "color"):
        assert torch.equal(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("n", [0, 2048, 6588])
def test_fuse_launch_shape(n):
    """One block of 512 / V = 256 threads per listed block (none, the f2m
    launch's 2048 blocks, the reconstruction's 6588)."""
    assert tc.VOXELS_PER_THREAD == 2
    assert tc.fuse_launch(n) == (n, 256)


@pytest.mark.parametrize("n", [-1, -6588, 2**31])
def test_fuse_launch_refuses_bad_shapes(n):
    with pytest.raises(ValueError, match="listed block count"):
        tc.fuse_launch(n)
