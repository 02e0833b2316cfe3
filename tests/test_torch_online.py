"""otslam_tpu_torch streaming fusion (sensor thread -> native ring ->
block-sparse fusion) vs otslam_tpu (CPU).

Mirrors tests/test_online.py. The JAX OnlineFusion reaches the interpreted
Pallas kernel (its tests are slow), so the drained volume is held against
JAX's XLA `integrate_frames_sparse` on the same frames, off the rounding
ties of tests/torch_parity.py with its tolerances, and against the port's
own batch `fuse_frames(..., densify=False)` with torch.equal.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otslam_tpu.config import TSDFConfig as JCfg
from otslam_tpu.kernels import tsdf_block as jtb
from otslam_tpu_torch.config import ReconstructionConfig, TSDFConfig
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.kernels import tsdf_cuda as tc
from otslam_tpu_torch.pipeline import OnlineFusion
from otslam_tpu_torch.pipeline.reconstruct import fuse_frames
from torch_parity import (J_SMALL, T_SMALL, ambiguous_voxels,
                          assert_fusion_matches, capture, voxel_centers)

INTR = PinholeIntrinsics(64, 48, 56.0, 56.0, 32.0, 24.0)
CFG = ReconstructionConfig(
    tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, dims=(64, 64, 64),
                    origin=(-0.64, -0.64, -0.64)))
# 2 cm voxels around the cardboard box (tests/test_torch_tsdf_block.py)
BOX = dict(voxel_size=0.02, sdf_trunc=0.08, dims=(64, 64, 32),
           origin=(0.86, -0.14, -0.02))


def frame(i):
    depth = np.full((48, 64), 0.4503 + 0.0051 * i, np.float32)
    color = np.full((48, 64, 3), 120, np.uint8)
    ext = np.eye(4, dtype=np.float32)
    return depth, color, ext


def stack(frames):
    return (np.stack([f[0] for f in frames]),
            np.stack([f[1] for f in frames]).astype(np.float32),
            np.stack([f[2] for f in frames]))


def batch_volume(frames, cfg=CFG, intr=INTR, max_active=2048):
    return fuse_frames(*stack(frames), intr, cfg, max_active=max_active,
                       densify=False, device="cpu")


def same_volume(a, b):
    for f in ("tsdf", "weight", "color", "created"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


class TestOnlineFusion:
    def test_push_drain_extract(self):
        of = OnlineFusion(CFG, INTR, batch=4, max_active=512, device="cpu")
        frames = [frame(i) for i in range(6)]
        for f in frames:
            of.push(*f)
        fused = of.drain()
        assert fused == 6  # a batch of 4, then the tail of 2 as it is
        assert of.frames_fused == 6 and of.dropped_frames == 0
        pts, cols, mask = of.extract(capacity=100_000)
        pts = pts[mask].numpy()
        assert len(pts) > 100
        # surface near the mean wall depth
        assert abs(np.median(pts[:, 2]) - 0.463) < 0.03
        # weights reflect all six frames at the wall band
        assert float(of.volume.weight.max()) == 6.0
        same_volume(of.volume, batch_volume(frames, max_active=512))

    def test_threaded_producer(self):
        of = OnlineFusion(CFG, INTR, ring_capacity=32, batch=4,
                          max_active=512, device="cpu")
        n = 12

        def produce():
            for i in range(n):
                of.push(*frame(i))

        t = threading.Thread(target=produce)
        t.start()
        total = 0
        while t.is_alive() or len(of.ring):
            total += of.drain(max_batches=1)
        t.join(60)
        assert not t.is_alive()
        total += of.drain()
        assert total + of.dropped_frames == n
        assert of.frames_fused == total

    def test_incremental_equals_batch(self):
        """Streaming in two drains == one batch (order preserved), bit for
        bit, and within the stated tolerances of JAX's XLA fusion."""
        of = OnlineFusion(CFG, INTR, batch=4, max_active=512, device="cpu")
        frames = [frame(i) for i in range(8)]
        for f in frames[:4]:
            of.push(*f)
        of.drain()
        for f in frames[4:]:
            of.push(*f)
        of.drain()
        same_volume(of.volume, batch_volume(frames, max_active=512))
        d, c, e = stack(frames)
        ref = jtb.integrate_frames_sparse(
            jtb.make_block_volume(JCfg(**CFG.tsdf.__dict__)), jnp.asarray(d),
            jnp.asarray(c), jnp.asarray(e), INTR, max_active=512)
        np.testing.assert_allclose(of.volume.tsdf.numpy(),
                                   np.asarray(ref.tsdf), atol=1e-6)
        np.testing.assert_array_equal(of.volume.weight.numpy(),
                                      np.asarray(ref.weight))

    def test_small_session_smoke(self):
        of = OnlineFusion(CFG, INTR, batch=2, max_active=256, device="cpu")
        for i in range(2):
            of.push(*frame(i))
        assert of.drain() == 2
        pts, cols, mask = of.extract(capacity=50_000)
        assert int(mask.sum()) > 100
        assert float(of.volume.weight.max()) == 2.0


@pytest.fixture(scope="module")
def box_frames():
    """The 8-frame 160x120 capture circle, colours as the ring carries
    them (uint8)."""
    d, c, e = capture(8)
    return d, c.astype(np.uint8), e


def cap_binding(depths, exts, cfg):
    """A max_active that binds on some frames of this capture."""
    from otslam_tpu_torch.kernels.tsdf_block import make_block_volume
    meta = make_block_volume(cfg, device="cpu").meta
    band, vis = tc.classify_blocks(meta, torch.from_numpy(depths),
                                   torch.from_numpy(exts), T_SMALL)
    _, active = tc.created_and_active(
        band, vis, torch.zeros(band.shape[1], dtype=torch.bool))
    return int(active.sum(dim=1).max()) * 2 // 3


@pytest.mark.parametrize("cap", ["none", "binding"])
@pytest.mark.parametrize("batch", [3, 8])
def test_capture_stream_matches_batch_and_jax(box_frames, batch, cap):
    """The capture pushed and drained in micro-batches of `batch` (a tail
    of 2 at batch 3): torch.equal to one batch fusion, and JAX's XLA
    block-sparse fusion off the rounding ties."""
    depths, colors, exts = box_frames
    cfg = ReconstructionConfig(tsdf=TSDFConfig(**BOX))
    k = None if cap == "none" else cap_binding(depths, exts, cfg.tsdf)
    of = OnlineFusion(cfg, T_SMALL, ring_capacity=8, batch=batch,
                      max_active=k, device="cpu")
    for f in zip(depths, colors, exts):
        of.push(*f)
    assert of.drain() == 8 and of.dropped_frames == 0
    frames = list(zip(depths, colors, exts))
    same_volume(of.volume, batch_volume(frames, cfg, T_SMALL, k))
    jvol = jtb.integrate_frames_sparse(
        jtb.make_block_volume(JCfg(**BOX)), jnp.asarray(depths),
        jnp.asarray(colors.astype(np.float32)), jnp.asarray(exts), J_SMALL,
        max_active=k or 256)
    amb = ambiguous_voxels(voxel_centers(of.volume.meta), depths, exts,
                           T_SMALL, of.volume.sdf_trunc)
    amb[-1] = False                      # dead row: zero in both
    np.testing.assert_array_equal(of.volume.created.numpy(),
                                  np.asarray(jvol.created))
    assert_fusion_matches(np.asarray(jvol.weight), np.asarray(jvol.tsdf),
                          np.asarray(jvol.color), of.volume.weight.numpy(),
                          of.volume.tsdf.numpy(), of.volume.color.numpy(),
                          amb)
