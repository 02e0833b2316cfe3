"""otslam_tpu_torch block-sparse and dense TSDF vs otslam_tpu (CPU).

The port's classification must be bit-identical to the JAX package's, its
fusion exact off the rounding-ambiguous voxels (see torch_parity), and its
extraction equal in count and order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otslam_tpu.config import TSDFConfig as JCfg
from otslam_tpu.core import volume_io as jvio
from otslam_tpu.kernels import tsdf as jtsdf
from otslam_tpu.kernels import tsdf_block as jtb
from otslam_tpu.kernels import tsdf_pallas as jtp
from otslam_tpu_torch.config import TSDFConfig
from otslam_tpu_torch.core import volume_io as tvio
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.kernels import tsdf as ttsdf
from otslam_tpu_torch.kernels import tsdf_block as ttb
from otslam_tpu_torch.kernels import tsdf_cuda as tc
from torch_cases import MIP_CASES, mip_depth
from torch_parity import (J_SMALL, T_SMALL, ambiguous_voxels,
                          assert_fusion_matches, capture, voxel_centers)

# 2 cm voxels around the box: 64 x 64 x 32 cells = 256 blocks
VOL = dict(voxel_size=0.02, sdf_trunc=0.08, dims=(64, 64, 32),
           origin=(0.86, -0.14, -0.02))
JCFG, TCFG = JCfg(**VOL), TSDFConfig(**VOL)


@pytest.fixture(scope="module")
def frames():
    return capture(8)


def t(x):
    return torch.from_numpy(np.asarray(x))


def j(x):
    return jnp.asarray(np.asarray(x))


def port_volume(jvol):
    return ttb.BlockTSDFVolume.from_numpy(
        jvol.tsdf, jvol.weight, jvol.color, jvol.created, jvol.origin,
        jvol.voxel_size, jvol.sdf_trunc, jvol.grid_blocks, device="cpu")


def jax_fuse(depths, colors, exts, vol=None):
    vol = jtb.make_block_volume(JCFG) if vol is None else vol
    return jtb.integrate_frames_sparse(vol, j(depths), j(colors), j(exts),
                                       J_SMALL, max_active=vol.num_blocks)


def check_block_fusion(jvol, tvol, depths, exts):
    amb = ambiguous_voxels(voxel_centers(tvol.meta), depths, exts, T_SMALL,
                           tvol.sdf_trunc)
    amb[-1] = False                      # dead row: zero in both
    np.testing.assert_array_equal(tvol.created.numpy(),
                                  np.asarray(jvol.created))
    assert_fusion_matches(np.asarray(jvol.weight), np.asarray(jvol.tsdf),
                          np.asarray(jvol.color), tvol.weight.numpy(),
                          tvol.tsdf.numpy(), tvol.color.numpy(), amb)


class TestClassify:
    @pytest.mark.parametrize("case", ("capture",) + MIP_CASES)
    def test_depth_mips_match(self, frames, case):
        """The plain mip table and global bounds equal JAX's _depth_mips
        and depth_mip_planes' bounds bit for bit: at tile-aligned and
        ragged frame sizes, a frame without depth, and inf, negative and
        NaN pixels. The batched form equals the per-frame one, and
        tsdf_cuda.depth_mips (CPU tensors: the plain version) equals it."""
        depths = frames[0][:2] if case == "capture" else mip_depth(case, 2)
        tb, gb, th, tw = tc.depth_mips(t(depths))
        for k in range(len(depths)):
            tj, thj, twj = jtb._depth_mips(j(depths[k]))
            _, gj, _, _ = jtb.depth_mip_planes(j(depths[k]))
            tt, tht, twt = ttb._depth_mips(t(depths[k]))
            assert (thj, twj) == (tht, twt) == (th, tw)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
            np.testing.assert_array_equal(tb[k].numpy(), tt.numpy())
            np.testing.assert_array_equal(gb[k].numpy(), np.asarray(gj))

    def test_active_blocks_bit_identical(self, frames):
        depths, _, exts = frames
        jvol = jtb.make_block_volume(JCFG)
        meta = ttb.make_block_volume(TCFG, device="cpu").meta
        band_j, vis_j = jax.vmap(
            lambda d, e: jtb._active_blocks(jvol, d, e, J_SMALL))(
                j(depths), j(exts))
        band_t, vis_t = tc.classify_blocks(meta, t(depths), t(exts), T_SMALL)
        assert band_t.any() and (~band_t).any()
        np.testing.assert_array_equal(band_t.numpy(), np.asarray(band_j))
        np.testing.assert_array_equal(vis_t.numpy(), np.asarray(vis_j))
        # the single-frame form agrees with the batched one
        b0, v0 = ttb._active_blocks(meta, t(depths[3]), t(exts[3]), T_SMALL)
        np.testing.assert_array_equal(b0.numpy(), band_t[3].numpy())
        np.testing.assert_array_equal(v0.numpy(), vis_t[3].numpy())

    def test_matches_pallas_classify_and_cumulative_or(self, frames):
        depths, _, exts = frames
        depths, exts = depths[:4], exts[:4]
        jvol = jtb.make_block_volume(JCFG)
        vm = (jvol.grid_blocks, jvol.origin, jvol.voxel_size, jvol.sdf_trunc)
        band_p, vis_p = jtp._classify_blocks(j(depths), j(exts), J_SMALL, vm,
                                             interpret=True)
        created_in = np.zeros(jvol.num_blocks, bool)
        created_in[::7] = True           # a partly created volume
        created_j = np.asarray(jtp._cumulative_or(band_p)) | created_in[None]

        meta = ttb.make_block_volume(TCFG, device="cpu").meta
        band_t, vis_t = tc.classify_blocks(meta, t(depths), t(exts), T_SMALL)
        created_t, active_t = tc.created_and_active(band_t, vis_t,
                                                    t(created_in))
        np.testing.assert_array_equal(band_t.numpy(), np.asarray(band_p))
        np.testing.assert_array_equal(vis_t.numpy(), np.asarray(vis_p))
        np.testing.assert_array_equal(created_t.numpy(), created_j)
        np.testing.assert_array_equal(active_t.numpy(),
                                      created_j & np.asarray(vis_p))


# the flat two-plane scene and camera of test_tsdf_pallas.py, where the
# Pallas contract is stated
INTR = J_SMALL.__class__(64, 48, 56.0, 56.0, 32.0, 24.0)
CFG = JCfg(voxel_size=0.02, sdf_trunc=0.08, dims=(32, 32, 32),
           origin=(-0.32, -0.32, 0.2))


def plane_scene():
    th = 0.07
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]], np.float32)
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = R
    E[:3, 3] = [0.013, -0.021, 0.004]
    depths = np.stack([np.full((48, 64), 0.4503, np.float32),
                       np.full((48, 64), 0.5217, np.float32)])
    colors = np.stack([np.full((48, 64, 3), 100.0, np.float32),
                       np.full((48, 64, 3), 180.0, np.float32)])
    return depths, colors, np.stack([np.eye(4, dtype=np.float32), E])


class TestBlockFusion:
    def test_matches_jax_sparse(self, frames):
        depths, colors, exts = frames
        jvol = jax_fuse(depths, colors, exts)
        tvol = ttb.integrate_frames_sparse(ttb.make_block_volume(TCFG, device="cpu"),
                                           t(depths), t(colors), t(exts),
                                           T_SMALL)
        check_block_fusion(jvol, tvol, depths, exts)
        assert np.all(tvol.weight[-1].numpy() == 0)

    def test_second_batch_on_partly_created_volume(self, frames):
        """A JAX volume carried into the port (np.asarray of its fields)
        and fused further equals JAX fusing the whole batch."""
        depths, colors, exts = frames
        first = jax_fuse(depths[:4], colors[:4], exts[:4])
        tvol = port_volume(first)
        assert 0 < tvol.created.sum() < tvol.num_blocks
        ttb.integrate_frames_sparse(tvol, t(depths[4:]), t(colors[4:]),
                                    t(exts[4:]), T_SMALL)
        whole = jax_fuse(depths, colors, exts)
        check_block_fusion(whole, tvol, depths, exts)

    def test_volume_file_carried_across(self, frames, tmp_path):
        """The port reads a volume file the JAX package wrote, fuses the
        rest of the batch, and writes a file the JAX package reads."""
        depths, colors, exts = frames
        path = str(tmp_path / "vol.npz")
        jvio.save_volume(path, jax_fuse(depths[:3], colors[:3], exts[:3]))
        tvol = tvio.load_volume(path, device="cpu")
        ttb.integrate_frames_sparse(tvol, t(depths[3:]), t(colors[3:]),
                                    t(exts[3:]), T_SMALL)
        whole = jax_fuse(depths, colors, exts)
        check_block_fusion(whole, tvol, depths, exts)
        tvio.save_volume(path, tvol)
        back = jvio.load_volume(path)
        np.testing.assert_array_equal(np.asarray(back.weight),
                                      tvol.weight.numpy())
        assert back.grid_blocks == tvol.grid_blocks

    def test_max_active_cap_matches_jax(self, frames):
        """A capacity that binds integrates each frame's max_active lowest
        active block ids, as the JAX package's compact_ids does; the
        uncapped list fuses other blocks and differs from it."""
        depths, colors, exts = frames
        meta = ttb.make_block_volume(TCFG, device="cpu").meta
        nb = ttb.make_block_volume(TCFG, device="cpu").num_blocks
        band, vis = tc.classify_blocks(meta, t(depths), t(exts), T_SMALL)
        _, active = tc.created_and_active(band, vis,
                                          torch.zeros(nb, dtype=torch.bool))
        per_frame = active.sum(dim=1)
        k = int(per_frame.max()) * 2 // 3
        assert (per_frame > k).any()
        jvol = jtb.integrate_frames_sparse(
            jtb.make_block_volume(JCFG), j(depths), j(colors), j(exts),
            J_SMALL, max_active=k)
        tvol = ttb.integrate_frames_sparse(ttb.make_block_volume(TCFG, device="cpu"),
                                           t(depths), t(colors), t(exts),
                                           T_SMALL, max_active=k)
        check_block_fusion(jvol, tvol, depths, exts)
        free = ttb.integrate_frames_sparse(ttb.make_block_volume(TCFG, device="cpu"),
                                           t(depths), t(colors), t(exts),
                                           T_SMALL)
        # creation takes the whole band either way; only integration is cut
        assert torch.equal(free.created, tvol.created)
        lost = (free.weight.numpy() > 0) & (np.asarray(jvol.weight) == 0)
        assert lost.sum() > 1000

    def test_fuse_frames_max_active_matches_jax(self, frames):
        """fuse_frames passes max_active on to the sparse fusion, as the
        JAX package's fuse_frames(backend="sparse", max_active=k) does;
        None keeps every active block."""
        from otslam_tpu.config import ReconstructionConfig as JRec
        from otslam_tpu.pipeline.reconstruct import fuse_frames as jfuse
        from otslam_tpu_torch.config import ReconstructionConfig
        from otslam_tpu_torch.pipeline.reconstruct import fuse_frames

        depths, colors, exts = frames
        meta = ttb.make_block_volume(TCFG, device="cpu").meta
        band, vis = tc.classify_blocks(meta, t(depths), t(exts), T_SMALL)
        _, active = tc.created_and_active(band, vis,
                                          torch.zeros(band.shape[1],
                                                      dtype=torch.bool))
        k = int(active.sum(dim=1).max()) * 2 // 3     # binds on some frames
        jvol = jfuse(depths, colors, exts, J_SMALL, JRec(tsdf=JCFG),
                     "sparse", max_active=k, densify=False)
        tvol = fuse_frames(depths, colors, exts, T_SMALL,
                           ReconstructionConfig(tsdf=TCFG), "sparse",
                           max_active=k, densify=False, device="cpu")
        check_block_fusion(jvol, tvol, depths, exts)
        free = fuse_frames(depths, colors, exts, T_SMALL,
                           ReconstructionConfig(tsdf=TCFG), "sparse",
                           densify=False, device="cpu")
        lost = (free.weight.numpy() > 0) & (tvol.weight.numpy() == 0)
        assert lost.sum() > 1000

    def test_pallas_contract(self):
        """Against the Pallas kernel (interpret mode, full-res colour) the
        port meets the JAX package's own Pallas contract
        (test_tsdf_pallas.py): <= 1.5 % weight flips, tsdf <= 1e-3 where
        the weights agree."""
        depths, colors, exts = plane_scene()
        p = jtp.integrate_frames_pallas(jtb.make_block_volume(CFG),
                                        j(depths), j(colors), j(exts), INTR,
                                        max_active=64, interpret=True,
                                        color_res="full")
        tcfg = TSDFConfig(voxel_size=CFG.voxel_size, sdf_trunc=CFG.sdf_trunc,
                          dims=CFG.dims, origin=CFG.origin)
        tintr = PinholeIntrinsics(INTR.width, INTR.height, INTR.fx, INTR.fy,
                                  INTR.cx, INTR.cy)
        tv = ttb.integrate_frames_sparse(ttb.make_block_volume(tcfg, device="cpu"),
                                         t(depths), t(colors), t(exts), tintr)
        wp, wt = np.asarray(p.weight), tv.weight.numpy()
        observed = (wp > 0) | (wt > 0)
        assert observed.sum() > 1000
        assert (wp != wt).sum() / observed.sum() < 0.015
        same = (wp == wt) & (wp > 0)
        np.testing.assert_allclose(tv.tsdf.numpy()[same],
                                   np.asarray(p.tsdf)[same], atol=1e-3)
        np.testing.assert_array_equal(tv.created.numpy(),
                                      np.asarray(p.created))


class TestExtraction:
    @pytest.fixture(scope="class")
    def fused(self, frames):
        depths, colors, exts = frames
        return jax_fuse(depths, colors, exts)

    @pytest.mark.parametrize("with_normals", [False, True])
    def test_sparse_extraction_matches(self, fused, with_normals):
        nbk = int(np.asarray(fused.created).sum())
        jout = jtb.extract_surface_points_sparse(
            fused, capacity=200_000, max_blocks=1 << (nbk - 1).bit_length(),
            with_normals=with_normals)
        tout = ttb.extract_surface_points_sparse(
            port_volume(fused), capacity=200_000, with_normals=with_normals)
        count = int(np.asarray(jout[2]).sum())
        assert count > 1000 and tout[0].shape[0] == count
        for k, atol in ((0, 1e-6), (1, 1e-6), (3, 1e-5))[:2 + with_normals]:
            np.testing.assert_allclose(tout[k].numpy(),
                                       np.asarray(jout[k])[:count],
                                       rtol=0, atol=atol)

    def test_capacity_truncates_in_order(self, fused):
        full = ttb.extract_surface_points_sparse(port_volume(fused))
        cut = ttb.extract_surface_points_sparse(port_volume(fused),
                                                capacity=500)
        np.testing.assert_array_equal(cut[0].numpy(), full[0][:500].numpy())

    def test_block_dense_round_trip(self, fused):
        jd = jtb.block_to_dense(fused)
        td = ttb.block_to_dense(port_volume(fused))
        for a, b in ((td.tsdf, jd.tsdf), (td.weight, jd.weight),
                     (td.color, jd.color)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        back = ttb.dense_to_block(td, TCFG)
        jback = jtb.dense_to_block(jd, JCFG)
        np.testing.assert_array_equal(back.tsdf.numpy(),
                                      np.asarray(jback.tsdf))
        np.testing.assert_array_equal(back.created.numpy(),
                                      np.asarray(jback.created))


class TestDense:
    def test_dense_fusion_matches(self, frames):
        depths, colors, exts = (a[:4] for a in frames)
        jv = jtsdf.integrate_frames(jtsdf.make_volume(JCFG), j(depths),
                                    j(colors), j(exts), J_SMALL)
        tv = ttsdf.integrate_frames(ttsdf.make_volume(TCFG, device="cpu"), t(depths),
                                    t(colors), t(exts), T_SMALL)
        X, Y, Z = TCFG.dims
        axes = [TCFG.origin[k] + (np.arange(n) + 0.5) * TCFG.voxel_size
                for k, n in enumerate((X, Y, Z))]
        pts = np.meshgrid(*axes, indexing="ij")
        amb = ambiguous_voxels(pts, depths, exts, T_SMALL, TCFG.sdf_trunc)
        assert_fusion_matches(np.asarray(jv.weight), np.asarray(jv.tsdf),
                              np.asarray(jv.color), tv.weight.numpy(),
                              tv.tsdf.numpy(), tv.color.numpy(), amb)

    def test_dense_extraction_matches(self, frames):
        depths, colors, exts = (a[:4] for a in frames)
        jv = jtsdf.integrate_frames(jtsdf.make_volume(JCFG), j(depths),
                                    j(colors), j(exts), J_SMALL)
        tv = ttsdf.TSDFVolume.from_numpy(jv.tsdf, jv.weight, jv.color,
                                         jv.origin, jv.voxel_size,
                                         jv.sdf_trunc, device="cpu")
        jout = jtsdf.extract_surface_points(jv, capacity=200_000,
                                            with_normals=True)
        tout = ttsdf.extract_surface_points(tv, capacity=200_000,
                                            with_normals=True)
        count = int(np.asarray(jout[2]).sum())
        assert count > 1000 and tout[0].shape[0] == count
        for k, atol in ((0, 1e-6), (1, 1e-6), (3, 1e-5)):
            np.testing.assert_allclose(tout[k].numpy(),
                                       np.asarray(jout[k])[:count],
                                       rtol=0, atol=atol)
