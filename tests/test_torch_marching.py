"""Marching-tetrahedra mesh extraction of the port against otslam_tpu (CPU).

Counterparts of tests/test_marching.py's 15 tests run on the port, then
parity: a seeded dense sphere volume and a JAX-fused block volume go
through both packages' soups (the volumes cross over by
TSDFVolume.from_numpy / BlockTSDFVolume.from_numpy).

Tolerances. The soup masks and row order are equal. Vertices and colours
agree to <= 1e-6 (m and [0, 1]): XLA:CPU contracts the lerp
`pa + (pb - pa) * frac` and the corner positions into FMAs, the port
rounds every product (tests/torch_parity.py). The winding is equal on
every triangle whose |n_geom . gdir| lies more than 1e-6 relative off
zero; the triangles within that margin are counted and capped at 0, so a
flip anywhere fails. The welded meshes have equal vertex and face counts.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otslam_tpu.config import CameraConfig as JCam
from otslam_tpu.config import ReconstructionConfig as JRCfg
from otslam_tpu.config import TSDFConfig as JTCfg
from otslam_tpu.core.camera import PinholeIntrinsics as JIntr
from otslam_tpu.kernels import marching as jm
from otslam_tpu.kernels.tsdf import TSDFVolume as JVol
from otslam_tpu.kernels.tsdf_block import compact_ids as j_compact_ids
from otslam_tpu.kernels.tsdf_block import (
    integrate_frames_sparse as j_integrate, make_block_volume as j_make)
from otslam_tpu.pipeline.dataset import CaptureDataset as JDataset
from otslam_tpu.pipeline.reconstruct import reconstruct_object as j_reconstruct
from otslam_tpu.sim.sensors import look_at_pose
from otslam_tpu.sim.sensors import render_rgbd as j_render
from otslam_tpu.sim.world import cardboard_room as j_room
from otslam_tpu_torch.config import OTSLAMConfig, TSDFConfig
from otslam_tpu_torch.core import io as tio
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.kernels import marching as tm
from otslam_tpu_torch.kernels.tsdf import (
    TSDFVolume, integrate_frames, make_volume)
from otslam_tpu_torch.kernels.tsdf_block import (
    BlockTSDFVolume, block_to_dense, integrate_frames_sparse,
    make_block_volume)
from otslam_tpu_torch.pipeline.dataset import CaptureDataset
from otslam_tpu_torch.pipeline.reconstruct import reconstruct_object
from torch_parity import BOX_CENTER, J_SMALL, SMALL_CAM

CFG = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, dims=(48, 48, 48),
                 origin=(-0.48, -0.48, -0.48))
WALL_CFG = dataclasses.replace(CFG, origin=(-0.48, -0.48, 0.0))
WALL_INTR = dict(width=64, height=48, fx=56.0, fy=56.0, cx=32.0, cy=24.0)
ATOL = 1e-6


def sphere_fields(radius=0.3, noise=0.0, seed=0):
    """Truncated SDF of a sphere (plus seeded noise), fully observed, with
    seeded colours: (tsdf, weight, color (3, X, Y, Z)) numpy."""
    X = CFG.dims[0]
    xs = CFG.origin[0] + (np.arange(X) + 0.5) * CFG.voxel_size
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    rng = np.random.default_rng(seed)
    d = np.linalg.norm(g, axis=-1) - radius + rng.normal(0, noise, (X,) * 3)
    tsdf = np.clip(d / CFG.sdf_trunc, -1, 1).astype(np.float32)
    if noise == 0.0:
        color = np.full((3, X, X, X), 128.0, np.float32)
    else:
        color = rng.uniform(0, 255, (3, X, X, X)).astype(np.float32)
    return tsdf, np.ones_like(tsdf), color


def port_dense(fields) -> TSDFVolume:
    return TSDFVolume.from_numpy(*fields, CFG.origin, CFG.voxel_size,
                                 CFG.sdf_trunc, device="cpu")


def jax_dense(fields) -> JVol:
    return JVol(*(jnp.asarray(f) for f in fields), CFG.origin,
                CFG.voxel_size, CFG.sdf_trunc)


def sphere_volume(radius=0.3):
    return port_dense(sphere_fields(radius))


def wall_frames():
    """tests/test_marching.py's two wall planes: (depth, color, ext)."""
    depth = np.full((2, 48, 64), 0.3503, np.float32)
    depth[1] += 0.08                       # second wall plane
    color = np.zeros((2, 48, 64, 3), np.float32)
    color[0] = 200.0
    color[1] = 40.0
    ext = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    ext[1, 2, 3] = 0.08                    # shifted camera
    return depth, color, ext


@pytest.fixture(scope="module")
def jax_block():
    """The two-wall block volume fused by the JAX package."""
    depth, color, ext = wall_frames()
    cfg = JTCfg(voxel_size=0.02, sdf_trunc=0.08, dims=(48, 48, 48),
                origin=WALL_CFG.origin)
    return j_integrate(j_make(cfg), jnp.asarray(depth), jnp.asarray(color),
                       jnp.asarray(ext), JIntr(**WALL_INTR), max_active=512)


@pytest.fixture(scope="module")
def block(jax_block):
    """The same volume carried into the port."""
    v = jax_block
    return BlockTSDFVolume.from_numpy(
        np.asarray(v.tsdf), np.asarray(v.weight), np.asarray(v.color),
        np.asarray(v.created), v.origin, v.voxel_size, v.sdf_trunc,
        v.grid_blocks, device="cpu")


def masked_tris(soup):
    verts, cols, mask = (np.asarray(a) for a in soup)
    return verts[mask].reshape(-1, 3, 3), cols[mask].reshape(-1, 3, 3)


def canon(tris):
    """Lexsort a triangle list by its 9 coordinates (soup order differs
    between the dense x-major and block-major compactions)."""
    flat = tris.reshape(len(tris), -1)
    return flat[np.lexsort(flat.T[::-1])]


def numpy_soup(soup):
    return tuple(a.numpy() for a in soup)


def winding_margin(tris, tsdf, origin, vs):
    """|n_geom . gdir| / (|n_geom| |gdir|) of each triangle (f64): the
    normal from its vertices, the cell's trilinear gradient from the dense
    tsdf at the cell holding its centroid."""
    t = np.asarray(tris, np.float64)
    base = np.floor((t.mean(axis=1) - np.asarray(origin)) / vs - 0.5)
    base = base.astype(np.int64)
    n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
    g = np.zeros_like(n)
    for c, w in zip(tm._CORNERS, tm._GRAD_W):
        ix, iy, iz = (base + c).T
        g += tsdf[ix, iy, iz].astype(np.float64)[:, None] * w
    dot = np.abs(np.sum(n * g, axis=1))
    return dot / np.maximum(np.linalg.norm(n, axis=1)
                            * np.linalg.norm(g, axis=1), 1e-300)


def assert_soup_parity(j_soup, t_soup, tsdf, origin, vs):
    """The stated tolerances of the module docstring."""
    jv, jc, jmask = (np.asarray(a) for a in j_soup)
    tv, tc, tmask = t_soup
    assert jmask.shape == tmask.shape
    np.testing.assert_array_equal(tmask, jmask)
    assert jmask.sum() > 100
    np.testing.assert_allclose(tv[jmask], jv[jmask], rtol=0, atol=ATOL)
    np.testing.assert_allclose(tc[jmask], jc[jmask], rtol=0, atol=ATOL)
    margin = winding_margin(jv[jmask].reshape(-1, 3, 3), tsdf, origin, vs)
    near_zero = int((margin <= 1e-6).sum())
    print(f"triangles {int(jmask.sum())}, winding within 1e-6 of zero: "
          f"{near_zero}, max |dv| "
          f"{np.abs(tv[jmask] - jv[jmask]).max():.3g}")
    assert near_zero == 0
    jw = jm._weld_mesh(jv, jc, jmask)
    tw = tm._weld_mesh(tv, tc, tmask)
    assert [len(a) for a in tw] == [len(a) for a in jw]


# --- counterparts of tests/test_marching.py ----------------------------------

class TestTetTable:
    def test_case_triangle_counts(self):
        np.testing.assert_array_equal(tm._TET_TABLE, jm._TET_TABLE)
        counts = [(tm._TET_TABLE[c, :, 0, 0] >= 0).sum() for c in range(16)]
        assert counts[0] == 0 and counts[15] == 0
        for c in range(1, 15):
            ninside = bin(c).count("1")
            assert counts[c] == (2 if ninside == 2 else 1)
        # the (case -> corner) table picks the corners of JAX's one-hot
        # selection tables wherever a triangle is present
        present = jm._TRI_PRESENT.astype(bool)               # (16, 2)
        np.testing.assert_array_equal(tm._TRI_PRESENT, present)
        on = np.broadcast_to(present[:, None, :], (16, 6, 2))
        for e, sel in enumerate((jm._SEL_A, jm._SEL_B)):     # (16,6,2,3,8)
            got = np.moveaxis(tm._CORNER_TABLE[..., e], 0, 1)
            want = np.argmax(sel, axis=-1)
            np.testing.assert_array_equal(got[on], want[on])
        np.testing.assert_array_equal(tm._GRAD_W, jm._GRAD_W)


class TestSphere:
    def test_vertices_on_sphere(self):
        verts, faces, cols, normals = tm.extract_mesh(sphere_volume(0.3),
                                                      max_cells=32768)
        assert len(verts) > 1000 and len(faces) > 1000
        r = np.linalg.norm(verts, axis=1)
        # zero-crossing interpolation: vertices within half a voxel of r=0.3
        assert np.abs(r - 0.3).max() < CFG.voxel_size
        assert np.sqrt(np.mean((r - 0.3) ** 2)) < 2e-3

    def test_normals_outward(self):
        verts, faces, cols, normals = tm.extract_mesh(sphere_volume(0.3),
                                                      max_cells=32768)
        rad = verts / np.linalg.norm(verts, axis=1, keepdims=True)
        cosang = np.sum(normals * rad, axis=1)
        assert np.mean(cosang > 0.7) > 0.98

    def test_mesh_is_edge_manifold(self):
        """Every interior edge is shared by exactly 2 triangles (a closed
        surface from marching tets is watertight)."""
        verts, faces, cols, normals = tm.extract_mesh(sphere_volume(0.3),
                                                      max_cells=32768)
        edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                faces[:, [2, 0]]])
        edges = np.sort(edges, axis=1)
        uniq, counts = np.unique(edges, axis=0, return_counts=True)
        assert (counts == 2).mean() > 0.999

    def test_mesh_ply_roundtrip(self, tmp_path):
        verts, faces, cols, normals = tm.extract_mesh(sphere_volume(0.25),
                                                      max_cells=32768)
        p = str(tmp_path / "sphere.ply")
        tio.write_ply(p, verts, colors=cols, normals=normals, faces=faces)
        back = tio.read_ply(p)
        assert back["faces"].shape == faces.shape
        np.testing.assert_allclose(back["points"], verts, atol=1e-5)


class TestAutoCapacity:
    def test_auto_max_cells_is_exact_and_lossless(self):
        """auto_max_cells bounds the true active-cell count (and equals
        the JAX package's), and the right-sized extraction gives the
        identical welded mesh as an oversized one."""
        fields = sphere_fields(0.3)
        vol = port_dense(fields)
        mc = tm.auto_max_cells(vol)
        assert mc == jm.auto_max_cells(jax_dense(fields))
        assert tm._count_active_cells(vol) <= mc <= 32768
        v_auto, f_auto, _, _ = tm.extract_mesh(vol)
        v_big, f_big, _, _ = tm.extract_mesh(vol, max_cells=32768)
        assert len(v_auto) == len(v_big) and len(f_auto) == len(f_big)
        np.testing.assert_allclose(v_auto, v_big, atol=0)


class TestFromFusion:
    def test_wall_mesh_from_integrated_frames(self):
        intr = PinholeIntrinsics(**WALL_INTR)
        depth = torch.full((1, 48, 64), 0.3503)
        color = torch.full((1, 48, 64, 3), 200.0)
        ext = torch.eye(4)[None]
        vol = integrate_frames(make_volume(WALL_CFG, device="cpu"), depth,
                               color, ext, intr)
        verts, faces, cols, normals = tm.extract_mesh(vol, max_cells=16384)
        assert len(verts) > 50
        assert np.abs(verts[:, 2] - 0.3503).max() < 0.02
        # colors carried through (200/255)
        np.testing.assert_allclose(cols.mean(), 200 / 255, atol=0.02)


class TestBlockPath:
    """extract_mesh_soup_block gives the identical triangle SET as the
    densified path: same corner values, same per-cell phase, only the cell
    order differs."""

    def test_soup_matches_densified(self, block):
        v_d, c_d = masked_tris(tm.extract_mesh_soup(block_to_dense(block),
                                                    max_cells=16384))
        v_b, c_b = masked_tris(tm.extract_mesh_soup_block(
            block, max_blocks=512, max_cells=16384))
        assert len(v_d) > 100 and len(v_d) == len(v_b)
        np.testing.assert_array_equal(canon(v_d), canon(v_b))
        key_d = np.lexsort(v_d.reshape(len(v_d), -1).T[::-1])
        key_b = np.lexsort(v_b.reshape(len(v_b), -1).T[::-1])
        np.testing.assert_array_equal(c_d[key_d], c_b[key_b])

    def test_extract_mesh_accepts_block_volume(self, block):
        v_b, f_b, c_b, n_b = tm.extract_mesh(block)          # auto capacities
        v_d, f_d, c_d, n_d = tm.extract_mesh(block_to_dense(block))
        np.testing.assert_array_equal(v_b, v_d)
        assert len(f_b) == len(f_d)
        np.testing.assert_array_equal(c_b, c_d)

    def test_empty_volume(self):
        v, f, c, n = tm.extract_mesh(make_block_volume(WALL_CFG,
                                                       device="cpu"))
        assert len(v) == 0 and len(f) == 0

    def test_batched_matches_single(self, block):
        """extract_meshes_block reproduces each volume's single-call soup
        bit for bit, with distinct per-volume origins."""
        v2 = dataclasses.replace(block, tsdf=block.tsdf * 0.7,
                                 origin=(-0.4, -0.44, 0.02))
        verts, cols, masks = tm.extract_meshes_block([block, v2],
                                                     max_blocks=512,
                                                     max_cells=16384)
        for b, v in enumerate((block, v2)):
            sv, sc, sm = tm.extract_mesh_soup_block(v, max_blocks=512,
                                                    max_cells=16384)
            assert torch.equal(masks[b], sm)
            assert torch.equal(verts[b][sm], sv[sm])
            assert torch.equal(cols[b][sm], sc[sm])

    def test_weld_masks_tensors_like_arrays(self, block):
        soup = tm.extract_mesh_soup_block(block, 512, 16384)
        from_tensors = tm._weld_mesh(*soup)
        from_arrays = tm._weld_mesh(*numpy_soup(soup))
        for a, b in zip(from_tensors, from_arrays):
            np.testing.assert_array_equal(a, b)

    def test_batched_rejects_shape_mismatch(self, block):
        v2 = dataclasses.replace(block, voxel_size=0.04)
        with pytest.raises(ValueError):
            tm.extract_meshes_block([block, v2])

    def test_auto_config_matches_oversized(self, block, jax_block):
        mb, mc = tm.auto_mesh_block_config(block)
        assert (mb, mc) == jm.auto_mesh_block_config(jax_block)
        v_a, _ = masked_tris(tm.extract_mesh_soup_block(block, mb, mc))
        v_big, _ = masked_tris(tm.extract_mesh_soup_block(
            block, max_blocks=512, max_cells=16384))
        np.testing.assert_array_equal(canon(v_a), canon(v_big))


class TestCompaction:
    """The port's nonzero compaction keeps the JAX contract of
    _compact_ids_hier (ascending ids, the smallest max_ids on overflow),
    with pads decoded as cell 0 under a false mask."""

    @staticmethod
    def check(active, max_ids, seg=128):
        n = active.shape[0]
        want = np.asarray(jm._compact_ids_hier(jnp.asarray(active), max_ids,
                                               seg=seg))
        np.testing.assert_array_equal(
            want, np.asarray(j_compact_ids(jnp.asarray(active), max_ids, n)))
        ids, mask = tm._compact_cells(torch.as_tensor(active), max_ids)
        np.testing.assert_array_equal(mask.numpy(), want < n)
        np.testing.assert_array_equal(ids.numpy(),
                                      np.where(want < n, want, 0))

    @pytest.mark.parametrize("n, density, max_ids, seg", [
        (100_000, 0.0001, 64, 128),      # sparse
        (100_000, 0.01, 1024, 128),      # normal
        (100_000, 0.05, 256, 128),       # overflow: keeps smallest ids
        (4_097, 0.2, 512, 128),          # n not a multiple of seg
        (999, 0.3, 64, 128),             # n < capacity * seg (degenerate)
        (50_000, 0.0, 128, 256),         # empty mask
    ])
    def test_matches_flat_compact_ids(self, n, density, max_ids, seg):
        rng = np.random.default_rng(3)
        self.check(rng.random(n) < density, max_ids, seg)

    def test_clustered_actives(self):
        """Spatially clustered actives (the real surface-cell pattern)."""
        n = 200_000
        a = np.zeros(n, bool)
        a[5_000:5_400] = True
        a[150_000:150_037] = True
        a[n - 3:] = True
        self.check(a, 512)


# --- parity with the JAX package ---------------------------------------------

class TestParity:
    def test_dense_soup_matches_jax(self):
        fields = sphere_fields(0.3, noise=0.002, seed=5)
        j_soup = jm.extract_mesh_soup(jax_dense(fields), 32768)
        t_soup = numpy_soup(tm.extract_mesh_soup(port_dense(fields), 32768))
        assert_soup_parity(j_soup, t_soup, fields[0], CFG.origin,
                           CFG.voxel_size)

    def test_block_soup_matches_jax(self, block, jax_block):
        mb, mc = tm.auto_mesh_block_config(block)
        j_soup = jm.extract_mesh_soup_block(jax_block, mb, mc)
        t_soup = numpy_soup(tm.extract_mesh_soup_block(block, mb, mc))
        assert_soup_parity(j_soup, t_soup, block_to_dense(block).tsdf.numpy(),
                           block.origin, block.voxel_size)

    @pytest.mark.parametrize("overflow", ["cells", "blocks"])
    def test_truncation_matches_jax(self, block, jax_block, overflow):
        """On overflow both keep the smallest cell ids (max_cells below the
        active count) or the smallest created block ids (max_blocks below
        the created count)."""
        created = int(block.created.sum())
        mb, mc = (256, 128) if overflow == "cells" else (created // 2, 1024)
        assert tm._count_active_cells_block(block, 512) > 128
        j_soup = jm.extract_mesh_soup_block(jax_block, mb, mc)
        t_soup = numpy_soup(tm.extract_mesh_soup_block(block, mb, mc))
        cells_used = t_soup[2].reshape(mc, 12).any(axis=1)
        if overflow == "cells":
            assert cells_used.all()
        else:
            full = tm.extract_mesh_soup_block(block, 512, 16384)[2]
            assert 0 < t_soup[2].sum() < full.sum()
        assert_soup_parity(j_soup, t_soup, block_to_dense(block).tsdf.numpy(),
                           block.origin, block.voxel_size)

    def test_batched_matches_jax(self, block, jax_block):
        v2 = dataclasses.replace(block, tsdf=block.tsdf * 0.7,
                                 origin=(-0.4, -0.44, 0.02))
        jv2 = dataclasses.replace(jax_block, tsdf=jax_block.tsdf * 0.7,
                                  origin=(-0.4, -0.44, 0.02))
        j_out = jm.extract_meshes_block([jax_block, jv2])
        t_out = tm.extract_meshes_block([block, v2])
        assert t_out[0].shape == j_out[0].shape
        for b, v in enumerate((block, v2)):
            assert_soup_parity([a[b] for a in j_out],
                               [a[b].numpy() for a in t_out],
                               block_to_dense(v).tsdf.numpy(), v.origin,
                               v.voxel_size)

    def test_welded_mesh_matches_jax(self, block, jax_block):
        jw = jm.extract_mesh(jax_block)
        tw = tm.extract_mesh(block)
        assert [len(a) for a in tw] == [len(a) for a in jw]
        np.testing.assert_allclose(tw[0], jw[0], rtol=0, atol=ATOL)
        np.testing.assert_array_equal(tw[1], jw[1])
        np.testing.assert_allclose(tw[2], jw[2], rtol=0, atol=ATOL)
        np.testing.assert_allclose(tw[3], jw[3], rtol=0, atol=1e-4)


# --- the slice: reconstruct_object(output="mesh") in both packages -----------

CAM = dict(SMALL_CAM, depth_trunc=3.0)
VOL = dict(voxel_size=0.02, sdf_trunc=0.08, dims=(64, 64, 64))


@pytest.fixture(scope="module")
def capture_dataset(tmp_path_factory):
    """8 frames of a capture circle around the cardboard box, written by
    the JAX package's CaptureDataset."""
    root = tmp_path_factory.mktemp("mesh_ds")
    ds = JDataset(str(root), JCam(**CAM))
    c = np.asarray(BOX_CENTER)
    for i in range(8):
        a = 2 * np.pi * i / 8
        pose = look_at_pose([c[0] + np.cos(a), c[1] + np.sin(a), 0.5], c)
        d, col = j_render(j_room(), pose, J_SMALL, far=5.0)
        from otslam_tpu.core.se3 import T_FIX_OPTICAL
        ds.save_frame("Object_0", np.asarray(col).astype(np.uint8),
                      np.asarray(d), pose @ T_FIX_OPTICAL.T)
    return root


def nearest_mean(a, b):
    """Mean distance from each row of a to its nearest row of b (f64)."""
    from scipy.spatial import cKDTree
    return float(cKDTree(b.astype(np.float64)).query(
        a.astype(np.float64))[0].mean())


def test_reconstruct_object_mesh_matches_jax(capture_dataset, tmp_path):
    jcfg = JRCfg(camera=JCam(**CAM), tsdf=JTCfg(**VOL))
    cfg = OTSLAMConfig.from_dict({"camera": CAM, "reconstruction": {
        "camera": CAM, "tsdf": VOL}})
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    j_reconstruct(JDataset(str(capture_dataset), JCam(**CAM)), "Object_0",
                  jcfg, backend="sparse", save_dir=str(jdir), output="mesh",
                  auto_origin=True)
    res = reconstruct_object(CaptureDataset(str(capture_dataset), cfg.camera),
                             "Object_0", cfg.reconstruction,
                             backend="sparse", save_dir=str(tdir),
                             output="mesh", auto_origin=True, device="cpu")
    jp = tio.read_ply(str(jdir / "Object_0.ply"))
    tp = tio.read_ply(str(tdir / "Object_0.ply"))
    assert "faces" in jp and "faces" in tp
    assert res.faces is not None and len(res.faces) == len(tp["faces"])
    nv_j, nv_t = len(jp["points"]), len(tp["points"])
    nf_j, nf_t = len(jp["faces"]), len(tp["faces"])
    sym = 0.5 * (nearest_mean(tp["points"], jp["points"])
                 + nearest_mean(jp["points"], tp["points"]))
    print(f"vertices {nv_t} vs {nv_j}, faces {nf_t} vs {nf_j}, symmetric "
          f"mean nearest-vertex distance {sym * 1e3:.6f} mm")
    assert nv_t > 1000
    assert abs(nv_t - nv_j) <= 0.01 * nv_j
    assert abs(nf_t - nf_j) <= 0.01 * nf_j
    assert sym < 1e-4
    assert tp["faces"].min() >= 0 and tp["faces"].max() < nv_t
