"""otslam_tpu_torch's sharded fusion and eval on torch.distributed vs
otslam_tpu's shard_map paths (CPU).

One 4-rank gloo group runs every case of tests/torch_dist_cases.py once for
the module (distributed/launch.run_ranks: spawned ranks, a FileStore, one
thread each, a 120 s hard timeout). Each test holds one case's result to
the JAX function on a 4-device JAX mesh of the same shape (the conftest's
virtual CPU devices) and to the port's serial path. Where the JAX sharded
sparse path would need interpreted Pallas, the reference is JAX's serial
XLA `integrate_frames_sparse`. Tolerances are the dry run's: weights
exact, tsdf <= 1e-4, colour <= 1e-3, soups bit-identical to the port's
serial soup, chamfer within 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otslam_tpu.config import CameraConfig as JCam
from otslam_tpu.config import ReconstructionConfig as JRec
from otslam_tpu.config import TSDFConfig as JCfg
from otslam_tpu.core.camera import PinholeIntrinsics as JIntr
from otslam_tpu.core.se3 import T_FIX_OPTICAL, invert_se3
from otslam_tpu.distributed import sharding as jsh
from otslam_tpu.distributed import sparse as jsp
from otslam_tpu.distributed.mesh import make_mesh as jmesh
from otslam_tpu.kernels import tsdf as jtsdf
from otslam_tpu.kernels import tsdf_block as jtb
import otslam_tpu.pipeline.reconstruct as jrec
from otslam_tpu.pipeline.dataset import CaptureDataset as JDataset
from otslam_tpu.sim.sensors import look_at_pose, render_rgbd
from otslam_tpu.sim.world import Box, Scene
from otslam_tpu_torch.distributed.launch import run_ranks
from otslam_tpu_torch.kernels import tsdf_cuda as tc
from otslam_tpu_torch.kernels.marching import extract_mesh_soup_block
from otslam_tpu_torch.kernels.nn import nn_distance
from otslam_tpu_torch.kernels.tsdf import integrate_frames, make_volume
from otslam_tpu_torch.kernels.tsdf_block import (
    BlockTSDFVolume, make_block_volume)
from otslam_tpu_torch.pipeline.dataset import CaptureDataset
from otslam_tpu_torch.pipeline.reconstruct import reconstruct_object

import torch_dist_cases as cases
from torch_parity import (J_SMALL, T_SMALL, ambiguous_voxels,
                          assert_fusion_matches, capture, voxel_centers)

JCFG = JCfg(**cases.CFG.__dict__)
JBOX = JCfg(**cases.BOX.__dict__)
J_INTR = JIntr(64, 48, 56.0, 56.0, 32.0, 24.0)
WORLD = 4


def dense_frames(n=8):
    """Wall planes (tests/test_distributed.py's frames)."""
    depths = np.stack([np.full((48, 64), 0.4503 + 0.013 * i, np.float32)
                       for i in range(n)])
    colors = np.stack([np.full((48, 64, 3), 90.0 + 10 * i, np.float32)
                       for i in range(n)])
    return depths, colors, np.stack([np.eye(4, dtype=np.float32)] * n)


def sparse_frames(n=8):
    """A surface receding in big steps: blocks created by early frames
    leave later frames' bands but stay visible, so the result needs the
    cross-rank creation prefix (tests/test_distributed.py's)."""
    depths = np.stack([np.full((48, 64), 0.45 + 0.09 * i, np.float32)
                       for i in range(n)])
    colors = np.stack([np.full((48, 64, 3), 60.0 + 10 * i, np.float32)
                       for i in range(n)])
    return depths, colors, np.stack([np.eye(4, dtype=np.float32)] * n)


def object_frames(n_obj=WORLD, n=4):
    depths = np.stack([np.full((n, 48, 64), 0.42 + 0.02 * o, np.float32)
                       for o in range(n_obj)])
    colors = np.full((n_obj, n, 48, 64, 3), 120.0, np.float32)
    exts = np.tile(np.eye(4, dtype=np.float32)[None, None], (n_obj, n, 1, 1))
    origins = np.asarray([(-0.64 + 0.1 * o, -0.64, -0.64)
                          for o in range(n_obj)], np.float32)
    return depths, colors, exts, origins


def write_dataset(root):
    """Two objects (4 and 3 frames) rendered by the JAX package
    (tests/test_distributed.py's reconstruct_all scene)."""
    cam = JCam(**cases.DS_CAM.__dict__)
    scene = Scene(objects=(
        Box((1.0, 0.0, 0.15), (0.4, 0.4, 0.3), 0.0, (0.8, 0.4, 0.2), "a"),
        Box((-1.0, 1.0, 0.1), (0.3, 0.3, 0.2), 0.4, (0.2, 0.4, 0.8), "b")))
    ds = JDataset(root, cam)
    intr = JIntr.from_config(cam)
    for k, (center, n_frames) in enumerate(
            [((1.0, 0.0, 0.15), 4), ((-1.0, 1.0, 0.1), 3)]):
        for i in range(n_frames):
            a = 2 * np.pi * i / n_frames
            eye = np.array([center[0] + 0.9 * np.cos(a),
                            center[1] + 0.9 * np.sin(a), 0.45])
            pose = look_at_pose(eye, np.asarray(center))
            d, c = render_rgbd(scene, pose, intr, far=4.0)
            ds.save_frame(f"Object_{k}", np.asarray(c).astype(np.uint8),
                          np.asarray(d), pose @ invert_se3(T_FIX_OPTICAL))


def box_cap(depths, exts):
    """A per-frame max_active that binds on some frames of the capture."""
    meta = make_block_volume(cases.BOX, "cpu").meta
    band, vis = tc.classify_blocks(meta, torch.from_numpy(depths),
                                   torch.from_numpy(exts), T_SMALL)
    _, active = tc.created_and_active(
        band, vis, torch.zeros(band.shape[1], dtype=torch.bool))
    return int(active.sum(dim=1).max()) * 2 // 3


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = str(tmp_path_factory.mktemp("dist") / "ds")
    write_dataset(root)
    box = capture(8)
    return {"dense": dense_frames(), "sparse": sparse_frames(),
            "box": box, "box_cap": box_cap(box[0], box[2]),
            "objects": object_frames(),
            "src": rng.standard_normal((1024, 3)).astype(np.float32),
            "dst": rng.standard_normal((2048, 3)).astype(np.float32),
            "dataset": root,
            # JAX's sample draws at seed 3, so both packages pick the same
            # surface rows
            "draws": np.asarray(jax.random.uniform(
                jax.random.PRNGKey(3), (cases.DS_CFG.surface_samples,)))}


@pytest.fixture(scope="module")
def ranks(inputs):
    """Every case on 4 gloo ranks, once for the module."""
    return run_ranks(cases.run_all, (inputs,), world=WORLD, backend="gloo",
                     timeout=120)


@pytest.fixture(scope="module")
def out(ranks):
    return ranks[0]["out"]


@pytest.fixture(scope="module")
def jmesh4():
    if jax.device_count() < WORLD:
        pytest.skip("needs 4 (virtual) devices")
    devs = jax.devices()[:WORLD]
    return {"data": jmesh((WORLD,), ("data",), devs),
            "data_model": jmesh((2, 2), ("data", "model"), devs),
            "hier22": jmesh((2, 2), ("dcn", "ici"), devs),
            "hier14": jmesh((1, 4), ("dcn", "ici"), devs)}


def j(x):
    return jnp.asarray(np.asarray(x))


def t(x):
    return torch.from_numpy(np.asarray(x))


def check_dense(got, ref, tsdf_atol=1e-4):
    """Weights exact, tsdf <= tsdf_atol, colour <= 1e-3."""
    np.testing.assert_array_equal(got["weight"], np.asarray(ref.weight))
    np.testing.assert_allclose(got["tsdf"], np.asarray(ref.tsdf), rtol=0,
                               atol=tsdf_atol)
    np.testing.assert_allclose(got["color"], np.asarray(ref.color), rtol=0,
                               atol=1e-3)
    assert got["weight"].sum() > 0


def check_block(got, ref, tsdf_atol=1e-4):
    np.testing.assert_array_equal(got["created"], np.asarray(ref.created))
    check_dense(got, ref, tsdf_atol)


def port_serial_dense(frames):
    return integrate_frames(make_volume(cases.CFG, "cpu"),
                            *(t(x) for x in frames), cases.INTR)


def port_serial_sparse(frames, cfg=cases.CFG, intr=cases.INTR, vol=None,
                       max_active=None):
    vol = make_block_volume(cfg, "cpu") if vol is None else vol
    return tc.integrate_frames_cuda(vol, *(t(x) for x in frames), intr,
                                    max_active=max_active)


def test_every_rank_holds_the_same_whole(ranks):
    keys = set(ranks[0]["digests"]) - {"data_pair"}
    assert len(keys) >= 30
    for r in ranks[1:]:
        shared = keys & set(r["digests"])
        assert shared == keys - {"data_pair"}
        for k in shared:
            assert r["digests"][k] == ranks[0]["digests"][k], k
    assert ranks[1]["digests"]["data_pair"] == ranks[0]["digests"][
        "data_pair"]


def test_make_mesh(out, ranks):
    assert out["mesh_shape"] == (WORLD,)
    assert "needs 8 devices, have 4" in out["mesh_too_big"]
    assert "rank mismatch" in out["mesh_rank_mismatch"]
    # a 2-rank mesh in a 4-rank group: ranks 2 and 3 are not in it
    assert "not in this mesh" in ranks[2]["out"]["outside_mesh"]


@pytest.mark.parametrize("key", [
    "data_indivisible", "two_d_indivisible_x", "two_d_indivisible_frames",
    "hier_indivisible", "objects_indivisible", "chamfer_indivisible",
    "sparse_indivisible", "objects_sparse_indivisible"])
def test_divisibility_errors(out, key):
    assert "divisible" in out[key]


def test_data_parallel(out, inputs, jmesh4):
    frames = inputs["dense"]
    ref = jsh.fuse_frames_data_parallel(*(j(x) for x in frames), J_INTR,
                                        JCFG, jmesh4["data"])
    check_dense(out["data_parallel"], ref, 1e-5)
    check_dense(out["data_parallel"], port_serial_dense(frames), 1e-5)
    pair = [x[:2] for x in frames]
    check_dense(out["data_pair"], port_serial_dense(pair), 1e-5)


def test_two_d_sharded(out, inputs, jmesh4):
    frames = inputs["dense"]
    ref = jsh.fuse_frames_2d_sharded(*(j(x) for x in frames), J_INTR, JCFG,
                                     jmesh4["data_model"])
    check_dense(out["two_d"], ref)
    check_dense(out["two_d"], port_serial_dense(frames))


@pytest.mark.parametrize("shape", ["hier22", "hier14"])
def test_hierarchical(out, inputs, jmesh4, shape):
    frames = inputs["dense"]
    ref = jsh.fuse_frames_hierarchical(*(j(x) for x in frames), J_INTR,
                                       JCFG, jmesh4[shape])
    got = out["hier_2x2" if shape == "hier22" else "hier_1x4"]
    check_dense(got, ref, 1e-5)
    check_dense(got, port_serial_dense(frames), 1e-5)


def test_objects_parallel(out, inputs, jmesh4):
    d, c, e, o = inputs["objects"]
    jt, jw, jc = jsh.fuse_objects_parallel(j(d), j(c), j(e), j(o), J_INTR,
                                           JCFG, jmesh4["data"])
    tsdf, weight, color = out["objects"]
    for k in range(len(o)):
        got = {"tsdf": tsdf[k], "weight": weight[k], "color": color[k]}
        check_dense(got, jtsdf.TSDFVolume(jt[k], jw[k], jc[k], None, 0, 0))
        cfg_o = dataclasses.replace(cases.CFG,
                                    origin=tuple(map(float, o[k])))
        ref = integrate_frames(make_volume(cfg_o, "cpu"), t(d[k]), t(c[k]),
                               t(e[k]), cases.INTR)
        check_dense(got, ref)


def test_chamfer(out, inputs, jmesh4):
    src, dst = inputs["src"], inputs["dst"]
    want = float(torch.mean(nn_distance(t(src), t(dst))))
    jgot = float(jsh.chamfer_data_parallel(j(src), j(dst), jmesh4["data"],
                                           chunk=256))
    for ref in (want, jgot):
        assert abs(out["chamfer"] - ref) <= 1e-5 + 1e-5 * abs(ref)


def test_auto_max_active_equals_jax(out, inputs):
    d, _, e = inputs["sparse"]
    want = jsp.auto_max_active_sharded(jtb.make_block_volume(JCFG), j(d),
                                       j(e), J_INTR, WORLD)
    assert out["auto_max_active"] == want


def test_sparse_data_parallel(out, inputs):
    frames = inputs["sparse"]
    jref = jtb.integrate_frames_sparse(
        jtb.make_block_volume(JCFG), *(j(x) for x in frames), J_INTR,
        max_active=jtb.make_block_volume(JCFG).num_blocks)
    check_block(out["sparse"], jref)
    check_block(out["sparse"], port_serial_sparse(frames))


def test_sparse_creation_prefix_has_teeth(out, inputs):
    """The receding-surface frames need the cross-rank creation prefix:
    shards fused independently lose carving weight."""
    frames = inputs["sparse"]
    alone = sum(float(port_serial_sparse([x[2 * s:2 * s + 2]
                                          for x in frames]).weight.sum())
                for s in range(WORLD))
    assert alone < 0.98 * out["sparse"]["weight"].sum()


@pytest.mark.parametrize("cap", ["none", "binding"])
def test_sparse_capture_matches_jax_off_ties(out, inputs, cap):
    """The 160x120 capture circle: the port's sharded volume against JAX's
    XLA fusion off the rounding ties (tests/torch_parity.py), and the
    port's serial schedule at the same per-frame cap."""
    depths, colors, exts = inputs["box"]
    k = None if cap == "none" else inputs["box_cap"]
    got = out["sparse_box" if cap == "none" else "sparse_box_cap"]
    jvol = jtb.integrate_frames_sparse(
        jtb.make_block_volume(JBOX), j(depths), j(colors), j(exts), J_SMALL,
        max_active=k or 256)
    serial = port_serial_sparse(inputs["box"], cases.BOX, T_SMALL,
                                max_active=k)
    check_block(got, serial)
    amb = ambiguous_voxels(voxel_centers(serial.meta), depths, exts,
                           T_SMALL, serial.sdf_trunc)
    amb[-1] = False
    np.testing.assert_array_equal(got["created"], np.asarray(jvol.created))
    assert_fusion_matches(np.asarray(jvol.weight), np.asarray(jvol.tsdf),
                          np.asarray(jvol.color), got["weight"],
                          got["tsdf"], got["color"], amb)
    if cap == "binding":
        lost = (out["sparse_box"]["weight"] > 0) & (got["weight"] == 0)
        assert lost.sum() > 1000


def test_sparse_resumes_from_prior_volume(out, inputs):
    frames = inputs["sparse"]
    check_block(out["sparse_resumed"], port_serial_sparse(frames))
    jref = jtb.integrate_frames_sparse(
        jtb.make_block_volume(JCFG), *(j(x) for x in frames), J_INTR,
        max_active=512)
    check_block(out["sparse_resumed"], jref)
    assert out["prior_untouched"]


def test_sparse_keeps_the_dead_row_zero(out, inputs):
    """A prior volume whose dead row nb was dirtied: the combined volume
    restores row nb to zero and uncreated, and equals the clean run."""
    got = out["sparse_dirty_dead_row"]
    nb = got["created"].shape[0] - 1
    assert not got["created"][nb]
    for f in ("tsdf", "weight", "color"):
        assert not got[f][nb].any()
        np.testing.assert_array_equal(got[f], out["sparse"][f])
    for vol in ("sparse", "sparse_box", "sparse_resumed"):
        assert not out[vol]["weight"][-1].any()
        assert not out[vol]["created"][-1]


def test_objects_sparse_parallel(out, inputs):
    d, c, e, o = inputs["objects"]
    tsdf, weight, color, created = out["objects_sparse"]
    for k in range(len(o)):
        got = {"tsdf": tsdf[k], "weight": weight[k], "color": color[k],
               "created": created[k]}
        cfg_o = dataclasses.replace(cases.CFG,
                                    origin=tuple(map(float, o[k])))
        check_block(got, port_serial_sparse((d[k], c[k], e[k]), cfg_o))
        jref = jtb.integrate_frames_sparse(
            jtb.make_block_volume(JCfg(**cfg_o.__dict__)), j(d[k]), j(c[k]),
            j(e[k]), J_INTR, max_active=512)
        check_block(got, jref)
        assert not weight[k][-1].any()


def object_volumes(out, inputs, n):
    tsdf, weight, color, created = out["objects_sparse"]
    origins = inputs["objects"][3]
    proto = make_block_volume(cases.CFG, "cpu")
    return [BlockTSDFVolume(t(tsdf[i]), t(weight[i]), t(color[i]),
                            t(created[i]), tuple(map(float, origins[i])),
                            proto.voxel_size, proto.sdf_trunc,
                            proto.grid_blocks) for i in range(n)]


@pytest.mark.parametrize("n", [4, 3])
def test_extract_meshes_sharded(out, inputs, jmesh4, n):
    """Each volume's soup equals the port's single path bit for bit, and
    JAX's extract_meshes_sharded on the same volumes (masks equal,
    vertices within 1e-6: XLA:CPU contracts the lerp into an FMA)."""
    verts, cols, masks = out["meshes" if n == 4 else "meshes_padded"]
    assert len(masks) == n and masks.sum() > 0
    vols = object_volumes(out, inputs, n)
    jvols = [jtb.BlockTSDFVolume(j(v.tsdf), j(v.weight), j(v.color),
                                 j(v.created), v.origin, v.voxel_size,
                                 v.sdf_trunc, v.grid_blocks) for v in vols]
    jv, _, jm = jsp.extract_meshes_sharded(jvols, jmesh4["data"],
                                           **cases.MESH_CAPS)
    for k, v in enumerate(vols):
        rv, rc, rm = extract_mesh_soup_block(v, **cases.MESH_CAPS)
        np.testing.assert_array_equal(masks[k], rm.numpy())
        m = masks[k]
        np.testing.assert_array_equal(verts[k][m], rv.numpy()[m])
        np.testing.assert_array_equal(cols[k][m], rc.numpy()[m])
        np.testing.assert_array_equal(masks[k], np.asarray(jm[k]))
        np.testing.assert_allclose(verts[k][m], np.asarray(jv[k])[m],
                                   rtol=0, atol=1e-6)


def same_cloud(got, ref_points, ref_raw):
    """The geometric contract of the sharded reconstruct_all: surface counts
    within 1 %, centroids within 2 cm, every point on the reference
    surface (nearest neighbour < 2 mm)."""
    assert abs(got["raw"] - ref_raw) <= 0.01 * ref_raw + 5
    np.testing.assert_allclose(got["points"].mean(axis=0),
                               np.asarray(ref_points).mean(axis=0), atol=0.02)
    d = nn_distance(t(got["points"]).float(), t(ref_points).float())
    assert float(d.max()) < 2e-3


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_reconstruct_all_sharded(out, inputs, jmesh4, backend):
    got = out["reconstruct_all" if backend == "dense"
              else "reconstruct_all_sparse"]
    assert sorted(got) == ["Object_0", "Object_1"]
    ds = CaptureDataset(inputs["dataset"], cases.DS_CAM)
    jcfg = JRec(camera=JCam(**cases.DS_CAM.__dict__),
                tsdf=JCfg(**cases.DS_CFG.tsdf.__dict__),
                surface_samples=cases.DS_CFG.surface_samples)
    jds = JDataset(inputs["dataset"], jcfg.camera)
    if backend == "dense":
        jgot = jsh.reconstruct_all_sharded(jds, jcfg, jmesh4["data"], seed=3)
    else:   # JAX's serial reconstruct_object on its XLA sparse path
        jgot = {name: jrec.reconstruct_object(
            jds, name, jcfg, backend="sparse", auto_origin=True,
            auto_dims=False, seed=3) for name in got}
    for name, res in got.items():
        ref = reconstruct_object(
            ds, name, cases.DS_CFG, backend=backend, auto_origin=True,
            auto_dims=False, device="cpu", draws=t(inputs["draws"]))
        assert res["frames"] == ref.num_frames == jgot[name].num_frames
        same_cloud(res, ref.points, ref.raw_surface_count)
        same_cloud(res, jgot[name].points, jgot[name].raw_surface_count)


def test_reconstruct_all_sharded_sparse_volumes(out, inputs):
    """What reconstruct_all_sharded_sparse fuses, before extraction, so that
    no fusion fault hides in the clouds' geometric slack: each object's
    volume at the origin JAX's auto_volume_origin picks, held to B5's
    tolerances against the port's serial sparse fusion and to JAX's XLA
    integrate_frames_sparse off the rounding ties."""
    vols = out["reconstruct_all_sparse_volumes"]
    assert sorted(vols) == ["Object_0", "Object_1"]
    ds = CaptureDataset(inputs["dataset"], cases.DS_CAM)
    jcfg = JRec(camera=JCam(**cases.DS_CAM.__dict__),
                tsdf=JCfg(**cases.DS_CFG.tsdf.__dict__))
    jds = JDataset(inputs["dataset"], jcfg.camera)
    intr = cases.DS_INTR
    jintr = JIntr.from_config(jcfg.camera)
    for name, got in vols.items():
        batch = ds.load_object(name)
        jbatch = jds.load_object(name)
        np.testing.assert_allclose(
            got["origin"], jrec.auto_volume_origin(jbatch, jintr, jcfg),
            rtol=0, atol=1e-6)
        cfg = dataclasses.replace(cases.DS_CFG.tsdf,
                                  origin=tuple(map(float, got["origin"])))
        frames = (batch.depths, batch.colors, batch.extrinsics)
        serial = port_serial_sparse(frames, cfg, intr)
        check_block(got, serial)
        jvol = jtb.integrate_frames_sparse(
            jtb.make_block_volume(JCfg(**cfg.__dict__)),
            *(j(x) for x in frames), jintr, max_active=serial.num_blocks)
        amb = ambiguous_voxels(voxel_centers(serial.meta), batch.depths,
                               batch.extrinsics, intr, serial.sdf_trunc)
        amb[-1] = False
        np.testing.assert_array_equal(got["created"], np.asarray(jvol.created))
        assert_fusion_matches(np.asarray(jvol.weight), np.asarray(jvol.tsdf),
                              np.asarray(jvol.color), got["weight"],
                              got["tsdf"], got["color"], amb)


def test_dryrun_multichip_on_four_ranks(out):
    dry = out["dryrun"]
    deltas = dry["deltas"]
    assert set(deltas) == {
        "dense_w", "dense_tsdf", "hier_tsdf", "obj0_w", "obj0_tsdf",
        "obj3_w", "obj3_tsdf", "sparse_w", "sparse_tsdf", "sparse_color",
        "sobj_w", "sobj_tsdf", "extract_mask", "extract_verts", "chamfer"}
    assert all(deltas[k] == 0.0 for k in deltas if k.endswith(
        ("_w", "_mask", "_verts")))
    assert dry["weight_sum"] > 0 and dry["sparse_weight_sum"] > 0
    assert dry["triangles"] > 0 and np.isfinite(dry["chamfer"])
