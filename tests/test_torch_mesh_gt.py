"""The port's mesh readers and reference GT protocol against otslam_tpu
(tests/test_mesh_gt.py's cases on both packages).

core/mesh_io.py is host numpy copied into the port, so every reader and
sampler must return the JAX package's arrays exactly; the GT protocol
(load_and_scale_gt, apply_transform, assemble_mesh_gt) too. The GT's
parity with the analytic scenes is scored by mean nearest-neighbour
distances both ways (a KD-tree), as tests/test_mesh_gt.py's bound.
"""

import os

import numpy as np
import pytest

from otslam_tpu.core import mesh_io as jmesh
from otslam_tpu.eval import scenarios as jsc
from otslam_tpu_torch.core import mesh_io as tmesh
from otslam_tpu_torch.eval import scenarios as tsc
from otslam_tpu_torch.sim.world import cardboard_room, cone_room

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
CUBE_OBJ = os.path.join(ASSETS, "unit_cube.obj")
CUBE_DAE = os.path.join(ASSETS, "unit_cube.dae")
TRANSFORMED_CUBE_DAE = os.path.join(ASSETS, "transformed_cube.dae")
CONE_STL = os.path.join(ASSETS, "cone.stl")
DEG = 180.0 / np.pi


def same_mesh(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)


def test_core_exports_the_mesh_readers():
    import otslam_tpu_torch.core as core
    for name in ("TriMesh", "load_mesh", "read_obj", "read_stl", "read_dae",
                 "sample_mesh_surface", "PointCloud", "OccupancyGrid2D",
                 "T_FIX_OPTICAL", "transform_points"):
        assert hasattr(core, name), name


@pytest.mark.parametrize("path", [CUBE_OBJ, CUBE_DAE, TRANSFORMED_CUBE_DAE,
                                  CONE_STL])
def test_load_mesh_matches_jax(path):
    m = tmesh.load_mesh(path)
    same_mesh(m, jmesh.load_mesh(path))
    assert len(m.faces) > 0


def test_readers_on_written_files_match_jax(tmp_path):
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3/1/1 -2/2/2 -1/3/3\n")
    m = tmesh.read_obj(str(obj))
    assert m.faces.tolist() == [[0, 1, 2]]
    same_mesh(m, jmesh.read_obj(str(obj)))
    stl = tmp_path / "tri.stl"
    stl.write_text("solid t\nfacet normal 0 0 1\nouter loop\n"
                   "vertex 0 0 0\nvertex 1 0 0\nvertex 0 1 0\n"
                   "endloop\nendfacet\nendsolid t\n")
    same_mesh(tmesh.read_stl(str(stl)), jmesh.read_stl(str(stl)))
    # a binary STL with trailing bytes and a 'solid ... facet' header
    data = bytearray(open(CONE_STL, "rb").read() + b"\n\x00\x00")
    data[:25] = b"solid exported facet mesh"
    pad = tmp_path / "pad.stl"
    pad.write_bytes(bytes(data))
    m = tmesh.read_stl(str(pad))
    assert len(m.faces) == 192
    same_mesh(m, jmesh.read_stl(str(pad)))
    bad = tmp_path / "m.xyz"
    bad.write_text("")
    with pytest.raises(ValueError):
        tmesh.load_mesh(str(bad))


def test_dae_scene_transforms_and_units():
    m = tmesh.load_mesh(TRANSFORMED_CUBE_DAE)
    np.testing.assert_allclose(m.vertices.min(0), [0.5, -1.0, -0.5],
                               atol=1e-9)
    np.testing.assert_allclose(m.vertices.max(0), [1.5, 1.0, 0.5], atol=1e-9)


@pytest.mark.parametrize("path, n, seed", [(CUBE_OBJ, 4000, 1),
                                           (CONE_STL, 1000, 3)])
def test_sample_mesh_surface_matches_jax(path, n, seed):
    got = tmesh.sample_mesh_surface(tmesh.load_mesh(path), n, seed=seed)
    want = jmesh.sample_mesh_surface(jmesh.load_mesh(path), n, seed=seed)
    np.testing.assert_array_equal(got, want)
    if path == CUBE_OBJ:
        assert np.isclose(np.abs(got), 0.5, atol=1e-6).any(axis=1).all()


def test_load_and_scale_gt_matches_jax():
    got = tsc.load_and_scale_gt(CONE_STL, (1.0, 2.0, 0.5), n=2000, seed=4,
                                unit_scale=0.01)
    want = jsc.load_and_scale_gt(CONE_STL, (1.0, 2.0, 0.5), n=2000, seed=4,
                                 unit_scale=0.01)
    assert got.dtype == np.float32 and got.shape == (2000, 3)
    np.testing.assert_array_equal(got, want)


def test_assemble_mesh_gt_matches_jax():
    box = cardboard_room().objects[0]
    cones = cone_room().objects
    assets = [(CUBE_OBJ, box.size, (0, 0, box.yaw * DEG), box.center),
              (CUBE_DAE, (0.5, 0.5, 0.5), (10.0, -20.0, 30.0), (1, 2, 3))]
    assets += [(CONE_STL, (0.01, 0.01, 0.01), (0, 0, 0), c.center)
               for c in cones]
    kw = dict(n_per=3000, seed=2, global_rot=(0, 0, 15.0),
              global_trans=(-2.3, -3.5, 0.5))
    got = tsc.assemble_mesh_gt(assets, **kw)
    np.testing.assert_array_equal(got, jsc.assemble_mesh_gt(assets, **kw))
    p = np.array([[1.0, 0.0, 0.0]], np.float32)
    np.testing.assert_allclose(tsc.apply_transform(p, (0, 0, 90), (0, 0, 0)),
                               [[0, 1, 0]], atol=1e-6)


def test_cardboard_obj_gt_matches_analytic():
    box = cardboard_room().objects[0]
    mesh_gt = tsc.assemble_mesh_gt(
        [(CUBE_OBJ, box.size, (0, 0, box.yaw * DEG), box.center)],
        n_per=20000)
    analytic = tsc.sample_object_surfaces([box], 20000, seed=9)
    from scipy.spatial import cKDTree
    acc = cKDTree(analytic).query(mesh_gt)[0].mean() * 100
    comp = cKDTree(mesh_gt).query(analytic)[0].mean() * 100
    assert acc < 0.6 and comp < 0.6, (acc, comp)
