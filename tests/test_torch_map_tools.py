"""The port's 2D map IO, selective merge and hybrid map against otslam_tpu
(tests/test_core.py's and tests/test_mapping.py's inputs, CPU).

All of it is host numpy copied into the port, so the files, images and
clouds must equal the JAX package's exactly.
"""

import numpy as np
import pytest

from otslam_tpu.core import io as jio
from otslam_tpu.core.grid import OccupancyGrid2D as JGrid
from otslam_tpu.mapping import hybrid as jhy
from otslam_tpu.mapping import merge as jme
from otslam_tpu_torch.core import io as tio
from otslam_tpu_torch.core.grid import OccupancyGrid2D
from otslam_tpu_torch.mapping import hybrid as thy
from otslam_tpu_torch.mapping import merge as tme


def test_pgm_roundtrip_across_packages(tmp_path, rng):
    img = rng.integers(0, 255, (32, 40), dtype=np.uint8)
    tio.write_pgm(str(tmp_path / "t.pgm"), img)
    jio.write_pgm(str(tmp_path / "j.pgm"), img)
    assert (tmp_path / "t.pgm").read_bytes() == (tmp_path / "j.pgm").read_bytes()
    np.testing.assert_array_equal(tio.read_pgm(str(tmp_path / "j.pgm")), img)
    np.testing.assert_array_equal(jio.read_pgm(str(tmp_path / "t.pgm")), img)


def test_ascii_pgm_with_comments(tmp_path):
    p = tmp_path / "a.pgm"
    p.write_bytes(b"P2\n# made by hand\n3 2\n255\n0 100 205\n254 7 255\n")
    np.testing.assert_array_equal(tio.read_pgm(str(p)),
                                  [[0, 100, 205], [254, 7, 255]])
    np.testing.assert_array_equal(tio.read_pgm(str(p)), jio.read_pgm(str(p)))
    bad = tmp_path / "b.pgm"
    bad.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    with pytest.raises(ValueError):
        tio.read_pgm(str(bad))


def test_map_yaml_roundtrip_across_packages(tmp_path):
    args = ("map.pgm", 0.05, (-10.0, -10.0, 0.0))
    tio.write_map_yaml(str(tmp_path / "t.yaml"), *args)
    jio.write_map_yaml(str(tmp_path / "j.yaml"), *args)
    assert (tmp_path / "t.yaml").read_text() == \
        (tmp_path / "j.yaml").read_text()
    d = tio.read_map_yaml(str(tmp_path / "j.yaml"))
    assert d == jio.read_map_yaml(str(tmp_path / "t.yaml"))
    assert d["resolution"] == 0.05 and d["origin"][0] == -10.0


def test_smart_paste_matches_jax():
    base = np.full((10, 10), 254, np.uint8)
    over = np.full((10, 10), 205, np.uint8)   # all unknown
    over[2, 2] = 0                            # one known occupied pixel
    over[3, 3] = 209                          # inside the +/-5 band
    out = tme.smart_paste(base.copy(), over, 0, 0, 10, 10)
    np.testing.assert_array_equal(
        out, jme.smart_paste(base.copy(), over, 0, 0, 10, 10))
    assert out[2, 2] == 0 and out[3, 3] == 254
    # a rect reaching outside the image is a no-op
    out = tme.smart_paste(base.copy(), np.zeros_like(base), 5, 5, 10, 10)
    assert (out == 254).all()


@pytest.mark.parametrize("new_shape", [(20, 20), (13, 27)])
def test_selective_merge_matches_jax(rng, new_shape):
    old = np.full((20, 20), 254, np.uint8)
    old[::3] = 205
    new = rng.choice(np.array([0, 205, 207, 254], np.uint8), new_shape)
    regions = [(0, 0, 5, 5), (10, 10, 4, 4), (18, 18, 5, 5)]
    out = tme.selective_merge(old, new, regions)
    np.testing.assert_array_equal(out, jme.selective_merge(old, new, regions))
    assert (old[::3] == 205).all()            # input untouched


def grids(img, res, origin):
    return (OccupancyGrid2D.from_pgm(img, res, origin),
            JGrid.from_pgm(img, res, origin))


def test_map_to_cloud_matches_jax(rng):
    img = rng.choice(np.array([0, 205, 254], np.uint8), (30, 24))
    tg, jg = grids(img, 0.05, (-1.0, -2.0))
    for a, b in zip(thy.map_to_cloud(tg), jhy.map_to_cloud(jg)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    img = np.full((10, 8), 254, np.uint8)
    img[7, 2] = 0
    pts, cols = thy.map_to_cloud(grids(img, 0.05, (-1.0, -2.0))[0])
    np.testing.assert_allclose(pts, [[-0.9, -1.9, 0.0]], atol=1e-6)
    np.testing.assert_allclose(cols, [[0.2, 0.2, 0.2]])


def test_build_hybrid_map_matches_jax(tmp_path, rng):
    img = np.full((20, 20), 254, np.uint8)
    img[5:8, 5:8] = 0
    obj_dir = str(tmp_path / "objs")
    tio.write_ply(obj_dir + "/Object_1.ply",
                  rng.standard_normal((20, 3)).astype(np.float32))
    tio.write_ply(obj_dir + "/Object_0.ply",
                  rng.standard_normal((50, 3)).astype(np.float32))
    tg, jg = grids(img, 0.05, (0.0, 0.0))
    align = {"Object_1.ply": (0.5, -0.25, 90.0)}
    for kw in ({}, {"alignments": align}):
        pts, cols = thy.build_hybrid_map(tg, obj_dir, **kw)
        jpts, jcols = jhy.build_hybrid_map(jg, obj_dir, **kw)
        assert len(pts) == 9 + 50 + 20
        np.testing.assert_array_equal(pts, jpts)
        np.testing.assert_array_equal(cols, jcols)
        np.testing.assert_allclose(cols[9:], [[1.0, 0.0, 0.0]] * 70)


def test_hybrid_map_from_files_matches_jax(tmp_path, rng):
    img = np.full((16, 16), 254, np.uint8)
    img[4:6, 4:6] = 0
    tio.write_pgm(str(tmp_path / "map.pgm"), img)
    tio.write_map_yaml(str(tmp_path / "map.yaml"), "map.pgm", 0.05,
                       (1.0, -2.0, 0.0))
    objdir = str(tmp_path / "objs")
    tio.write_ply(objdir + "/Object_0.ply",
                  rng.standard_normal((30, 3)).astype(np.float32))
    files = (str(tmp_path / "map.yaml"), str(tmp_path / "map.pgm"), objdir)
    pts, cols = thy.hybrid_map_from_files(*files, str(tmp_path / "t.ply"))
    jpts, jcols = jhy.hybrid_map_from_files(*files, str(tmp_path / "j.ply"))
    np.testing.assert_array_equal(pts, jpts)
    assert len(pts) == 4 + 30
    # the files differ only in their header comment
    t_ply = tio.read_ply(str(tmp_path / "t.ply"))
    j_ply = jio.read_ply(str(tmp_path / "j.ply"))
    assert sorted(t_ply) == sorted(j_ply)
    for k in t_ply:
        np.testing.assert_array_equal(t_ply[k], j_ply[k])
