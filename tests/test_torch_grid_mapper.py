"""The port's occupancy-grid mapper against otslam_tpu (CPU).

Both packages step every beam at (k + 0.5) * resolution, take the cell of
each sample as floor((x0 + s * cos - origin) * (1 / resolution)) with a
fused multiply-add, and clip the log-odds scan by scan. The only rounding
that differs is sin/cos: XLA's f32 sin/cos are within one ulp of the
correctly rounded values the port takes (measured on 2 M angles: at most
one ulp, on ~1.3 % of them). So a sample is a *tie* when one ulp of its
sin or cos moves it into another cell, and the log-odds must be equal on
every cell no tie sample can reach.

The survey of tests/test_grid_mapper.py stands its 36 poses on cell edges
of the 0.1 m grid (x, y in {-3, 0, 3}, origin -5.6) and the room's walls
at +-5 m on edges too, so every wall hit is a tie: 799 of the 10 392
touched cells (7.7 %) are tie cells, while 10 cells (0.1 %) differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otslam_tpu.config import LidarConfig as JLidar
from otslam_tpu.core import io as jio
from otslam_tpu.mapping.grid_mapper import GridMapper as JMapper
from otslam_tpu.sim.sensors import render_lidar
from otslam_tpu.sim.world import Scene, cardboard_room
from otslam_tpu_torch.config import LidarConfig
from otslam_tpu_torch.core import io as tio
from otslam_tpu_torch.core.grid import OccupancyGrid2D
from otslam_tpu_torch.mapping import grid_mapper as tgm
from otslam_tpu_torch.mapping.virtual_scan import VirtualScanner

NB, RES, EXTENT = 360, 0.1, (-5.6, 5.6, -5.6, 5.6)


def angles():
    return np.linspace(0, 2 * np.pi, NB, endpoint=False).astype(np.float32)


def survey_poses():
    return np.asarray([(x, y, yaw) for x in (-3.0, 0.0, 3.0)
                       for y in (-3.0, 0.0, 3.0)
                       for yaw in (0.0, 1.57, 3.14, 4.71)], np.float32)


def scans(scene, poses):
    return np.stack([np.asarray(render_lidar(scene, *p, jnp.asarray(angles()),
                                             0.3, 10.0)) for p in poses])


def mappers(extent=EXTENT):
    return (JMapper(extent=extent, resolution=RES, lidar=JLidar(num_beams=NB)),
            tgm.GridMapper(extent=extent, resolution=RES,
                           lidar=LidarConfig(num_beams=NB), device="cpu"))


def tie_cells(rb, poses, origin, shape, res=RES, range_max=10.0):
    """(gh, gw) mask of the cells a tie sample can reach: a sample whose
    cell changes when its sin or cos moves by one f32 ulp, with the port's
    arithmetic (f32 angle sum, f64-exact fused multiply-add, f32 multiply
    by the reciprocal)."""
    gh, gw = shape
    inv = np.float32(np.float32(1.0) / np.float32(res))
    ga = poses[:, 2, None] + angles()[None]
    cos = np.cos(ga.astype(np.float64)).astype(np.float32)
    sin = np.sin(ga.astype(np.float64)).astype(np.float32)
    r = np.nan_to_num(rb, nan=0.0, posinf=0.0)
    has_hit = (r > 0) & (r <= range_max)
    trace = np.where(has_hit, r, np.float32(range_max)).astype(np.float32)
    steps = (np.arange(int(range_max / res) + 1, dtype=np.float32)
             + np.float32(0.5)) * np.float32(res)

    def cell(trig, s, x0, o):
        v = (s.astype(np.float64) * trig + x0).astype(np.float32)
        return np.floor((v - np.float32(o)) * inv).astype(np.int64)

    mask = np.zeros(shape, bool)

    def mark(s, x0, y0, sel, expand):
        cand = []
        for c in (cos, np.nextafter(cos, -2), np.nextafter(cos, 2)):
            for sn in (sin, np.nextafter(sin, -2), np.nextafter(sin, 2)):
                cand.append((cell(expand(c), s, x0, origin[0]),
                             cell(expand(sn), s, y0, origin[1])))
        gx0, gy0 = cand[0]
        tie = np.zeros(gx0.shape, bool)
        for gx, gy in cand:
            tie |= (gx != gx0) | (gy != gy0)
        tie &= sel
        for gx, gy in cand:
            ok = tie & (gx >= 0) & (gx < gw) & (gy >= 0) & (gy < gh)
            mask[gy[ok], gx[ok]] = True

    x0, y0 = poses[:, 0, None], poses[:, 1, None]
    mark(steps[None, None], x0[..., None], y0[..., None],
         steps[None, None] < (trace - np.float32(res))[..., None],
         lambda t: t[..., None])
    mark(trace, x0, y0, has_hit, lambda t: t)
    return mask


@pytest.fixture(scope="module")
def survey():
    poses = survey_poses()
    rb = scans(cardboard_room(), poses)
    j, t = mappers()
    j.add_trajectory(rb, jnp.asarray(angles()), poses)
    t.add_trajectory(rb, angles(), poses)
    return poses, rb, j, t


def assert_equal_off_ties(jl, tl, ties, max_tie_share, max_diff_share):
    touched = (jl != 0) | (tl != 0)
    diff = jl != tl
    print(f"touched {touched.sum()}, tie cells {ties.sum()}, "
          f"differing {diff.sum()}")
    assert touched.sum() > 1000
    np.testing.assert_array_equal(tl[~ties], jl[~ties])
    assert ties.sum() <= max_tie_share * touched.sum()
    assert diff.sum() <= max_diff_share * touched.sum()


def test_add_trajectory_matches_jax(survey):
    poses, rb, j, t = survey
    jl, tl = np.asarray(j.logodds), t.logodds.numpy()
    assert t.logodds.dtype == torch.float32 and tl.shape == jl.shape
    ties = tie_cells(rb, poses, (-5.6, -5.6), jl.shape)
    assert_equal_off_ties(jl, tl, ties, 0.10, 0.005)


def test_add_scan_matches_jax():
    """Scan by scan through add_scan: the same grid as JAX's add_scan
    calls, off the tie cells."""
    poses = survey_poses()[::5]
    rb = scans(cardboard_room(), poses)
    j, t = mappers()
    for r, p in zip(rb, poses):
        j.add_scan(jnp.asarray(r), jnp.asarray(angles()), p)
        t.add_scan(r, angles(), p)
    jl, tl = np.asarray(j.logodds), t.logodds.numpy()
    ties = tie_cells(rb, poses, (-5.6, -5.6), jl.shape)
    assert_equal_off_ties(jl, tl, ties, 0.10, 0.005)
    # add_trajectory over the same scans gives the same grid
    t2 = mappers()[1]
    t2.add_trajectory(rb, angles(), poses)
    np.testing.assert_array_equal(t2.logodds.numpy(), tl)


def test_clip_order_when_cells_saturate():
    """16 scans from one pose: 12 of the room with the box, then 4 after
    the box was removed. The box face saturates at L_MAX and is then
    cleared scan by scan, so clipping after each scan (the JAX lax.scan)
    and clipping the summed deltas once give other grids. The grid's
    origin lies 0.03 m off the walls' cell edges, so no sample here is a
    tie and the whole grid must equal JAX's."""
    pose = np.asarray([[0.33, -0.21, 0.4]], np.float32)
    poses = np.repeat(pose, 16, axis=0)
    rb = np.concatenate([scans(cardboard_room(), poses[:12]),
                         scans(Scene(objects=()), poses[12:])])
    extent = (-5.63, 5.57, -5.63, 5.57)
    j, t = mappers(extent)
    j.add_trajectory(rb, jnp.asarray(angles()), poses)
    t.add_trajectory(rb, angles(), poses)
    jl, tl = np.asarray(j.logodds), t.logodds.numpy()
    assert not tie_cells(rb, poses, (-5.63, -5.63), jl.shape).any()
    np.testing.assert_array_equal(tl, jl)
    # the box face: saturated, then cleared to L_MAX + 4 * L_FREE
    cleared = np.isclose(tl, tgm.L_MAX + 4 * tgm.L_FREE, atol=1e-5)
    assert cleared.sum() >= 3
    free, hit = tgm.scan_masks(torch.from_numpy(rb),
                               torch.from_numpy(angles()),
                               torch.from_numpy(poses), extent[0], extent[2],
                               RES, 10.0, *jl.shape)
    delta = (torch.where(hit, tgm.L_OCC, 0.0)
             + torch.where(free & ~hit, tgm.L_FREE, 0.0)).sum(0)
    once = torch.clamp(delta.reshape(jl.shape), tgm.L_MIN, tgm.L_MAX)
    assert (once.numpy() != jl).sum() >= cleared.sum()


def test_to_grid_and_save_match_jax(survey, tmp_path):
    poses, rb, j, t = survey
    # compare the grids of one log-odds field (JAX's), then the files
    t.logodds = torch.from_numpy(np.array(j.logodds))
    tg, jg = t.to_grid(), j.to_grid()
    assert tg.data.dtype == torch.int8
    np.testing.assert_array_equal(tg.data.numpy(), np.asarray(jg.data))
    assert (tg.resolution, tg.origin) == (jg.resolution, jg.origin)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t.save(str(tmp_path / "t" / "map.pgm"), str(tmp_path / "t" / "map.yaml"))
    j.save(str(tmp_path / "j" / "map.pgm"), str(tmp_path / "j" / "map.yaml"))
    for name in ("map.pgm", "map.yaml"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes())
    meta = tio.read_map_yaml(str(tmp_path / "t" / "map.yaml"))
    back = OccupancyGrid2D.from_pgm(tio.read_pgm(str(tmp_path / "t" /
                                                     "map.pgm")),
                                    meta["resolution"],
                                    tuple(meta["origin"][:2]))
    np.testing.assert_array_equal(back.data, tg.data.numpy())
    assert jio.read_pgm(str(tmp_path / "t" / "map.pgm")).shape == (112, 112)


def test_builds_correct_room_map(survey):
    """The checks of tests/test_grid_mapper.py on the port's own grid."""
    t = survey[3]
    grid = t.to_grid()
    data = grid.data.numpy()
    occ = grid.occupied_world_points()
    assert len(occ) > 100
    d_wall = np.minimum.reduce([np.abs(np.abs(occ[:, 0]) - 5.0),
                                np.abs(np.abs(occ[:, 1]) - 5.0)])
    d_box = np.hypot(occ[:, 0] - 1.5, occ[:, 1] - 0.5)
    assert ((d_wall < 0.25) | (d_box < 0.6)).mean() > 0.97
    assert (d_box < 0.6).sum() > 3
    assert data[data.shape[0] // 2, data.shape[1] // 2] == 0


def test_learned_map_drives_the_virtual_scanner():
    """A map learned from scans of the empty room serves the port's
    VirtualScanner: its scan matches the real one, and the JAX package's
    scanner on JAX's learned map."""
    from otslam_tpu.mapping.virtual_scan import VirtualScanner as JScanner
    empty = Scene(objects=())
    poses = survey_poses()
    rb = scans(empty, poses)
    j, t = mappers()
    j.add_trajectory(rb, jnp.asarray(angles()), poses)
    t.add_trajectory(rb, angles(), poses)
    vs = VirtualScanner(LidarConfig(num_beams=NB), device="cpu")
    vs.set_map(t.to_grid())
    virt = vs.scan(0.0, 0.0, 0.3).numpy()
    real = np.asarray(render_lidar(empty, 0.0, 0.0, 0.3,
                                   jnp.asarray(vs.angles().numpy()), 0.3,
                                   10.0))
    both = np.isfinite(virt) & np.isfinite(real)
    assert both.mean() > 0.9
    assert np.abs(virt[both] - real[both]).max() < 0.3
    jvs = JScanner(JLidar(num_beams=NB))
    jvs.set_map(j.to_grid())
    jvirt = np.asarray(jvs.scan(0.0, 0.0, 0.3))
    np.testing.assert_array_equal(np.isfinite(virt), np.isfinite(jvirt))
    np.testing.assert_allclose(virt[both], jvirt[both], rtol=0, atol=1e-5)


def test_mapper_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgm.GridMapper()
