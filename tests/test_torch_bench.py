"""The port's benchmark (otslam_tpu_torch/bench.py) against the JAX
package's (the repository's root bench.py and bench_icp.py) on the CPU.

The workloads first, on the same numpy inputs at a small size: the capture
poses bit for bit; the cube frames at 160x120 (hit masks equal off the
pixels whose entry/exit or near-clip margin is within 1e-6 m, depth within
2e-6 m); the fused block volume (1 cm, 4 cm truncation, cut to a 64^3
grid around the cube) at tests/torch_parity.py's tolerances off the
rounding ties; ICP at 2 000 points, windowed and full scan (transformation
within 1e-4, equal iterations); the perception inputs and batch at K = 4;
the block-mesh soup of a JAX-fused volume (masks equal, vertices and
colours within 1e-6). Then the record main prints, with the measure
functions at these sizes: complete, failed, the plausibility gate, and no
file of the JAX bench touched.
"""

import functools
import hashlib
import importlib.util
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otslam_tpu.config import ChangeDetectConfig as JCDC
from otslam_tpu.config import LidarConfig as JLidar
from otslam_tpu.config import TSDFConfig as JTCfg
from otslam_tpu.kernels import marching as jm
from otslam_tpu.kernels import tsdf_block as jtb
from otslam_tpu.kernels.icp import icp_point_to_point as j_icp
from otslam_tpu.kernels.nn import auto_nn_window as j_auto_nn_window
from otslam_tpu.mapping.perception import perception_ticks as j_ticks
from otslam_tpu.sim.world import Box as JBox
from otslam_tpu.sim.world import Scene as JScene
from otslam_tpu_torch import bench
from otslam_tpu_torch.config import TSDFConfig
from otslam_tpu_torch.kernels import marching as tm
from otslam_tpu_torch.kernels.nn import auto_nn_window
from otslam_tpu_torch.kernels.tsdf_block import BlockTSDFVolume
from otslam_tpu_torch.mapping.perception import perception_ticks
from torch_parity import (J_SMALL, T_SMALL, ambiguous_voxels,
                          assert_fusion_matches, voxel_centers)

ROOT = Path(__file__).resolve().parents[1]
N_FRAMES = 4
ICP_POINTS = 2_000
TICKS = 4
# the bench's volume (1 cm, 4 cm truncation) cut to the cube's surroundings
VOL = dict(dims=(64, 64, 64), origin=(-0.32, -0.32, -0.12))
TCFG, JCFG = TSDFConfig(**VOL), JTCfg(**VOL)
TIE_M = 1e-6


def load_root(name: str):
    """A root script as a module, loaded by path as
    tests/test_bench_guard.py loads bench.py."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jbench():
    return load_root("bench")


@pytest.fixture(scope="module")
def frames():
    """The port's cube frames at 160x120 as numpy."""
    return tuple(x.numpy() for x in bench._make_frames(T_SMALL, N_FRAMES,
                                                       "cpu"))


@pytest.fixture(scope="module")
def jax_volume(frames):
    d, c, e = (jnp.asarray(x) for x in frames)
    vol = jtb.make_block_volume(JCFG)
    return jtb.integrate_frames_sparse(vol, d, c, e, J_SMALL,
                                       max_active=vol.num_blocks)


def test_frame_poses_equal_jax(jbench):
    for n in (1, N_FRAMES, 384):
        for port, ref in zip(bench._frame_poses(n), jbench._frame_poses(n)):
            assert port.dtype == ref.dtype
            np.testing.assert_array_equal(port, ref)


def entry_margins(n: int) -> np.ndarray:
    """(n, H, W) float64 distance of each pixel from a hit decision: the
    smaller of |tmax - tmin| and |tmin - 0.1| of its ray against the cube."""
    Rs, eyes, _ = bench._frame_poses(n)
    rays = T_SMALL.pixel_rays_np().astype(np.float64)
    lo, hi = np.array([-0.2, -0.2, 0.0]), np.array([0.2, 0.2, 0.4])
    out = []
    with np.errstate(divide="ignore", invalid="ignore"):
        for R, eye in zip(Rs.astype(np.float64), eyes.astype(np.float64)):
            dirs = rays @ R.T
            t1, t2 = (lo - eye) / dirs, (hi - eye) / dirs
            tmin = np.minimum(t1, t2).max(-1)
            tmax = np.maximum(t1, t2).min(-1)
            out.append(np.minimum(np.abs(tmax - tmin), np.abs(tmin - 0.1)))
    return np.nan_to_num(np.stack(out), nan=0.0)


def test_make_frames_match_jax(jbench, frames):
    jd, jc, je = (np.asarray(x) for x in jbench._make_frames(J_SMALL,
                                                             N_FRAMES))
    d, c, e = frames
    assert d.shape == jd.shape == (N_FRAMES, 120, 160)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(e, je)
    ties = entry_margins(N_FRAMES) <= TIE_M
    assert ties.sum() <= 1e-3 * ties.size
    hit, jhit = d > 0, jd > 0
    assert 0.05 < jhit.mean() < 0.95
    np.testing.assert_array_equal(hit[~ties], jhit[~ties])
    both = hit & jhit & ~ties
    np.testing.assert_allclose(d[both], jd[both], rtol=0, atol=2e-6)


def test_fused_volume_matches_jax(frames, jax_volume):
    d, c, e = frames
    vol = bench.fuse_cube(TCFG, *(torch.from_numpy(x) for x in frames),
                          T_SMALL)
    np.testing.assert_array_equal(vol.created.numpy(),
                                  np.asarray(jax_volume.created))
    amb = ambiguous_voxels(voxel_centers(vol.meta), d, e, T_SMALL,
                           vol.sdf_trunc)
    amb[-1] = False                      # the dead row: zero in both
    assert_fusion_matches(np.asarray(jax_volume.weight),
                          np.asarray(jax_volume.tsdf),
                          np.asarray(jax_volume.color), vol.weight.numpy(),
                          vol.tsdf.numpy(), vol.color.numpy(), amb)


@pytest.mark.parametrize("mode", ["windowed", "full_scan"])
def test_icp_matches_jax(mode):
    src, dst = bench._icp_clouds(ICP_POINTS)
    window, axis = auto_nn_window(src, dst, bench.ICP_THRESHOLD)
    assert (window, axis) == j_auto_nn_window(src, dst, bench.ICP_THRESHOLD)
    kw = {"nn_window": window, "nn_axis": axis} if mode == "windowed" else {}
    res = bench.run_icp(torch.from_numpy(src), torch.from_numpy(dst),
                        bench.ICP_ITERATIONS, **kw)
    ref = j_icp(jnp.asarray(src), jnp.asarray(dst),
                threshold=bench.ICP_THRESHOLD,
                max_iterations=bench.ICP_ITERATIONS, relative_fitness=0.0,
                relative_rmse=0.0, chunk=4096, **kw)
    assert res.iterations == int(ref.iterations)
    np.testing.assert_allclose(res.transformation.numpy(),
                               np.asarray(ref.transformation), rtol=0,
                               atol=1e-4)
    assert float(res.fitness) == pytest.approx(1.0)


def jax_perception_inputs(k: int):
    """bench.py's measure_perception_ticks inputs in the JAX package."""
    lidar = JLidar()
    cfg = JCDC()
    scene = JScene(objects=(JBox((1.5, 0.5, 0.15), (0.5, 0.4, 0.3), 0.3,
                                 (0.7, 0.6, 0.4), "box"),))
    grid = scene.occupancy_grid(0.05)
    n = lidar.num_beams
    inc = (lidar.angle_max - lidar.angle_min) / n
    angles = jnp.asarray(lidar.angle_min + np.arange(n) * inc, jnp.float32)
    rng = np.random.default_rng(0)
    reals = jnp.asarray(rng.uniform(0.5, 8.0, (k, n)).astype(np.float32))
    poses = jnp.asarray(
        np.stack([np.linspace(-1, 1, k), np.linspace(1, 0, k),
                  np.linspace(-1.5, -1.0, k)], axis=1).astype(np.float32))
    dts = jnp.full((k,), 0.2, jnp.float32)
    gh, gw = cfg.grid_cells
    return (jnp.asarray(grid.data), float(grid.resolution),
            float(grid.origin[0]), float(grid.origin[1]),
            jnp.zeros((gh, gw), jnp.float32), jnp.zeros((gh, gw), jnp.float32),
            reals, poses, dts, angles, cfg, float(lidar.range_max))


def test_perception_inputs_and_batch_match_jax():
    port = bench.perception_inputs(TICKS, "cpu")
    ref = jax_perception_inputs(TICKS)
    assert port[0].shape == (208, 208) and port[0].dtype == torch.int8
    assert port[6].shape == (TICKS, 1440)
    for i, (p, r) in enumerate(zip(port, ref)):
        if i == 10:                      # the ChangeDetectConfig
            assert p.__dict__ == r.__dict__
        elif isinstance(p, torch.Tensor):
            np.testing.assert_array_equal(p.numpy(), np.asarray(r))
        else:
            assert p == r
    batch = perception_ticks(*port)
    jbatch = j_ticks(*ref)
    for name in batch._fields:
        np.testing.assert_array_equal(getattr(batch, name).numpy(),
                                      np.asarray(getattr(jbatch, name)),
                                      err_msg=name)
    # 4 ticks of 0.2 s confirm nothing yet (2 s threshold): evidence only
    assert float(batch.new_grid.sum()) > 0 and float(batch.gone_grid.sum()) > 0
    assert bool(torch.isfinite(batch.virtual).any())


def test_block_soup_matches_jax(jax_volume):
    v = jax_volume
    vol = BlockTSDFVolume.from_numpy(
        np.asarray(v.tsdf), np.asarray(v.weight), np.asarray(v.color),
        np.asarray(v.created), v.origin, v.voxel_size, v.sdf_trunc,
        v.grid_blocks, device="cpu")
    mb, mc = tm.auto_mesh_block_config(vol)
    assert (mb, mc) == jm.auto_mesh_block_config(v)
    verts, cols, mask = (a.numpy() for a in
                         tm.extract_mesh_soup_block(vol, mb, mc))
    jverts, jcols, jmask = (np.asarray(a) for a in
                            jm.extract_mesh_soup_block(v, mb, mc))
    np.testing.assert_array_equal(mask, jmask)
    assert jmask.sum() > 100
    np.testing.assert_allclose(verts[jmask], jverts[jmask], rtol=0, atol=1e-6)
    np.testing.assert_allclose(cols[jmask], jcols[jmask], rtol=0, atol=1e-6)


# --- the record ---------------------------------------------------------------

JAX_RECORDS = ("BENCH_TUNED.json", "BENCH_HISTORY.jsonl")


def records_digest() -> dict:
    return {n: hashlib.sha256((ROOT / n).read_bytes()).hexdigest()
            for n in JAX_RECORDS}


def lines(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines()]


def test_main_prints_a_complete_record(monkeypatch, capsys):
    """main("cpu") with every workload at the sizes above (ICP at 5
    iterations, one extraction a timed mesh call): a running first line without numbers, a snapshot as each
    metric lands, a complete last line with every key, no cached numbers,
    and the JAX bench's record files untouched."""
    before = records_digest()
    for name, kw in (("measure_fusion", dict(n_frames=N_FRAMES, intr=T_SMALL,
                                             cfg=TCFG)),
                     ("measure_icp", dict(n=ICP_POINTS, iterations=5)),
                     ("measure_perception_ticks", dict(k=TICKS)),
                     ("measure_mesh", dict(n_frames=N_FRAMES, intr=T_SMALL,
                                           cfg=TCFG, reps=1))):
        monkeypatch.setattr(bench, name,
                            functools.partial(getattr(bench, name), **kw))
    assert bench.main("cpu") == 0
    recs = lines(capsys.readouterr().out)
    assert [r["status"] for r in recs] == ["running", "fusion", "icp",
                                           "perception", "mesh", "complete"]
    assert not set(recs[0]) & set(bench.PLAUSIBILITY_CEILINGS)
    last = recs[-1]
    for keys in bench._METRIC_KEYS.values():
        assert set(keys) <= set(last)
    assert last["measured"] == list(bench._METRIC_KEYS)
    assert last["device"] == "cpu"
    assert bench.record_plausible(last) == (True, "ok")
    assert not any("cached" in k for r in recs for k in r)
    assert last["fusion_config"]["n_frames"] == N_FRAMES
    assert last["fusion_config"]["max_active"] is None
    assert last["fusion_config"]["pairs"] > last["fusion_config"]["blocks"]
    assert last["icp_config"]["iterations"]["windowed"] == [5, 5, 5]
    assert len(last["health"]["fusion_rep_spread_s"]) == 5
    assert records_digest() == before


def stub(out: dict):
    return lambda device: dict(out, health={})


GOOD = {
    "measure_fusion": {"value": 1000.0, "vs_baseline": 2.0,
                       "fusion_config": {}},
    "measure_icp": {"icp_iterations_per_sec": 500.0, "icp_unit": "iters/s",
                    "icp_config": {}},
    "measure_perception_ticks": {"perception_ticks_per_sec": 900.0,
                                 "perception_unit": "ticks/s"},
    "measure_mesh": {"mesh_extracts_per_sec": 100.0, "mesh_unit": "x/s",
                     "mesh_block_extracts_per_sec": 100.0,
                     "mesh_block_unit": "x/s",
                     "mesh_batch_extracts_per_sec": 100.0,
                     "mesh_batch_unit": "x/s"},
}


@pytest.mark.parametrize("fault", ["raises", "implausible"])
def test_a_failed_metric_exits_1(monkeypatch, capsys, fault):
    """ICP fails (an exception, or a rate above its ceiling): the last line
    says "failed" with icp_error, no ICP rate is printed, the metrics after
    it never run, and main returns 1."""
    for name, out in GOOD.items():
        monkeypatch.setattr(bench, name, stub(out))
    if fault == "raises":
        def broken(device):
            raise RuntimeError("kernel fault")
    else:
        broken = stub(dict(GOOD["measure_icp"],
                           icp_iterations_per_sec=1e9))
    monkeypatch.setattr(bench, "measure_icp", broken)
    monkeypatch.setattr(bench, "measure_perception_ticks",
                        lambda device: pytest.fail("ran after a failure"))
    assert bench.main("cpu") == 1
    recs = lines(capsys.readouterr().out)
    last = recs[-1]
    assert last["status"] == "failed"
    assert last["measured"] == ["fusion"]
    assert ("kernel fault" if fault == "raises" else "above physical "
            "ceiling") in last["icp_error"]
    assert not any("icp_iterations_per_sec" in r for r in recs)


def healthy() -> dict:
    rec = {}
    for out in GOOD.values():
        rec.update(out)
    return rec


@pytest.mark.parametrize("key,value,reason", [
    (None, None, "ok"),
    ("value", 7e5, "above physical ceiling"),
    ("icp_iterations_per_sec", 3e6, "above physical ceiling"),
    ("mesh_batch_extracts_per_sec", 3e4, "above physical ceiling"),
    ("perception_ticks_per_sec", None, "missing"),
    ("value", float("nan"), "non-finite or non-positive"),
    ("value", float("inf"), "non-finite or non-positive"),
    ("mesh_extracts_per_sec", 0.0, "non-finite or non-positive"),
    ("icp_iterations_per_sec", -5.0, "non-finite or non-positive"),
    ("value", "fast", "non-numeric"),
    ("value", [1.0], "non-numeric"),
])
def test_record_plausible(key, value, reason):
    rec = healthy()
    if key is not None:
        rec[key] = value
    ok, why = bench.record_plausible(rec)
    assert ok == (reason == "ok") and reason in why
    if key is not None:
        # a gate over the other keys, as main's per-metric gate, passes
        others = [k for k in bench.PLAUSIBILITY_CEILINGS if k != key]
        assert bench.record_plausible(rec, others) == (True, "ok")


def test_ceilings_follow_the_h100_bandwidth():
    c = bench.PLAUSIBILITY_CEILINGS
    assert c["value"] == pytest.approx(6.8e5, rel=0.01)
    assert c["icp_iterations_per_sec"] == pytest.approx(2.8e6, rel=0.01)
    assert c["mesh_extracts_per_sec"] == pytest.approx(2.5e4, rel=0.01)
    assert c["perception_ticks_per_sec"] == 1e6
    assert all(math.isfinite(v) for v in c.values())
