"""The port's dense baseline, report and headline against otslam_tpu (CPU).

Tolerances:
* ``hybrid_map_size_stats``, ``REFERENCE_RESULTS`` and
  ``print_summary_table``: equal.
* ``dense_room_reconstruction`` with JAX's draws: every sampled point
  within 1e-5 m, off the rows next to a fusion-tie voxel
  (tests/torch_parity.py), whose share stays below 5 %.
* ``headline_report`` at a 160x120 camera with JAX's draws: the same
  object keys, accuracy and completeness within 0.01 cm, ``dense_bytes``
  equal apart from the PLY header (the port's comment line names
  otslam_tpu_torch: 6 bytes more a file), ``hybrid_bytes`` within 0.5 %
  and every reduction percentage within 0.05 points.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from otslam_tpu.config import CameraConfig as JCam
from otslam_tpu.core import io as jio
from otslam_tpu.eval import baseline as jbase
from otslam_tpu.eval import headline as jhead
from otslam_tpu.eval import report as jreport
from otslam_tpu.eval.metrics import EvalMetrics as JMetrics
from otslam_tpu.eval.scenarios import sample_object_surfaces
from otslam_tpu.sim.sensors import look_at_pose, render_rgbd
from otslam_tpu.sim.world import cardboard_room, cone_room
from otslam_tpu_torch.config import CameraConfig
from otslam_tpu_torch.eval import baseline as tbase
from otslam_tpu_torch.eval import headline as thead
from otslam_tpu_torch.eval import report as treport
from otslam_tpu_torch.eval.metrics import EvalMetrics
from otslam_tpu_torch.pipeline import reconstruct as trec
from otslam_tpu_torch.sim import world as tworld
from torch_parity import J_SMALL, SMALL_CAM, T_SMALL, ambiguous_voxels

SAMPLES = 5000
PERCENTS = ("size_reduction_percent", "size_reduction_downsampled_percent",
            "size_reduction_voxel_percent")


def jax_draws(n, seed=0):
    return torch.tensor(np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), (n,))))


def header_bytes(path) -> int:
    with open(path, "rb") as f:
        data = f.read(4096)
    return data.index(b"end_header\n") + len(b"end_header\n")


def test_hybrid_map_size_stats_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    jio.write_pgm(str(tmp_path / "map.pgm"), np.full((200, 200), 254,
                                                      np.uint8))
    for k in range(3):
        jio.write_ply(str(tmp_path / "objs" / f"Object_{k}.ply"),
                      rng.standard_normal((500 * (k + 1), 3)))
    jio.write_ply(str(tmp_path / "dense.ply"),
                  rng.standard_normal((200000, 3)))
    args = (str(tmp_path / "map.pgm"), str(tmp_path / "objs"),
            str(tmp_path / "dense.ply"))
    t, j = tbase.hybrid_map_size_stats(*args), jbase.hybrid_map_size_stats(
        *args)
    assert (t.hybrid_bytes, t.dense_bytes, t.reduction_percent,
            t.breakdown) == (j.hybrid_bytes, j.dense_bytes,
                             j.reduction_percent, j.breakdown)
    assert t.reduction_percent > 90.0


def room_frames(n=4):
    scene = cardboard_room()
    ds, cs, es = [], [], []
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = np.array([2.5 * np.cos(a), 2.5 * np.sin(a), 1.0])
        pose = look_at_pose(eye, np.array([0.0, 0.0, 0.5]))
        d, c = render_rgbd(scene, pose, J_SMALL, far=8.0)
        ds.append(np.asarray(d))
        cs.append(np.asarray(c))
        es.append(np.linalg.inv(pose).astype(np.float32))
    return np.stack(ds), np.stack(cs), np.stack(es)


def test_dense_room_reconstruction_matches_jax():
    d, c, e = room_frames()
    bounds = (-5.2, 5.2, -5.2, 5.2, -0.1, 2.1)
    vs, trunc, n = 0.08, 0.32, 20000
    kw = dict(room_bounds=bounds, voxel_size=vs, sdf_trunc=trunc, samples=n)
    jp, jc = jbase.dense_room_reconstruction(d, c, e, J_SMALL, **kw)
    tp, tc = tbase.dense_room_reconstruction(d, c, e, T_SMALL,
                                             draws=jax_draws(n),
                                             device="cpu", **kw)
    assert tp.shape == (n, 3) and tp.dtype == torch.float32
    tp, tc = tp.numpy(), tc.numpy()
    assert np.isfinite(tp).all()
    # the voxels around each sampled point: a row next to a tie voxel may
    # interpolate other values in the two packages
    base = np.floor((jp - np.asarray(bounds[::2])) / vs - 0.5)
    corners = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                       -1).reshape(8, 3)
    centres = (np.asarray(bounds[::2]) + (base[:, None] + corners + 0.5)
               * vs)
    amb = ambiguous_voxels([centres[..., k] for k in range(3)], d, e,
                           J_SMALL, trunc).any(axis=1)
    print(f"rows next to a tie voxel: {amb.sum()} of {n}")
    assert amb.mean() < 0.05
    np.testing.assert_allclose(tp[~amb], jp[~amb], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc[~amb], jc[~amb], rtol=0, atol=1e-5)


def test_summary_table_and_plot(tmp_path, capsys):
    assert treport.REFERENCE_RESULTS == jreport.REFERENCE_RESULTS
    vals = {"Cardboard Box": (0.4361, 1.0182), "Cone": (2.48, 4.18)}
    base = {"Cone": (4.73, 1.45)}
    t = treport.print_summary_table(
        {k: EvalMetrics(*v) for k, v in vals.items()},
        {k: EvalMetrics(*v) for k, v in base.items()})
    t_out = capsys.readouterr().out
    j = jreport.print_summary_table(
        {k: JMetrics(*v) for k, v in vals.items()},
        {k: JMetrics(*v) for k, v in base.items()})
    assert t == j and t_out == capsys.readouterr().out == j + "\n"
    for name, ref in (("plain.png", None),
                      ("ref.png", treport.REFERENCE_RESULTS)):
        out = treport.plot_results({k: EvalMetrics(*v)
                                    for k, v in vals.items()},
                                   str(tmp_path / "plots" / name),
                                   baseline=ref)
        with open(out, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def run_both(tmp_path, jscene, tscene, **kw):
    """headline_report in both packages at a 160x120 camera; the port's
    object clouds take JAX's sample draws."""
    small = dict(cam=None, frames_per_object=4, room_frames=4,
                 object_samples=SAMPLES, **kw)
    jrep = jhead.headline_report(str(tmp_path / "jax"), scene_fn=jscene,
                                 **dict(small, cam=JCam(**SMALL_CAM)))
    draws = functools.partial(trec.extract_filtered_cloud,
                              draws=jax_draws(SAMPLES))
    timings = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(thead, "extract_filtered_cloud", draws)
        trep = thead.headline_report(str(tmp_path / "port"),
                                     scene_fn=tscene, device="cpu",
                                     timings=timings,
                                     **dict(small, cam=CameraConfig(
                                         **SMALL_CAM)))
    print(json.dumps(jrep), json.dumps(trep), timings)
    return jrep, trep, timings


def assert_reports_agree(jrep, trep, tmp_path):
    assert sorted(trep) == sorted(jrep)
    assert sorted(trep["objects"]) == sorted(jrep["objects"])
    for name, j in jrep["objects"].items():
        t = trep["objects"][name]
        assert sorted(t) == sorted(j), name
        for k, v in j.items():
            if k.endswith("_cm"):
                assert abs(t[k] - v) <= 0.01, (name, k, t[k], v)
            else:
                assert t[k] == v, (name, k)
    for k in ("combined_accuracy_cm", "combined_completeness_cm"):
        assert abs(trep[k] - jrep[k]) <= 0.01, k
    for k in PERCENTS:
        assert abs(trep[k] - jrep[k]) <= 0.05, k
    assert abs(trep["hybrid_bytes"] - jrep["hybrid_bytes"]) \
        <= 0.005 * jrep["hybrid_bytes"]
    dense_t = str(tmp_path / "port" / "dense.ply")
    dense_j = str(tmp_path / "jax" / "dense.ply")
    assert trep["dense_bytes"] - header_bytes(dense_t) == \
        jrep["dense_bytes"] - header_bytes(dense_j)
    assert trep["hybrid_map_path"] == str(tmp_path / "port" / "hybrid.ply")
    assert os.path.getsize(trep["hybrid_map_path"]) > 0


def test_headline_report_matches_jax(tmp_path):
    jrep, trep, timings = run_both(tmp_path, cardboard_room,
                                   tworld.cardboard_room)
    assert_reports_agree(jrep, trep, tmp_path)
    assert set(timings) == {"render", "fuse", "extract", "ply_write", "map",
                            "dense_sweep", "downsample", "eval"}
    m = trep["objects"]["Object_0"]
    assert m["proposal_accuracy_cm"] < 1.5 and "dense_accuracy_cm" in m
    assert trep["dense_bytes"] > trep["hybrid_bytes"]


def test_headline_from_objects_dir_matches_jax(tmp_path):
    """objects_dir mode on the cone room: the first cone's sampled surface
    as a mission's Object_0.ply; the second cone has no cloud."""
    scene = cone_room()
    pts = sample_object_surfaces([scene.objects[0]], 3000, seed=1)
    pts = pts[pts[:, 2] >= 0.03]
    jio.write_ply(str(tmp_path / "recon" / "Object_0.ply"), pts,
                  colors=np.full_like(pts, 0.5))
    jrep, trep, _ = run_both(tmp_path, cone_room, tworld.cone_room,
                             objects_dir=str(tmp_path / "recon"))
    assert_reports_agree(jrep, trep, tmp_path)
    assert trep["objects"]["cone_1"]["cloud"] == "Object_0"
    assert trep["objects"]["cone_2"] == {"scanned": False}


def test_without_cuda_the_baseline_and_headline_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbase.dense_room_reconstruction(np.zeros((1, 3, 4)),
                                        np.zeros((1, 3, 4, 3)),
                                        np.eye(4)[None], T_SMALL,
                                        (0, 1, 0, 1, 0, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        thead.headline_report(str(tmp_path))
    assert not os.listdir(tmp_path)
