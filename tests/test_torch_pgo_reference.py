"""The port's pose-graph refiner (pipeline/refine.py `_pgo_poses`, the
`reconstruct --refine pgo` path: frame-to-model tracking, loop search,
the pose graph) against the benchmark's plain reference
(benchmark/reference/pgo.py) on seeded tiny captures with seeded planar
pose noise: once on a visiting circle (no loops) and once on a looped
capture whose revisits pair ICP verifies; its spans (refine.track,
refine.model, refine.loops, refine.graph) and counters (track.*, pgo.*),
and the graph's poses brought home by a counted copy.

This file imports neither jax nor otslam_tpu.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.drivers import recon_refine  # noqa: E402
from benchmark.drivers.recon import compare  # noqa: E402
from benchmark.inputs.captures import make_captures  # noqa: E402
from benchmark.inputs.looped import looped  # noqa: E402
from benchmark.reference import pgo as ref_pgo  # noqa: E402
from benchmark.reference import recon as reference  # noqa: E402
from benchmark.reference import refine as ref_refine  # noqa: E402
from otslam_tpu_torch.core.camera import PinholeIntrinsics  # noqa: E402
from otslam_tpu_torch.pipeline import reconstruct as rc  # noqa: E402
from otslam_tpu_torch.pipeline import refine  # noqa: E402
from otslam_tpu_torch.pipeline.dataset import FrameBatch  # noqa: E402
from otslam_tpu_torch.utils import profiling  # noqa: E402
from otslam_tpu_torch.utils.profiling import COUNTS, recording  # noqa: E402

# many small torch ops (the tracker's loop) while other files fill the
# cores of a parallel run: one intra-op thread, as tests/torch_parity.py
torch.set_num_threads(1)

CONFIG = json.loads(
    (REPO / "benchmark/configs/object_recon.refine_pgo.json").read_text())
TRAFFIC = json.loads(
    (REPO / "benchmark/traffic/captures.pgo.json").read_text())
TINY = dict(CONFIG)
TINY["camera"] = dict(CONFIG["camera"], width=160, height=120, fx=141.4002,
                      fy=141.4002, cx=80.5, cy=60.5)
TINY["tsdf"] = dict(CONFIG["tsdf"], voxel_size=0.02, sdf_trunc=0.08,
                    dims=[64, 64, 64], origin=[-0.64, -0.64, -0.14])
TINY["surface_samples"] = 2000
LIMITS = CONFIG["limits"]
SETTINGS = ref_pgo.settings_from_config(TINY)
PGO_SPANS = {"refine.track", "refine.model", "refine.loops", "refine.graph"}


def noisy(truth, seed):
    return recon_refine.noisy(truth, np.random.default_rng([seed, 1]),
                              TRAFFIC["pose_noise_xy_m"],
                              TRAFFIC["pose_noise_yaw_rad"])


def circle(name, seed):
    """One object's tiny visiting-circle capture (the cell's generator)
    at the cell's planar pose noise."""
    caps, _ = make_captures(dict(TRAFFIC, objects=[name]), TINY["camera"],
                            seed, "cpu")
    return noisy(caps[name], seed)


CAPTURES = {"circle": lambda: circle("cone_blue", 2**33 + 21),
            "looped": lambda: looped(TINY["camera"], TRAFFIC, "chair_1",
                                     42)}


def program():
    pcfg = recon_refine.program_config(TINY)
    return pcfg, PinholeIntrinsics.from_config(pcfg.camera)


def batch_of(cap):
    return FrameBatch(cap.depths, cap.colors, cap.extrinsics, cap.poses,
                      [f"{cap.name}_{i + 1}.jpg"
                       for i in range(len(cap.depths))])


def grew(before, name):
    return COUNTS[name] - before.get(name, 0)


@pytest.mark.parametrize("kind", list(CAPTURES))
def test_pgo_poses_match_the_reference(kind):
    """The program's poses from the same noisy priors within the cell's
    pose limits of the reference's (equal on the CPU), its loop counters
    the reference's candidates and verified edges."""
    cap = CAPTURES[kind]()
    pcfg, intr = program()
    pcfg = rc.auto_volume_config(batch_of(cap), intr, pcfg)
    before = dict(COUNTS)
    got = refine._pgo_poses(cap.depths, cap.colors, cap.extrinsics, intr,
                            pcfg, device="cpu")
    intr_r, params = reference.params_from_config(TINY)
    want, rec = ref_pgo.refine_trajectory(cap, intr_r, params, SETTINGS,
                                          "cpu")
    assert got.extrinsics.dtype == np.float32
    gaps = ref_refine.pose_gaps(got.extrinsics, want)
    for key, gap in gaps.items():
        assert gap <= LIMITS["poses"][key]["at_most"], gaps
    # the refiner moved the priors: the comparison is not of the priors
    assert ref_refine.pose_gaps(cap.extrinsics, want)["pose_gap_m"] > 1e-3
    n = len(cap.depths)
    assert grew(before, "pgo.loop_candidates") == rec["loop_candidates"]
    assert grew(before, "pgo.loop_edges") == rec["loop_edges"]
    assert grew(before, "icp.pairs") <= rec["loop_candidates"]
    assert grew(before, "pgo.edges") == n - 1 + rec["loop_edges"]
    assert grew(before, "refine.fallbacks") == rec["dropped"]
    if kind == "looped":
        assert rec["loop_edges"] >= 1
    else:
        assert rec["loop_candidates"] == 0


def test_pgo_cloud_matches_the_reference_fused_at_the_refined_poses():
    """reconstruct_frames(refine="pgo"): the volume sized from the priors,
    the frames fused at the refined poses, the cloud row for row."""
    cap = circle("chair_1", 22)
    pcfg, intr = program()
    draws = torch.rand(pcfg.surface_samples,
                       generator=torch.Generator().manual_seed(22))
    res = rc.reconstruct_frames(batch_of(cap), intr, pcfg, output="cloud",
                                auto_origin=True, refine="pgo",
                                device="cpu", draws=draws)
    intr_r, params = reference.params_from_config(TINY)
    want = ref_refine.fused_cloud(cap, res.extrinsics, intr_r, params, draws,
                                  "cpu")
    gaps = compare(res, want, "cloud")
    for key, gap in gaps.items():
        assert gap <= LIMITS["cloud"][key]["at_most"], gaps
    assert len(res.points) > 100


def test_pgo_spans_counters_and_results_unchanged_by_tracing():
    """One traced reconstruct_frames(refine="pgo") call: refine.track once
    a tracked frame, refine.model once a frame, refine.loops and
    refine.graph once, all under recon.refine; the tracker's and the
    graph's counters; the same poses and cloud as an untraced call."""
    cap = circle("cardboard_box", 23)
    pcfg, intr = program()
    draws = torch.rand(pcfg.surface_samples,
                       generator=torch.Generator().manual_seed(3))

    def call(timings=None):
        return rc.reconstruct_frames(batch_of(cap), intr, pcfg,
                                     auto_origin=True, refine="pgo",
                                     device="cpu", draws=draws,
                                     timings=timings)
    plain = call()
    timings = {}
    traced = call(timings)
    np.testing.assert_array_equal(plain.extrinsics, traced.extrinsics)
    np.testing.assert_array_equal(plain.points, traced.points)
    spans = timings["trace"]["spans"]
    n = len(cap.depths)
    per = {name: [s[1] for s in spans if s[0] == name] for name in PGO_SPANS}
    assert per == {"refine.track": ["recon.refine"] * (n - 1),
                   "refine.model": ["recon.refine"] * n,
                   "refine.loops": ["recon.refine"],
                   "refine.graph": ["recon.refine"]}
    # the graph solves after the loop search, which follows the chain
    t = {name: [s[2:] for s in spans if s[0] == name] for name in PGO_SPANS}
    assert max(e for _, e in t["refine.track"] + t["refine.model"]) \
        <= t["refine.loops"][0][0] <= t["refine.loops"][0][1] \
        <= t["refine.graph"][0][0]
    counts = timings["trace"]["counts"]
    assert counts["track.frames"] == n - 1
    assert counts["track.iterations"] == SETTINGS["max_iterations"] * (n - 1)
    assert counts["pgo.edges"] == n - 1
    assert counts["pgo.iterations"] == SETTINGS["graph_iterations"]
    assert counts.get("pgo.loop_candidates", 0) == 0
    assert counts.get("pgo.loop_edges", 0) == 0


def test_public_pgo_keeps_its_spans_and_brings_the_graph_home_counted(
        monkeypatch):
    """refine_trajectory_pgo's own upload and fusion around the pgo spans;
    the graph's poses (N, 4, 4) come home through device.to_host (which
    counts the copy's bytes and its wait on a card) inside refine.graph,
    and each tracked pose (4, 4) inside its refine.track."""
    cap = circle("cone_red", 24)
    pcfg, intr = program()
    pcfg = rc.auto_volume_config(batch_of(cap), intr, pcfg)
    fetched = []
    orig = refine.to_host

    def to_host(t):
        rec = profiling._REC
        fetched.append((tuple(t.shape), rec._open[-1] if rec else None))
        return orig(t)
    monkeypatch.setattr(refine, "to_host", to_host)
    with recording() as r:
        res = refine.refine_trajectory_pgo(cap.depths, cap.colors,
                                           cap.extrinsics, intr, pcfg,
                                           device="cpu")
    n = len(cap.depths)
    names = [s[0] for s in r.spans]
    for name in ("refine.upload", "refine.fuse", "refine.loops",
                 "refine.graph"):
        assert names.count(name) == 1, name
    assert names.count("refine.track") == n - 1
    assert names.count("refine.model") == n
    assert fetched == [((4, 4), "refine.track")] * (n - 1) \
        + [((n, 4, 4), "refine.graph")]
    assert res.volume is not None and len(res.fitness) == n - 1
