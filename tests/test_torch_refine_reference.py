"""The port's ICP pose refiner (pipeline/refine.py refine_trajectory, the
`reconstruct --refine icp` path) against the benchmark's plain reference
(benchmark/reference/refine.py) on seeded tiny captures with seeded planar
pose noise, its spans and counters (icp.iterations, icp.pairs,
refine.fallbacks, nn.pairs, nn.window_pairs, nn.window_scans), and on a
CUDA card its host waits against torch.cuda.set_sync_debug_mode's reports
(tests marked `cuda`).

This file imports neither jax nor otslam_tpu; on the card run it with

    python -m pytest --noconftest -q tests/test_torch_refine_reference.py
"""

import inspect
import json
import sys
import warnings
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
from benchmark.reference import recon as reference  # noqa: E402
from benchmark.reference import refine as ref_refine  # noqa: E402
from otslam_tpu_torch.core.camera import PinholeIntrinsics  # noqa: E402
from otslam_tpu_torch.kernels import icp as icp_mod  # noqa: E402
from otslam_tpu_torch.kernels import nn  # noqa: E402
from otslam_tpu_torch.pipeline import reconstruct as rc  # noqa: E402
from otslam_tpu_torch.pipeline import refine  # noqa: E402
from otslam_tpu_torch.pipeline.dataset import FrameBatch  # noqa: E402
from otslam_tpu_torch.utils.profiling import COUNTS  # noqa: E402

# thousands of small torch ops (the ICP loops) while other files fill the
# cores of a parallel run: one intra-op thread, as tests/torch_parity.py
torch.set_num_threads(1)

CONFIG = json.loads(
    (REPO / "benchmark/configs/object_recon.refine_icp.json").read_text())
TRAFFIC = json.loads(
    (REPO / "benchmark/traffic/captures.refine.json").read_text())
TINY = dict(CONFIG)
TINY["camera"] = dict(CONFIG["camera"], width=160, height=120, fx=141.4002,
                      fy=141.4002, cx=80.5, cy=60.5)
TINY["tsdf"] = dict(CONFIG["tsdf"], voxel_size=0.02, sdf_trunc=0.08,
                    dims=[64, 64, 64], origin=[-0.64, -0.64, -0.14])
TINY["surface_samples"] = 2000
CASES = [("cone_blue", 21), ("chair_1", 22), ("cardboard_box", 2**33 + 3),
         ("table_marble", 24)]
SPANS = {"refine.upload", "refine.frames", "refine.window", "refine.icp",
         "refine.chain", "refine.fuse"}


def capture(name, seed, device="cpu", cfg=TINY):
    """One object's tiny capture (the cell's own generator) with the cell's
    planar pose noise from its own seeded generator, and the truth."""
    traffic = dict(TRAFFIC, objects=[name])
    truth, _ = make_captures(traffic, cfg["camera"], seed, device)
    cap = recon_refine.noisy(truth[name],
                             np.random.default_rng([seed, 1]),
                             TRAFFIC["pose_noise_xy_m"],
                             TRAFFIC["pose_noise_yaw_rad"])
    return cap, truth[name]


def program(cfg=TINY):
    pcfg = recon_refine.program_config(cfg)
    return pcfg, PinholeIntrinsics.from_config(pcfg.camera)


def batch_of(cap):
    return FrameBatch(cap.depths, cap.colors, cap.extrinsics, cap.poses,
                      [f"{cap.name}_{i + 1}.jpg"
                       for i in range(len(cap.depths))])


@pytest.mark.parametrize("name,seed", CASES)
def test_refined_poses_match_the_reference(name, seed):
    cap, _ = capture(name, seed)
    pcfg, intr = program()
    got = refine.refine_trajectory(cap.depths, cap.colors, cap.extrinsics,
                                   intr, pcfg, device="cpu")
    intr_r, _ = reference.params_from_config(TINY)
    want, _ = ref_refine.refine_trajectory(
        cap, intr_r, ref_refine.settings_from_config(TINY), "cpu")
    assert got.extrinsics.dtype == np.float32
    gaps = ref_refine.pose_gaps(got.extrinsics, want)
    for key, gap in gaps.items():
        assert gap <= CONFIG["limits"]["poses"][key]["at_most"], gaps
    if name == "cone_blue":   # a capture whose corrections pass the trust
        assert ref_refine.pose_gaps(cap.extrinsics, want)["pose_gap_m"] \
            > 1e-3


@pytest.mark.parametrize("name,seed", CASES[:2])
def test_cloud_matches_the_reference_fused_at_the_refined_poses(name, seed):
    """reconstruct_frames(refine="icp"): the volume sized from the priors,
    the frames fused at the refined poses, the cloud row for row."""
    cap, _ = capture(name, seed)
    pcfg, intr = program()
    draws = torch.rand(pcfg.surface_samples,
                       generator=torch.Generator().manual_seed(seed))
    res = rc.reconstruct_frames(batch_of(cap), intr, pcfg, output="cloud",
                                auto_origin=True, refine="icp",
                                device="cpu", draws=draws)
    intr_r, params = reference.params_from_config(TINY)
    want = ref_refine.fused_cloud(cap, res.extrinsics, intr_r, params, draws,
                                  "cpu")
    limits = CONFIG["limits"]["cloud"]
    gaps = compare(res, want, "cloud")
    for key, gap in gaps.items():
        assert gap <= limits[key]["at_most"], gaps
    assert len(res.points) > 100


def test_configuration_states_the_refiner_defaults():
    s = CONFIG["refine_settings"]
    rt = inspect.signature(refine.refine_trajectory).parameters
    assert tuple(s["thresholds_m"]) == rt["thresholds"].default
    assert s["stride"] == rt["stride"].default
    assert s["trust_translation_m"] == rt["trust_translation"].default
    assert s["trust_rotation_rad"] == rt["trust_rot"].default
    assert s["max_iterations"] == refine.PAIR_ICP_ITERATIONS
    icp = inspect.signature(icp_mod.icp_point_to_plane).parameters
    assert s["relative_fitness"] == icp["relative_fitness"].default
    assert s["relative_rmse"] == icp["relative_rmse"].default
    assert CONFIG["refine"] == "icp" and "icp" in rc.REFINERS
    assert CONFIG["limits"]["cloud"] == json.loads(
        (REPO / "benchmark/configs/object_recon.json").read_text()
    )["limits"]["cloud"]
    for key in ("camera", "tsdf", "z_filter_threshold", "surface_samples",
                "backend", "auto_origin", "precision"):
        assert CONFIG[key] == json.loads(
            (REPO / "benchmark/configs/object_recon.json").read_text())[key]


def grew(before, name):
    return COUNTS[name] - before.get(name, 0)


def test_iteration_and_pair_counters(monkeypatch):
    cap, _ = capture("chair_1", 31)
    pcfg, intr = program()
    results = []
    orig = refine.icp_point_to_plane

    def kept(*a, **k):
        res = orig(*a, **k)
        results.append(res)
        return res
    monkeypatch.setattr(refine, "icp_point_to_plane", kept)
    before = dict(COUNTS)
    refine.refine_trajectory(cap.depths, cap.colors, cap.extrinsics, intr,
                             pcfg, device="cpu")
    n = len(cap.depths)
    assert grew(before, "icp.pairs") == n - 1
    assert len(results) == 3 * (n - 1)
    assert grew(before, "icp.iterations") == \
        sum(r.iterations for r in results) > 0
    # every scan counts its rows, full (n x m) or windowed (tallied)
    assert grew(before, "nn.pairs") + grew(before, "nn.window_pairs") > 0
    assert grew(before, "nn.window_scans") <= \
        grew(before, "icp.iterations") + 3 * (n - 1)
    # the corrections the trust region dropped are the reference's
    intr_r, _ = reference.params_from_config(TINY)
    _, dropped = ref_refine.refine_trajectory(
        cap, intr_r, ref_refine.settings_from_config(TINY), "cpu")
    assert grew(before, "refine.fallbacks") == dropped


def test_fallback_counts_a_planted_rejection(monkeypatch):
    """A pair whose correction moves 0.5 m (past the 0.15 m trust region)
    keeps its prior and counts one fallback."""
    cap, _ = capture("cone_blue", 32)
    pcfg, intr = program()
    orig = refine._annealed_icp
    calls = []

    def planted(src, *a, **k):
        res = orig(src, *a, **k)
        calls.append(1)
        if len(calls) == 2:
            T = torch.eye(4, dtype=torch.float32)
            T[0, 3] = 0.5
            res = res._replace(transformation=T)
        return res
    monkeypatch.setattr(refine, "_annealed_icp", planted)
    before = dict(COUNTS)
    got = refine.refine_trajectory(cap.depths, cap.colors, cap.extrinsics,
                                   intr, pcfg, device="cpu").extrinsics
    assert grew(before, "refine.fallbacks") == 1
    # frame 2 keeps its prior relative to frame 1
    ext = cap.extrinsics.astype(np.float64)
    prior = ext[1] @ np.linalg.inv(ext[2])
    kept = got[1].astype(np.float64) @ np.linalg.inv(got[2].astype(
        np.float64))
    np.testing.assert_allclose(kept, prior, atol=1e-5)


def test_window_tally_counts_the_scanned_rows():
    """Inside window_tally, the windowed scans' rows sum to
    (c1 - c0) x 1024 x 256 over their tiles, and `fold` counts them and
    the scans; outside, nothing is kept, and full scans count n x m on the
    host."""
    g = torch.Generator().manual_seed(7)
    dst = torch.rand(5000, 3, generator=g) * torch.tensor([4.0, 1.0, 1.0])
    dst = dst[torch.argsort(dst[:, 0], stable=True)]
    src = dst[::3] + 0.01 * torch.rand(1667, 3, generator=g)
    src = src[torch.argsort(src[:, 0], stable=True)]
    mask = torch.ones(5000, dtype=torch.bool)
    _, _, c0, c1 = nn.window_ranges(src, dst, mask, 0.05, 0)
    before = dict(COUNTS)
    with nn.window_tally() as tally:
        a = nn.nn_distance_radius(src, dst, 0.05, window_chunks=2, axis=0)
        b = nn.nn_distance_radius(src, dst, 0.05, window_chunks=2, axis=0)
    torch.testing.assert_close(a, b)
    want = 2 * int((c1 - c0).sum()) * 1024 * 256
    assert int(tally.pairs()) == want < 2 * 1667 * 5120
    assert grew(before, "nn.window_pairs") == 0
    tally.fold(int(tally.pairs()))
    assert grew(before, "nn.window_pairs") == want
    assert grew(before, "nn.window_scans") == 2
    assert grew(before, "nn.pairs") == 0
    nn.nn_distance_radius(src, dst, 0.05, window_chunks=2, axis=0)
    assert nn._TALLY is None
    assert grew(before, "nn.window_scans") == 2
    nn.nn_distance(src, dst)
    assert grew(before, "nn.pairs") == 1667 * 5000
    with nn.window_tally() as empty:
        pass
    assert empty.pairs() is None


def test_refine_spans_and_results_unchanged_by_tracing():
    cap, _ = capture("cone_blue", 33)
    pcfg, intr = program()
    draws = torch.rand(pcfg.surface_samples,
                       generator=torch.Generator().manual_seed(1))

    def call(timings=None):
        return rc.reconstruct_frames(batch_of(cap), intr, pcfg,
                                     auto_origin=True, refine="icp",
                                     device="cpu", draws=draws,
                                     timings=timings)
    plain = call()
    timings = {}
    traced = call(timings)
    np.testing.assert_array_equal(plain.extrinsics, traced.extrinsics)
    np.testing.assert_array_equal(plain.points, traced.points)
    spans = timings["trace"]["spans"]
    parents = {s[0]: s[1] for s in spans}
    assert SPANS <= set(parents)
    assert all(parents[n] == "recon.refine" for n in SPANS)
    n = len(cap.depths)
    per = {name: sum(s[0] == name for s in spans) for name in SPANS}
    assert per == {"refine.upload": 1, "refine.frames": n,
                   "refine.window": n - 1, "refine.icp": n - 1,
                   "refine.chain": n - 1, "refine.fuse": 1}
    counts = timings["trace"]["counts"]
    assert counts["icp.pairs"] == n - 1 and counts["icp.iterations"] > 0
    assert "refine" in timings


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_refine_syncs_are_the_waits_pytorch_reports(dev):
    """One refined object at the cell's VGA size: the `syncs` counter
    equals the synchronizing calls set_sync_debug_mode reports."""
    cap, _ = capture("chair_1", 3000000041, dev, CONFIG)
    pcfg, intr = program(CONFIG)
    batch = batch_of(cap)

    def call():
        return rc.reconstruct_frames(batch, intr, pcfg, auto_origin=True,
                                     refine="icp", device=dev)
    call()                                        # builds, warms up
    torch.cuda.synchronize()
    before = COUNTS["syncs"]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        del seen[:]             # the mode's own notice, the first time on
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = [w for w in seen if "synchroniz" in str(w.message)]
    assert COUNTS["syncs"] - before == len(waits)


@pytest.mark.cuda
def test_nn_counts_are_the_profiled_launches(dev):
    """Over one refined object the NN launch counters equal the profile's
    K3 and K4 launches, every K4 launch's rows are counted
    (nn.window_scans), and each kind of scan that ran counted its rows."""
    from benchmark.trace import Trace, kernel
    cap, _ = capture("cone_red", 3000000042, dev, CONFIG)
    pcfg, intr = program(CONFIG)
    batch = batch_of(cap)
    rc.reconstruct_frames(batch, intr, pcfg, auto_origin=True, refine="icp",
                          device=dev)
    before = dict(COUNTS)
    tracer = Trace(dev)
    tracer.start()
    rc.reconstruct_frames(batch, intr, pcfg, auto_origin=True, refine="icp",
                          device=dev)
    summary = tracer.stop()
    assert kernel(summary, "nn_window_kernel")[0] == \
        grew(before, "launches.otslam_nn_window")
    assert kernel(summary, "nn_kernel")[0] == grew(before,
                                                   "launches.otslam_nn")
    assert grew(before, "nn.window_scans") == \
        grew(before, "launches.otslam_nn_window") > 0
    assert grew(before, "nn.window_pairs") > 0
    # full scans run only where a pair's window would cover the cloud
    assert (grew(before, "nn.pairs") > 0) == \
        (grew(before, "launches.otslam_nn") > 0)


@pytest.mark.cuda
def test_point_to_point_syncs_are_the_waits_pytorch_reports(dev):
    """Point-to-point ICP (the localizer's): its counted waits, the SVD's
    two among them, equal set_sync_debug_mode's reports."""
    g = torch.Generator().manual_seed(3)
    dst = torch.rand(4000, 3, generator=g).to(dev)
    src = (dst + 0.01).contiguous()
    icp_mod.icp_point_to_point(src, dst, threshold=0.05)
    torch.cuda.synchronize()
    before = COUNTS["syncs"]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        del seen[:]
        try:
            res = icp_mod.icp_point_to_point(src, dst, threshold=0.05)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = [w for w in seen if "synchroniz" in str(w.message)]
    assert res.iterations > 2
    assert COUNTS["syncs"] - before == len(waits)


def capture_pair(name, seed):
    """Frames 1 onto 0 of a tiny capture, prepared as refine_trajectory
    prepares a pair: (source moved by the prior, frame 0's points,
    normals and validity, frame 1's validity, the window)."""
    cap, _ = capture(name, seed)
    _, intr = program()
    depths = torch.as_tensor(cap.depths)
    pp, pn, pv = refine._frame_points_normals(depths[0], intr)
    cp, _, cv = refine._frame_points_normals(depths[1], intr)
    window = refine._pair_nn_window(cp, pp, max(THRESHOLDS))
    ext = cap.extrinsics.astype(np.float64)
    src = refine._moved(cp, ext[0] @ np.linalg.inv(ext[1]))
    return src, pp, pn, pv, cv, window


THRESHOLDS = tuple(CONFIG["refine_settings"]["thresholds_m"])


def test_plain_annealed_icp_is_three_chained_calls():
    """On the CPU, _annealed_icp is its plain version, and that is
    icp_point_to_plane at each threshold from the last stage's
    transformation, bit for bit."""
    src, pp, pn, pv, cv, window = capture_pair("chair_1", 34)
    T = torch.eye(4)
    for thr in THRESHOLDS:
        want = icp_mod.icp_point_to_plane(
            src, pp, pn, threshold=thr, init=T, src_mask=cv, dst_mask=pv,
            max_iterations=refine.PAIR_ICP_ITERATIONS, nn_window=window[0],
            nn_axis=window[1])
        T = want.transformation
    for got in (refine._annealed_icp_plain(src, pp, pn, pv, cv, THRESHOLDS,
                                           window),
                refine._annealed_icp(src, pp, pn, pv, cv, THRESHOLDS,
                                     window)):
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b)
        assert got.iterations == want.iterations
    assert float(want.fitness) > 0



def test_pair_result_is_one_copy():
    """One copy brings a pair's pose (float64), fitness and RMSE home with
    the window tally's rows, which it counts."""
    T = torch.eye(4)
    T[0, 3] = 0.25
    res = icp_mod.ICPResult(T, torch.tensor(0.5), torch.tensor(0.01), 3)
    tally = nn.WindowTally()
    tally.ranges.append((torch.tensor([0, 1], dtype=torch.int32),
                         torch.tensor([2, 4], dtype=torch.int32)))
    before = dict(COUNTS)
    dT, fit, rmse = refine._pair_result(res, tally)
    assert dT.dtype == np.float64 and dT[0, 3] == 0.25
    assert fit == 0.5 and rmse == float(torch.tensor(0.01))
    assert grew(before, "nn.window_pairs") == 5 * 1024 * 256
    assert grew(before, "nn.window_scans") == 1
    assert grew(before, "icp.iterations") == 0
    dT, _, _ = refine._pair_result(res, nn.WindowTally())
    assert grew(before, "nn.window_scans") == 1
