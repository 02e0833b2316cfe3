"""The estimated-pose recon cell (recon.captures.refine) at tiny sizes on
the CPU: its driver, the refiner's reference, the control, its readers and
planted faults, from the benchmark's files alone; and on the card, one
object's refined poses against the reference at full size.

Each fault breaks the refined poses or the volume underneath a whole run
(the harness's look for a card skipped) and must turn `correct` false.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import tiny
from benchmark import harness
from benchmark.drivers import recon_refine

CELL = "recon.captures.refine"
CONFIG = "object_recon.refine_icp"
NEW = {"recon.refine_ms", "refine.icp_ms", "refine.window_ms",
       "refine.icp_iterations", "nn_roofline"}
# the cell's traced metrics read from the program's own records (the
# device's need a card)
ON_CPU = NEW - {"nn_roofline"}


def shrink(root, trust=None):
    """The new configuration cut in the tiny copy as tiny.py cuts
    object_recon (TINY_CAMERA, 64^3 at 2 cm), its traffic to two objects."""
    base = root / "benchmark"
    path = base / "configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    cfg["camera"].update(tiny.TINY_CAMERA)
    cfg["tsdf"].update({"voxel_size": 0.02, "sdf_trunc": 0.08,
                        "dims": [64, 64, 64],
                        "origin": [-0.64, -0.64, -0.14]})
    cfg["surface_samples"] = 2000
    if trust is not None:
        cfg["refine_settings"].update({"trust_translation_m": trust,
                                       "trust_rotation_rad": trust})
    path.write_text(json.dumps(cfg))
    tp = base / "traffic" / "captures.refine.json"
    t = json.loads(tp.read_text())
    t["objects"] = ["chair_1", "cone_blue"]
    t["warmup"] = ["cone_blue"]
    tp.write_text(json.dumps(t))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return shrink(tiny.tiny_root(tmp_path_factory.mktemp("refine")))


@pytest.fixture(scope="module")
def tight_root(tmp_path_factory):
    """A copy whose trust region (5 mm, 5 mrad) drops most corrections."""
    return shrink(tiny.tiny_root(tmp_path_factory.mktemp("refine_tight")),
                  trust=0.005)


def drive(root, seed=11, seconds=0.3, trace=False, control=False):
    spec = harness.load_spec(root)
    _, cfg, traffic = harness.cell_files(spec, CELL, root / "benchmark")
    return recon_refine.run(cfg, traffic, seed, seconds, trace,
                            torch.device("cpu"), 1, 0.0, control)


def run_cell(root, capsys, seed="4294967297", trace=0):
    from benchmark import run
    assert run.main(["--workload", CELL, "--seed", seed, "--seconds", "0.3",
                     "--trace", str(trace)], device="cpu", root=root) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_agrees_with_reference(root, trace, capsys):
    res = run_cell(root, capsys, trace=trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    names = set(res["metrics"])
    if trace:
        assert ON_CPU <= names
        assert {"recon.fuse_ms", "recon.syncs"} <= names
        assert res["metrics"]["refine.icp_iterations"]["value"] > 0
    else:
        assert names == {"objects_per_s", "object_p95_ms", "setup_s"}
    checks = res["checks"]
    assert checks["pose_gap_m"]["value"] <= checks["pose_gap_m"]["at_most"]
    assert checks["point_count_gap"]["value"] == 0


def test_control_is_not_correct(root):
    ctx = drive(root, control=True)
    assert ctx["checks"].correct(), ctx["checks"].record()
    ctl = ctx["control"]
    assert not ctl.correct()
    assert not (ctl.ok("pose_gap_m") and ctl.ok("pose_gap_rad"))
    cloud = [n for n in ctl.limits if not n.startswith("pose_gap")]
    assert not all(ctl.ok(n) for n in cloud)


def test_noise_is_planar_and_seeded(root):
    """The reported poses differ from the true ones by at most the
    traffic's disc and yaw, never in height, and the captures' own draws
    (frames, order) stay those of the seed."""
    from benchmark.inputs.captures import make_captures
    spec = harness.load_spec(root)
    _, cfg, traffic = harness.cell_files(spec, CELL, root / "benchmark")
    truth, _ = make_captures(traffic, cfg["camera"], 3, "cpu")
    cap = truth["chair_1"]
    a = recon_refine.noisy(cap, np.random.default_rng([3, 1]), 0.03, 0.01)
    b = recon_refine.noisy(cap, np.random.default_rng([3, 1]), 0.03, 0.01)
    np.testing.assert_array_equal(a.extrinsics, b.extrinsics)
    np.testing.assert_array_equal(a.depths, cap.depths)
    for e, t in zip(a.extrinsics.astype(np.float64),
                    cap.extrinsics.astype(np.float64)):
        ce, ct = np.linalg.inv(e)[:3, 3], np.linalg.inv(t)[:3, 3]
        assert np.hypot(*(ce - ct)[:2]) <= 0.03 + 1e-6
        assert abs(ce[2] - ct[2]) < 1e-6
        R = e[:3, :3] @ t[:3, :3].T
        assert np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)) \
            <= 0.01 + 1e-5
    assert np.abs(a.extrinsics - cap.extrinsics).max() > 1e-3


def _wrap_refiner(monkeypatch, change):
    from otslam_tpu_torch.pipeline import reconstruct as prog
    orig = prog.REFINERS["icp"]

    def refiner(*a, **k):
        return change(orig, *a, **k)
    monkeypatch.setitem(prog.REFINERS, "icp", refiner)


def _fault_pose_moved(monkeypatch):
    def moved(orig, *a, **k):
        res = orig(*a, **k)
        ext = res.extrinsics.copy()
        ext[len(ext) // 2, 0, 3] += 2e-3
        return dataclasses.replace(res, extrinsics=ext)
    _wrap_refiner(monkeypatch, moved)


def _fault_pair_unrefined(monkeypatch):
    from otslam_tpu_torch.pipeline import refine
    orig = refine._annealed_icp
    calls = []

    def unrefined(src, *a, **k):
        res = orig(src, *a, **k)
        calls.append(1)
        if len(calls) == 1:       # the first pair keeps its prior
            eye = torch.eye(4, dtype=torch.float32, device=src.device)
            res = res._replace(transformation=eye)
        return res

    def per_object(orig_refiner, *a, **k):
        calls.clear()
        return orig_refiner(*a, **k)
    monkeypatch.setattr(refine, "_annealed_icp", unrefined)
    _wrap_refiner(monkeypatch, per_object)


def _fault_volume_from_refined(monkeypatch):
    from otslam_tpu_torch.pipeline import reconstruct as prog
    orig = prog.reconstruct_frames

    def refined_first(batch, intr, cfg, *a, refine="none", device="cpu",
                      **k):
        ext = prog.REFINERS[refine](batch.depths, batch.colors,
                                    batch.extrinsics, intr, cfg,
                                    device=device).extrinsics
        return orig(dataclasses.replace(batch, extrinsics=ext), intr, cfg,
                    *a, refine="none", device=device, **k)
    monkeypatch.setattr(prog, "reconstruct_frames", refined_first)


FAULTS = {"pose_moved_2mm": _fault_pose_moved,
          "pair_unrefined": _fault_pair_unrefined,
          "volume_from_refined_poses": _fault_volume_from_refined}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_turns_correct_false(root, fault, monkeypatch, capsys):
    FAULTS[fault](monkeypatch)
    res = run_cell(root, capsys, seed="5")
    assert res["correct"] is False


@pytest.mark.parametrize("skipped", [False, True])
def test_trust_region_is_judged(tight_root, skipped, monkeypatch, capsys):
    """With a 5 mm / 5 mrad trust region on both sides the program agrees
    with the reference; the program with its trust region skipped does
    not."""
    from otslam_tpu_torch.pipeline import reconstruct as prog
    from otslam_tpu_torch.pipeline import refine
    trust = np.inf if skipped else 0.005
    monkeypatch.setitem(prog.REFINERS, "icp", functools.partial(
        refine.refine_trajectory, trust_translation=trust, trust_rot=trust))
    res = run_cell(tight_root, capsys, seed="6")
    assert res["correct"] is (not skipped), res["checks"]


def test_readers_are_silent_on_a_program_without_records(root):
    base = root / "benchmark"
    untraced = {"stages": [{"auto_volume": 0.1, "refine": 0.3, "fuse": 0.2,
                            "extract": 0.3}]}
    parent = {"stages": [{"trace": {"spans": [["recon.object", None, 0, 9],
                                              ["recon.refine", "recon.object",
                                               1, 5]],
                                    "counts": {"syncs": 40}}}],
              "trace": {"kernels": {"nn_kernel(float)": (3, 0.001)},
                        "nn": dict.fromkeys(recon_refine.NN_COUNTERS, 0),
                        "nn_calls": 0},
              "trace_sound": True}
    for ctx in ({}, {"stages": []}, untraced, parent):
        for name in NEW - {"recon.refine_ms"}:
            assert harness.reader(name, base)(ctx) is None, (name, ctx)
    assert harness.reader("recon.refine_ms", base)(parent) == \
        pytest.approx(4e-6)


def test_nn_roofline_reads_a_sound_stretch_only(root):
    """The share reads K3's rows (nn.pairs) and K4's (nn.window_pairs) over
    the three kernels' time, and only where every K3 and K4 launch was
    counted and every K4 launch's rows were tallied."""
    read = harness.reader("nn_roofline", root / "benchmark")
    nn = {"launches.otslam_nn": 10, "launches.otslam_nn_window": 90,
          "nn.pairs": 2 * 10 ** 9, "nn.window_pairs": 8 * 10 ** 9,
          "nn.window_scans": 90}
    tr = {"kernels": {"(anonymous namespace)::nn_window_kernel(float)":
                      (90, 0.010),
                      "(anonymous namespace)::nn_kernel(float)": (10, 0.005),
                      "(anonymous namespace)::nn_merge_kernel(int)":
                      (60, 0.001)},
          "nn": nn}
    share = read({"trace": tr, "trace_sound": True})
    assert share == pytest.approx(100 * 8e10 / 67e12 / 0.016)
    for key, value in [("launches.otslam_nn", 9),
                       ("launches.otslam_nn_window", 89),
                       ("nn.window_scans", 89)]:
        bad = dict(tr, nn=dict(nn, **{key: value}))
        assert read({"trace": bad, "trace_sound": True}) is None, key
    assert read({"trace": tr, "trace_sound": False}) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_program_poses_match_the_reference_at_full_size(card):
    """One object (the table, 9 VGA captures) on the card: the program's
    refined poses within the configuration's pose limits of the
    reference's, from the same noisy priors."""
    from benchmark.inputs.captures import make_captures
    from benchmark.reference import recon as reference
    from benchmark.reference import refine as ref_refine
    from otslam_tpu_torch.core.camera import PinholeIntrinsics
    from otslam_tpu_torch.pipeline.refine import refine_trajectory
    spec = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    _, cfg, traffic = harness.cell_files(spec, CELL,
                                         tiny.REPO / "benchmark")
    traffic = dict(traffic, objects=["table_marble"])
    truth, _ = make_captures(traffic, cfg["camera"], 3000000011, card)
    cap = recon_refine.noisy(truth["table_marble"],
                             np.random.default_rng([3000000011, 1]),
                             traffic["pose_noise_xy_m"],
                             traffic["pose_noise_yaw_rad"])
    pcfg = recon_refine.program_config(cfg)
    intr = PinholeIntrinsics.from_config(pcfg.camera)
    got = refine_trajectory(cap.depths, cap.colors, cap.extrinsics, intr,
                            pcfg, device=card).extrinsics
    intr_r, _ = reference.params_from_config(cfg)
    want, _ = ref_refine.refine_trajectory(
        cap, intr_r, ref_refine.settings_from_config(cfg), card)
    gaps = ref_refine.pose_gaps(got, want)
    for name, gap in gaps.items():
        assert gap <= cfg["limits"]["poses"][name]["at_most"], gaps


def test_requests_are_the_captures_cells_with_fresh_errors(root):
    """Every request of an object carries recon.captures' own capture of
    it for the seed (frames, true poses), its rounds are that cell's, and
    each request's pose error is its own and the seed's."""
    from benchmark.inputs.captures import make_captures
    from itertools import islice
    spec = harness.load_spec(root)
    _, cfg, traffic = harness.cell_files(spec, CELL, root / "benchmark")
    caps, rounds = make_captures(traffic, cfg["camera"], 9, "cpu")
    _, order = make_captures(traffic, cfg["camera"], 9, "cpu")
    assert list(islice(rounds, 6)) == list(islice(order, 6))
    first = recon_refine.requests(caps, traffic, 9)
    again = recon_refine.requests(caps, traffic, 9)
    a, truth = first("chair_1")
    b, _ = first("chair_1")
    assert truth is caps["chair_1"]
    np.testing.assert_array_equal(a.depths, truth.depths)
    np.testing.assert_array_equal(b.depths, truth.depths)
    assert np.abs(a.extrinsics - b.extrinsics).max() > 1e-4
    np.testing.assert_array_equal(again("chair_1")[0].extrinsics,
                                  a.extrinsics)


def test_refine_reference_loads_no_program_module():
    import subprocess
    import sys
    code = ("import sys, benchmark.reference.refine; print(sorted({m.split("
            "'.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO,
                         capture_output=True, text=True, check=True).stdout
    assert not set(eval(out)) & {"otslam_tpu_torch", "otslam_tpu", "jax",
                                 "jaxlib", "flax"}
