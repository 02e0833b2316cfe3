"""The pose-graph recon cell (recon.captures.pgo) at tiny sizes on the CPU:
its driver, the refiner's reference, the control, its readers and planted
faults, from the benchmark's files alone.

`ENTRIES` are the spec entries that add the cell (appended at the end of
their lists, with the cell appended to the `workloads` of `ADDED_TO`);
the tiny copy takes them from BENCHMARK.json.

Each fault breaks the refined poses underneath a whole run (the harness's
look for a card skipped) and must turn `correct` false; the loop edges'
weight, which the cell's captures never exercise (no two views 8 frames
apart lie within the loop radius), is held on a looped capture instead.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import tiny
from benchmark import harness
from benchmark.drivers import recon_pgo, recon_refine
from benchmark.inputs.looped import looped
from benchmark.reference import pgo as ref_pgo
from benchmark.reference import recon as reference
from benchmark.reference import refine as ref_refine

CELL = "recon.captures.pgo"
CONFIG = "object_recon.refine_pgo"
NEW = {"refine.track_ms", "refine.model_ms", "refine.graph_ms",
       "refine.loops_ms"}
# the other per-layer metrics the cell reports from the program's own
# records on the CPU (the device's need a card)
SHARED = {"recon.auto_volume_ms", "recon.fuse_ms", "recon.extract_ms",
          "recon.upload_ms", "recon.upload_mb", "recon.syncs",
          "recon.to_host_ms", "recon.refine_ms"}

ENTRIES = {
    "configs": [{
        "name": CONFIG,
        "source": "README.md:266 reconstruct --refine pgo; "
                  "otslam_tpu/pipeline/refine.py refine_trajectory_pgo "
                  "defaults; MISSION_r04 localizer error; github.com/TakiRyo/"
                  "object-triggered-3D-SLAM reconstruct_rgbd.py",
        "file": f"benchmark/configs/{CONFIG}.json", "reduced": [],
        "why": "captures at a 2D localizer's estimated poses, refined by "
               "frame-to-model tracking on a one-frame-fused model, loop "
               "search and a pose-graph solve before fusion and "
               "extraction"}],
    "workloads": [{
        "name": CELL, "config": CONFIG, "traffic": "captures.pgo",
        "chips": 1,
        "why": "the captures at estimated poses, refined by --refine pgo, "
               "closed loop, 6-9 VGA frames an object: the f2m tracker "
               "(~2/3) and the pose-graph solve (~1/3) take most of each "
               "object"}],
    "per_layer": [{"name": name, "unit": "ms", "better": "lower",
                   "source": "program_span", "layer": "pose refinement",
                   "moves": "objects_per_s", "workloads": [CELL]}
                  for name in ("refine.track_ms", "refine.model_ms",
                               "refine.graph_ms", "refine.loops_ms")],
}
ADDED_TO = ("objects_per_s", "recon.auto_volume_ms", "recon.fuse_ms",
            "recon.extract_ms", "k1_roofline", "device.idle_pct.recon",
            "recon.upload_ms", "recon.upload_mb", "recon.syncs",
            "recon.to_host_ms", "recon.refine_ms")


def shrink(root):
    """The tiny copy's pgo configuration cut as tiny.py cuts object_recon
    (TINY_CAMERA, 64^3 at 2 cm), its traffic to two objects."""
    base = root / "benchmark"
    path = base / "configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    cfg["camera"].update(tiny.TINY_CAMERA)
    cfg["tsdf"].update({"voxel_size": 0.02, "sdf_trunc": 0.08,
                        "dims": [64, 64, 64],
                        "origin": [-0.64, -0.64, -0.14]})
    cfg["surface_samples"] = 2000
    path.write_text(json.dumps(cfg))
    tp = base / "traffic" / "captures.pgo.json"
    t = json.loads(tp.read_text())
    t["objects"] = ["chair_1", "cone_blue"]
    t["warmup"] = ["cone_blue"]
    tp.write_text(json.dumps(t))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return shrink(tiny.tiny_root(tmp_path_factory.mktemp("pgo")))


def files(root):
    spec = harness.load_spec(root)
    _, cfg, traffic = harness.cell_files(spec, CELL, root / "benchmark")
    return cfg, traffic


def drive(root, seed=11, seconds=0.3, trace=False, control=False):
    cfg, traffic = files(root)
    return recon_pgo.run(cfg, traffic, seed, seconds, trace,
                         torch.device("cpu"), 1, 0.0, control)


def run_cell(root, capsys, seed="4294967297", trace=0):
    from benchmark import run
    assert run.main(["--workload", CELL, "--seed", seed, "--seconds", "0.3",
                     "--trace", str(trace)], device="cpu", root=root) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_agrees_with_reference(root, trace, capsys):
    res, err = run_cell(root, capsys, trace=trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    names = set(res["metrics"])
    if trace:
        assert NEW | SHARED <= names
        assert res["metrics"]["refine.track_ms"]["value"] > 0
    else:
        assert names == {"objects_per_s", "setup_s"}
    checks = res["checks"]
    assert checks["pose_gap_m"]["value"] == 0
    assert checks["point_count_gap"]["value"] == 0
    # the judge reports each judged request's trajectory errors and loops
    lines = [ln for ln in err.splitlines() if ln.startswith("trajectory ")]
    assert lines and all("0 candidates, 0 edges" in ln for ln in lines)


def test_control_is_not_correct(root):
    ctx = drive(root, control=True)
    assert ctx["checks"].correct(), ctx["checks"].record()
    ctl = ctx["control"]
    assert not (ctl.ok("pose_gap_m") or ctl.ok("pose_gap_rad"))
    cfg, _ = files(root)
    limit = cfg["limits"]["poses"]["pose_gap_m"]["at_most"]
    assert ctl.values["pose_gap_m"] >= 10 * limit


def _wrap_refiner(monkeypatch, change):
    from otslam_tpu_torch.pipeline import reconstruct as prog
    orig = prog.REFINERS["pgo"]

    def refiner(*a, **k):
        return change(orig, *a, **k)
    monkeypatch.setitem(prog.REFINERS, "pgo", refiner)


def _fault_pose_moved(monkeypatch):
    def moved(orig, *a, **k):
        res = orig(*a, **k)
        ext = res.extrinsics.copy()
        ext[len(ext) // 2, 0, 3] += 2e-3
        return dataclasses.replace(res, extrinsics=ext)
    _wrap_refiner(monkeypatch, moved)


def _fault_one_iteration_fewer(monkeypatch):
    from otslam_tpu_torch.pipeline import refine
    orig = refine.track_frame_to_tsdf

    def fewer(*a, max_iterations, **k):
        return orig(*a, max_iterations=max_iterations - 1, **k)
    monkeypatch.setattr(refine, "track_frame_to_tsdf", fewer)


def _fault_model_at_the_prior(monkeypatch):
    """The tracking model takes each frame at its tracked pose's prior
    (the fusion of the odometry chain), its tracked poses kept."""
    from otslam_tpu_torch.pipeline import refine
    orig = refine.integrate_frames_sparse
    priors = {}

    def at_prior(vol, depths, colors, extrinsics, intr, max_active=None):
        if depths.shape[0] == 1 and "ext" in priors:
            k = priors["k"]
            priors["k"] = k + 1
            extrinsics = torch.as_tensor(priors["ext"][k:k + 1],
                                         device=depths.device)
        return orig(vol, depths, colors, extrinsics, intr,
                    max_active=max_active)

    def per_object(orig_refiner, depths, colors, extrinsics, *a, **k):
        priors.update(ext=np.asarray(extrinsics, np.float32), k=0)
        try:
            return orig_refiner(depths, colors, extrinsics, *a, **k)
        finally:
            priors.clear()
    monkeypatch.setattr(refine, "integrate_frames_sparse", at_prior)
    _wrap_refiner(monkeypatch, per_object)


FAULTS = {"pose_moved_2mm": _fault_pose_moved,
          "one_tracker_iteration_fewer": _fault_one_iteration_fewer,
          "model_fused_at_the_priors": _fault_model_at_the_prior}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_turns_correct_false(root, fault, monkeypatch, capsys):
    FAULTS[fault](monkeypatch)
    res, _ = run_cell(root, capsys, seed="5")
    assert res["correct"] is False, res["checks"]


def test_loop_edges_weigh_two(root, monkeypatch):
    """On a looped capture the reference verifies loop edges, and the
    program with its loop edges weighing 1 falls outside the pose limits
    (tests/test_torch_pgo_reference.py holds the unbroken program within
    them on the same capture)."""
    from otslam_tpu_torch.core.camera import PinholeIntrinsics
    from otslam_tpu_torch.pipeline import refine
    from otslam_tpu_torch.pipeline.reconstruct import auto_volume_config
    from otslam_tpu_torch.pipeline.dataset import FrameBatch
    cfg, traffic = files(root)
    cap = looped(cfg["camera"], traffic, "chair_1", 42)
    orig = refine.optimize_pose_graph

    def weighed(poses, ei, ej, z, w, **k):
        return orig(poses, ei, ej, z, torch.where(w > 1, 1.0, w), **k)
    monkeypatch.setattr(refine, "optimize_pose_graph", weighed)
    pcfg = recon_refine.program_config(cfg)
    intr = PinholeIntrinsics.from_config(pcfg.camera)
    batch = FrameBatch(cap.depths, cap.colors, cap.extrinsics, cap.poses,
                       [f"{cap.name}_{i + 1}.jpg" for i in range(10)])
    got = refine._pgo_poses(cap.depths, cap.colors, cap.extrinsics, intr,
                            auto_volume_config(batch, intr, pcfg),
                            device="cpu").extrinsics
    intr_r, params = reference.params_from_config(cfg)
    want, rec = ref_pgo.refine_trajectory(
        cap, intr_r, params, ref_pgo.settings_from_config(cfg), "cpu")
    assert rec["loop_edges"] >= 1
    gaps = ref_refine.pose_gaps(got, want)
    limits = cfg["limits"]["poses"]
    assert any(gaps[k] > limits[k]["at_most"] for k in gaps), gaps


def test_readers_are_silent_on_a_program_without_records(root):
    """A program without the new spans (the parent's) reads None from each
    new reader and never raises; a record with them reads its sums."""
    base = root / "benchmark"
    untraced = {"stages": [{"auto_volume": 0.1, "refine": 0.3, "fuse": 0.2,
                            "extract": 0.3}]}
    parent = {"stages": [{"trace": {"spans": [["recon.object", None, 0, 9],
                                              ["recon.refine", "recon.object",
                                               1, 5]],
                                    "counts": {"syncs": 40}}}]}
    for ctx in ({}, {"stages": []}, untraced, parent):
        for name in NEW:
            assert harness.reader(name, base)(ctx) is None, (name, ctx)
    spans = [["refine.model", "recon.refine", 0, 2_000_000],
             ["refine.track", "recon.refine", 2_000_000, 5_000_000],
             ["refine.model", "recon.refine", 5_000_000, 6_000_000],
             ["refine.loops", "recon.refine", 6_000_000, 6_500_000],
             ["refine.graph", "recon.refine", 6_500_000, 9_000_000]]
    ctx = {"stages": [{"trace": {"spans": spans, "counts": {}}}]}
    want = {"refine.model_ms": 3.0, "refine.track_ms": 3.0,
            "refine.loops_ms": 0.5, "refine.graph_ms": 2.5}
    for name, ms in want.items():
        assert harness.reader(name, base)(ctx) == pytest.approx(ms)


def test_entries_add_the_cell_back():
    """The spec ends each list with the cell's entries, names each of
    them once, ends each list of `ADDED_TO` with the cell and no other
    list with it; the entries name files that exist and keep the spec's
    limits on texts."""
    spec = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    base = tiny.REPO / "benchmark"
    for key, entries in ENTRIES.items():
        assert spec[key][-len(entries):] == entries
        names = [e["name"] for e in spec[key]]
        assert len(names) == len(set(names))
        for e in entries:
            assert all(1 <= len(e[k]) <= 200 for k in ("source", "why")
                       if k in e)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ADDED_TO:
            assert m["workloads"][-1] == CELL
            assert m["workloads"].count(CELL) == 1
        elif m["name"] not in {e["name"] for e in ENTRIES["per_layer"]}:
            assert CELL not in m.get("workloads", [])
    assert (tiny.REPO / ENTRIES["configs"][0]["file"]).is_file()
    assert (base / "traffic/captures.pgo.json").is_file()
    for m in ENTRIES["per_layer"]:
        assert (base / "metrics" / f"{m['name']}.py").is_file()
    named = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    assert set(ADDED_TO) <= named


def test_configuration_states_the_refiner_defaults():
    """refine_settings are _pgo_poses' defaults (with those of the
    functions it calls), and the cloud limits object_recon's."""
    import inspect
    from otslam_tpu_torch.kernels import icp, pose_graph, track
    from otslam_tpu_torch.pipeline import reconstruct as rc
    from otslam_tpu_torch.pipeline import refine
    cfg = json.loads((tiny.REPO / "benchmark/configs" / f"{CONFIG}.json")
                     .read_text())
    s = cfg["refine_settings"]

    def defaults(fn):
        return {k: p.default for k, p in
                inspect.signature(fn).parameters.items()}
    pgo, f2m = defaults(refine._pgo_poses), defaults(
        refine.refine_trajectory_f2m)
    loops, pts = defaults(refine.detect_loop_closures), defaults(
        refine._frame_points)
    tr, graph = defaults(track.track_frame_to_tsdf), defaults(
        pose_graph.optimize_pose_graph)
    plane = defaults(icp.icp_point_to_plane)
    assert cfg["refine"] == "pgo" and rc.REFINERS["pgo"] is refine._pgo_poses
    assert s["front_end"] == pgo["front_end"]
    assert (s["stride"], s["max_active"]) == (pgo["stride"],
                                              pgo["max_active"])
    assert (s["max_points"], s["max_depth_m"]) == (pts["max_points"],
                                                   pts["max_depth"])
    assert s["max_iterations"] == f2m["max_iterations"]
    assert (s["trust_translation_m"], s["trust_rotation_rad"]) == (
        f2m["trust_translation"], f2m["trust_rot"])
    assert (s["damping"], s["step_rotation_rad"], s["step_translation_m"]) \
        == (tr["damping"], tr["max_step_rot"], tr["max_step_tr"])
    assert (s["min_gap"], s["loop_radius_m"], s["max_loop_pairs"]) == (
        pgo["min_gap"], pgo["loop_radius"], pgo["max_loop_pairs"])
    assert s["min_fitness"] == loops["min_fitness"]
    assert tuple(s["pair_thresholds_m"]) == refine.PAIR_THRESHOLDS
    assert s["pair_iterations"] == refine.PAIR_ICP_ITERATIONS
    assert (s["pair_relative_fitness"], s["pair_relative_rmse"]) == (
        plane["relative_fitness"], plane["relative_rmse"])
    assert s["graph_iterations"] == pgo["num_iters"]
    assert (s["graph_damping"], s["anchor_weight"]) == (
        graph["damping"], graph["anchor_weight"])
    assert (s["chain_weight"], s["loop_weight"]) == (1.0, 2.0)
    base = json.loads((tiny.REPO / "benchmark/configs/object_recon.json")
                      .read_text())
    assert cfg["limits"]["cloud"] == base["limits"]["cloud"]
    for key in ("camera", "tsdf", "z_filter_threshold", "surface_samples",
                "backend", "auto_origin", "precision"):
        assert cfg[key] == base[key]


def test_pgo_reference_loads_no_program_module():
    import subprocess
    import sys
    code = ("import sys, benchmark.reference.pgo; print(sorted({m.split("
            "'.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO,
                         capture_output=True, text=True, check=True).stdout
    assert not set(eval(out)) & {"otslam_tpu_torch", "otslam_tpu", "jax",
                                 "jaxlib", "flax"}
