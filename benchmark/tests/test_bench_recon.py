"""The recon cells' driver, reference, control and faults at tiny sizes on
the CPU, from the benchmark's files alone.

Each fault breaks the timed path underneath a whole run (the harness's look
for a card skipped) and must turn `correct` false.
"""

from __future__ import annotations

import dataclasses
import json
from itertools import islice

import numpy as np
import pytest
import torch

import tiny
from benchmark import harness
from benchmark.drivers import recon

CELLS = {"recon.captures": "captures", "recon.orbit": "orbit",
         "recon.mesh": "captures.mesh"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("recon"))


def drive(root, cell, seed=11, seconds=0.3, trace=False, control=False):
    spec = harness.load_spec(root)
    entry, cfg, traffic = harness.cell_files(spec, cell, root / "benchmark")
    return recon.run(cfg, traffic, seed, seconds, trace,
                     torch.device("cpu"), 1, 0.0, control)


@pytest.mark.parametrize("cell", list(CELLS))
def test_cell_runs_and_agrees_with_reference(root, cell, capsys):
    from benchmark import run
    for trace in (0, 1):
        assert run.main(["--workload", cell, "--seed", "4294967297",
                         "--seconds", "0.3", "--trace", str(trace)],
                        device="cpu", root=root) == 0
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert res["correct"] and res["failed"] == 0
        assert res["attempted"] >= 1
        names = set(res["metrics"])
        if trace:
            assert {"recon.fuse_ms", "recon.extract_ms"} <= names
        else:
            assert {"objects_per_s", "setup_s"} <= names
        assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", list(CELLS))
def test_control_is_not_correct(root, cell):
    ctx = drive(root, cell, control=True)
    assert ctx["checks"].correct()
    assert not ctx["control"].correct()


def test_seed_orders_and_phases_the_same_work(root):
    from benchmark.inputs.captures import make_captures
    _, cfg, traffic = harness.cell_files(harness.load_spec(root),
                                         "recon.captures", root / "benchmark")
    a, ra = make_captures(traffic, cfg["camera"], 1, "cpu")
    b, rb = make_captures(traffic, cfg["camera"], 2**33 + 5, "cpu")
    a2, ra2 = make_captures(traffic, cfg["camera"], 1, "cpu")
    oa, ob, oa2 = (list(islice(r, 50)) for r in (ra, rb, ra2))
    assert oa == oa2 and oa != ob
    assert all(sorted(r) == sorted(traffic["objects"]) for r in oa)
    for name in a:
        assert a[name].depths.shape == b[name].depths.shape
        np.testing.assert_array_equal(a[name].depths, a2[name].depths)


def _fault_unchanged(monkeypatch):
    from otslam_tpu_torch.kernels import tsdf_cuda
    monkeypatch.setattr(tsdf_cuda, "fuse_blocks", lambda *a, **k: None)


def _fault_half_batch(monkeypatch):
    from otslam_tpu_torch.pipeline import reconstruct as prog
    orig = prog.fuse_frames

    def half(depths, colors, extrinsics, *a, **k):
        n = max(1, len(depths) // 2)
        return orig(depths[:n], colors[:n], extrinsics[:n], *a, **k)
    monkeypatch.setattr(prog, "fuse_frames", half)


def _fault_altered_answer(monkeypatch):
    from otslam_tpu_torch.pipeline import reconstruct as prog
    orig_cloud, orig_mesh = prog.extract_filtered_cloud, prog.extract_mesh

    def cloud(*a, **k):
        res = orig_cloud(*a, **k)
        res.points[len(res.points) // 2, 0] += 1e-3
        return res

    def mesh(*a, **k):
        v, f, c, n = orig_mesh(*a, **k)
        v[len(v) // 2, 2] += 1e-3
        return v, f, c, n
    monkeypatch.setattr(prog, "extract_filtered_cloud", cloud)
    monkeypatch.setattr(prog, "extract_mesh", mesh)


FAULTS = {"state_unchanged": _fault_unchanged,
          "half_batch": _fault_half_batch,
          "answer_altered": _fault_altered_answer}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", ["recon.captures", "recon.mesh"])
def test_fault_turns_correct_false(root, cell, fault, monkeypatch, capsys):
    from benchmark import run
    FAULTS[fault](monkeypatch)
    assert run.main(["--workload", cell, "--seed", "5", "--seconds", "0.2",
                     "--trace", "0"], device="cpu", root=root) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False


def _fault_cloud_truncated(monkeypatch):
    from otslam_tpu_torch.pipeline import reconstruct as prog
    orig = prog.extract_filtered_cloud

    def half(*a, **k):
        res = orig(*a, **k)
        n = len(res.points) // 2
        return dataclasses.replace(res, points=res.points[:n],
                                   colors=res.colors[:n],
                                   normals=res.normals[:n])
    monkeypatch.setattr(prog, "extract_filtered_cloud", half)


def _fault_floor_raised(monkeypatch):
    from otslam_tpu_torch.pipeline import reconstruct as prog
    orig = prog.extract_filtered_cloud

    def raised(vol, cfg, *a, **k):
        return orig(vol, dataclasses.replace(
            cfg, z_filter_threshold=cfg.z_filter_threshold + 0.05), *a, **k)
    monkeypatch.setattr(prog, "extract_filtered_cloud", raised)


CLOUD_FAULTS = {"cloud_truncated": _fault_cloud_truncated,
                "floor_raised": _fault_floor_raised}


@pytest.mark.parametrize("fault", list(CLOUD_FAULTS))
def test_cloud_fault_turns_correct_false(root, fault, monkeypatch, capsys):
    """The served cloud is held to the reference's row for row: fewer rows,
    or a floor cut higher, are not correct."""
    from benchmark import run
    CLOUD_FAULTS[fault](monkeypatch)
    assert run.main(["--workload", "recon.captures", "--seed", "6",
                     "--seconds", "0.2", "--trace", "0"],
                    device="cpu", root=root) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False
    assert res["checks"]["point_count_gap"]["value"] > 0
