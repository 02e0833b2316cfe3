"""The mission cell's driver, reference, control and faults at a tiny size
on the CPU: a few dozen ticks at 160x120, perception batch 8."""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tiny
from benchmark import harness
from benchmark.drivers import mission

CELL = "mission.full_room"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("mission"))


@pytest.fixture(autouse=True)
def tmpdir_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def test_cell_runs_and_agrees_with_reference(root, capsys):
    from benchmark import run
    for trace in (0, 1):
        assert run.main(["--workload", CELL, "--seed", "4294967299",
                         "--seconds", "0.1", "--trace", str(trace)],
                        device="cpu", root=root) == 0
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert res["correct"] and res["attempted"] >= 1
        names = set(res["metrics"])
        if trace:
            assert {"mission.perception_ms", "mission.localize_ms",
                    "mission.sensors_pct", "mission.control_pct"} <= names
        else:
            assert {"ticks_per_s", "setup_s"} <= names


def test_control_is_not_correct(root):
    spec = harness.load_spec(root)
    _, cfg, traffic = harness.cell_files(spec, CELL, root / "benchmark")
    ctx = mission.run(cfg, traffic, 3, 0.1, False, torch.device("cpu"), 1,
                      0.0, control=True)
    assert ctx["checks"].correct()
    assert not ctx["control"].correct()


def _fault_unchanged(monkeypatch):
    from otslam_tpu_torch.sim import runner
    orig = runner.perception_ticks

    def unchanged(grid, res, ox, oy, new_grid, gone_grid, *a, **k):
        out = orig(grid, res, ox, oy, new_grid, gone_grid, *a, **k)
        return out._replace(new_grid=new_grid, gone_grid=gone_grid)
    monkeypatch.setattr(runner, "perception_ticks", unchanged)


def _fault_half_batch(monkeypatch):
    from otslam_tpu_torch.sim import runner
    orig = runner.perception_ticks

    def half(grid, res, ox, oy, ng, gg, reals, poses, dts, *a, **k):
        h = max(1, reals.shape[0] // 2)
        idx = torch.arange(reals.shape[0]) % h
        return orig(grid, res, ox, oy, ng, gg, reals[idx], poses[idx],
                    dts, *a, **k)
    monkeypatch.setattr(runner, "perception_ticks", half)


def _fault_altered_answer(monkeypatch):
    from otslam_tpu_torch.mapping import localize
    orig = localize.ScanLocalizer.localize

    def moved(self, *a, **k):
        r = orig(self, *a, **k)
        r.x += 0.01
        return r
    monkeypatch.setattr(localize.ScanLocalizer, "localize", moved)


def _fault_final_pose_off(monkeypatch):
    from otslam_tpu_torch.sim import runner
    orig = runner.MissionRunner.run

    def off(self, *a, **k):
        s = orig(self, *a, **k)
        self.x += 0.5
        return s
    monkeypatch.setattr(runner.MissionRunner, "run", off)


FAULTS = {"state_unchanged": _fault_unchanged,
          "half_batch": _fault_half_batch,
          "answer_altered": _fault_altered_answer,
          "final_pose_off": _fault_final_pose_off}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_turns_correct_false(root, fault, monkeypatch, capsys):
    from benchmark import run
    FAULTS[fault](monkeypatch)
    assert run.main(["--workload", CELL, "--seed", "5", "--seconds", "0.1",
                     "--trace", "0"], device="cpu", root=root) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False


def test_judge_holds_a_program_that_updates_in_place(root, monkeypatch,
                                                     capsys):
    """A sound program that writes its evidence grids into the tensors it
    was handed stays correct: the judge keeps copies of what it samples."""
    from benchmark import run
    from otslam_tpu_torch.sim import runner
    orig = runner.perception_ticks

    def in_place(grid, res, ox, oy, new_grid, gone_grid, *a, **k):
        out = orig(grid, res, ox, oy, new_grid, gone_grid, *a, **k)
        new_grid.copy_(out.new_grid)
        gone_grid.copy_(out.gone_grid)
        return out._replace(new_grid=new_grid, gone_grid=gone_grid)
    monkeypatch.setattr(runner, "perception_ticks", in_place)
    assert run.main(["--workload", CELL, "--seed", "8", "--seconds", "0.1",
                     "--trace", "0"], device="cpu", root=root) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True


TRAFFIC = json.loads((tiny.REPO / "benchmark/traffic/mission.json"
                      ).read_text())


def _finished_mission(tmp_path, labels=("chair_site", "table_site", "box"),
                      missions=5, pose_off=0.03, phantom=(4.1, -3.9),
                      members=5):
    """A stub of a finished full_room mission and its dataset's poses: a
    chair orbit of 1.2 m, the table's of 2 m, the box's far away."""
    sites = {"chair_site": ((-1.71, -2.1), 1.2),
             "table_site": ((-2.23, -3.31), 2.0), "box": ((3.0, 3.0), 1.0)}
    poses = tmp_path / "dataset" / "poses"
    poses.mkdir(parents=True, exist_ok=True)
    for label in labels:
        (cx, cy), rad = sites[label]
        for i in range(6):
            a = 2 * np.pi * i / 6
            q = np.eye(4)
            q[:2, 3] = cx + rad * np.cos(a), cy + rad * np.sin(a)
            np.savetxt(poses / f"{label}_{i + 1}.txt", q)
    r = SimpleNamespace(
        removed_tracker=SimpleNamespace(stable_objects=[
            SimpleNamespace(cx=phantom[0], cy=phantom[1])]),
        tracker=SimpleNamespace(stable_objects=[
            SimpleNamespace(members=list(range(members)))]),
        sender=SimpleNamespace(visited_removed_ids={5000}),
        pose_estimate=(1.0 + pose_off, 2.0, 0.0), x=1.0, y=2.0)
    s = SimpleNamespace(missions_completed=missions, labels=list(labels),
                        frames_captured=6 * len(labels))
    return r, s, str(tmp_path)


SHORT_MISSIONS = {
    "sound": {},
    "ended_early": {"missions": 2, "labels": ("chair_site",)},
    "table_skipped": {"labels": ("chair_site", "box", "box")},
    "phantom_missed": {"phantom": (0.0, 0.0)},
    "group_split": {"members": 2},
    "pose_drifted": {"pose_off": 0.3},
}


@pytest.mark.parametrize("case", list(SHORT_MISSIONS))
def test_outcome_gates(case, tmp_path):
    """tests/test_full_mission.py's gates on a mission's outcome, as the
    traffic states them: a sound finish passes, each shortfall fails."""
    got = mission.outcome(*_finished_mission(tmp_path,
                                             **SHORT_MISSIONS[case]),
                          TRAFFIC)
    checks = harness.Checks(TRAFFIC["outcome"])
    for k, v in got.items():
        checks.add(k, v)
    assert checks.correct() is (case == "sound"), checks.record()
