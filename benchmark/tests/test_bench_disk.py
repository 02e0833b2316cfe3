"""The on-disk recon cell's driver, readers, control and faults at tiny
sizes on the CPU, from the benchmark's files alone; and the same cell on
a program whose `reconstruct_object` takes no `timings=` (the load's
readers then report nothing)."""

from __future__ import annotations

import inspect
import json

import numpy as np
import pytest
import torch

import tiny
from benchmark import harness
from benchmark.drivers import recon_disk

CELL = "recon.captures.disk"
LOAD_METRICS = ("recon.load_ms", "recon.decode_ms", "recon.read_mb")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny.tiny_root(tmp_path_factory.mktemp("disk"))
    base = r / "benchmark"
    small = json.loads((base / "configs/object_recon.json").read_text())
    p = base / "configs/object_recon.disk.json"
    cfg = json.loads(p.read_text())
    for key in ("camera", "tsdf", "surface_samples"):
        cfg[key] = small[key]
    p.write_text(json.dumps(cfg))
    p = base / "traffic/captures.disk.json"
    t = json.loads(p.read_text())
    t["objects"] = ["chair_1", "cone_blue"]
    p.write_text(json.dumps(t))
    return r


def drive(root, seed=4294967311, trace=False, control=False):
    spec = harness.load_spec(root)
    _, cfg, traffic = harness.cell_files(spec, CELL, root / "benchmark")
    return recon_disk.run(cfg, traffic, seed, 0.3, trace,
                          torch.device("cpu"), 1, 0.0, control)


def read(root, name, ctx):
    return harness.reader(name, root / "benchmark")(ctx)


def test_cell_runs_and_agrees_with_reference(root, capsys):
    from benchmark import run
    for trace in (0, 1):
        assert run.main(["--workload", CELL, "--seed", "4294967297",
                         "--seconds", "0.3", "--trace", str(trace)],
                        device="cpu", root=root) == 0
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert res["correct"] and res["failed"] == 0
        assert res["attempted"] >= 2
        names = set(res["metrics"])
        if trace:
            assert set(LOAD_METRICS) | {"recon.fuse_ms", "recon.upload_mb",
                                        "recon.syncs"} <= names
        else:
            assert names == {"objects_per_s", "setup_s"}
        assert res["checks"]["extrinsics_gap"] == {"value": 0.0,
                                                   "at_most": 0}


def test_load_readers(root):
    ctx = drive(root, trace=True)
    assert ctx["checks"].correct()
    recs = [t["trace"] for t in ctx["stages"]]
    load = [1e-6 * sum(s[3] - s[2] for s in r["spans"]
                       if s[0] == "recon.load") for r in recs]
    assert read(root, "recon.load_ms", ctx) == pytest.approx(np.mean(load))
    assert 0 < read(root, "recon.decode_ms", ctx) \
        < read(root, "recon.load_ms", ctx)
    mb = read(root, "recon.read_mb", ctx)
    assert mb == pytest.approx(
        1e-6 * np.mean([r["counts"]["load.bytes"] for r in recs]))
    assert all(t["load"] > 0 for t in ctx["stages"])


def test_program_without_load_spans(root, monkeypatch, capsys):
    """A program whose reconstruct_object takes no timings= is traced
    through load_object and reconstruct_frames(timings=): its stage
    readers read, the load's report nothing, and the answers are judged."""
    from otslam_tpu_torch.pipeline import reconstruct as prog
    full = prog.reconstruct_object

    def older(ds, obj_name, cfg=None, backend="pallas", save_dir=None,
              z_filter=True, seed=0, frame_numbers=None, output="cloud",
              auto_origin=False, refine="none", auto_dims=None,
              device="cuda", draws=None):
        return full(ds, obj_name, cfg, backend, save_dir, z_filter, seed,
                    frame_numbers, output, auto_origin, refine, auto_dims,
                    device, draws)
    monkeypatch.setattr(prog, "reconstruct_object", older)
    assert "timings" not in inspect.signature(
        prog.reconstruct_object).parameters
    ctx = drive(root, trace=True)
    assert ctx["checks"].correct() and ctx["failed"] == 0
    for name in LOAD_METRICS:
        assert read(root, name, ctx) is None, name
    assert read(root, "recon.fuse_ms", ctx) > 0
    assert read(root, "recon.extract_ms", ctx) > 0
    for t in ctx["stages"]:
        assert "load" not in t
        assert all(not s[0].startswith(("recon.load", "load."))
                   for s in t["trace"]["spans"])


@pytest.mark.parametrize("name", LOAD_METRICS)
def test_readers_report_nothing_without_records(root, name):
    assert read(root, name, {"stages": []}) is None
    assert read(root, name, {"stages": [{"fuse": 0.1}]}) is None
    assert read(root, name, {"stages": [{"trace": {"spans": [
        ["recon.fuse", "recon.object", 0, 10]], "counts": {}}}]}) is None


def test_control_is_not_correct(root, capsys):
    ctx = drive(root, control=True)
    assert ctx["checks"].correct()
    assert not ctx["control"].correct()
    assert ctx["control"].values["extrinsics_gap"] > 0
    err = capsys.readouterr().err
    assert "planes chair_1: {'depth_gap_m': 0.0, 'color_gap': 0.0" in err


def _fault_color(monkeypatch):
    from otslam_tpu_torch.core import io as tio
    plain = tio.decode_color
    monkeypatch.setattr(tio, "decode_color", lambda data: np.minimum(
        plain(data), 254) + np.uint8(1))


def _fault_extrinsic(monkeypatch):
    from otslam_tpu_torch.pipeline import dataset
    plain = dataset.pose_to_extrinsic
    monkeypatch.setattr(dataset, "pose_to_extrinsic",
                        lambda pose, t: plain(pose, t) + 1e-6)


def _fault_depth_scale(monkeypatch):
    from otslam_tpu_torch.core import io as tio
    plain = tio.decode_depth_png
    monkeypatch.setattr(tio, "decode_depth_png",
                        lambda data: (plain(data) // 2) * 2)


@pytest.mark.parametrize("fault", [_fault_color, _fault_extrinsic,
                                   _fault_depth_scale])
def test_faulty_loader_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    ctx = drive(root)
    assert not ctx["checks"].correct()
