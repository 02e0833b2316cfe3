"""The two example ports on the CPU: examples/full_workflow_torch.py against
the JAX package's examples/full_workflow.py (the same survey, mission and
report), and examples/production_mission_torch.py at small settings (the
full_room estimated-pose mission for 120 ticks at 160x120, then its
reconstruction and headline report)."""

import dataclasses
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

import otslam_tpu_torch.config as tcfg

import torch_parity  # noqa: F401  (one torch thread per test process)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def printed(text: str, workdir) -> list:
    """The example's printed lines up to its JSON report, with its
    workdir replaced."""
    lines = text.split("== evaluation ==")[0].splitlines()
    return [ln.replace(str(workdir), "W") for ln in lines]


def test_full_workflow_matches_jax(tmp_path, capsys):
    tport = load("full_workflow_torch").main(str(tmp_path / "torch"),
                                             device="cpu")
    tout = printed(capsys.readouterr().out, tmp_path / "torch")
    jrep = load("full_workflow").main(str(tmp_path / "jax"))
    jout = printed(capsys.readouterr().out, tmp_path / "jax")
    assert set(tport) == set(jrep)
    assert tport["reference_cardboard"] == jrep["reference_cardboard"]
    # the survey's map and the mission's decisions print equal; the point
    # counts differ only through the fusion's rounding ties (ROADMAP C)
    counts = re.compile(r"\d+ points")
    assert [counts.sub("N points", ln) for ln in tout] == \
        [counts.sub("N points", ln) for ln in jout]
    assert any("missions: " in ln and "labels: ['Object_0']" in ln
               for ln in tout)
    for key in ("accuracy_cm", "completeness_cm"):
        assert tport[key] == pytest.approx(jrep[key], abs=0.03), key
    assert tport["accuracy_cm"] < 1.0
    assert (tmp_path / "torch" / "hybrid_map.ply").is_file()


def test_production_mission_runs_on_the_cpu(tmp_path, capsys):
    cam = tcfg.CameraConfig(width=160, height=120, fx=141.4002, fy=141.4002,
                            cx=80.5, cy=60.5)
    cfg = tcfg.OTSLAMConfig(
        camera=cam, tracker=tcfg.TrackerConfig.update_pipeline_profile())
    cfg = dataclasses.replace(cfg, reconstruction=dataclasses.replace(
        cfg.reconstruction, camera=cam, surface_samples=3000))
    rec = load("production_mission_torch").main(
        str(tmp_path), device="cpu", max_ticks=120, cfg=cfg, room_frames=4)
    out = capsys.readouterr().out
    runner, summary = rec["runner"], rec["summary"]
    assert runner.perception_batch == 8         # the CPU's default batch
    assert runner.use_localizer and runner.odom_noise_per_m == 0.01
    assert runner.device.type == "cpu"
    assert re.search(r"^mission: \d+ missions, labels \[.*\], removed "
                     r"checks visited \[.*\]$", out, re.M)
    assert summary.missions_completed >= 1 and summary.labels
    assert set(rec["reconstruction"]) == set(summary.labels)
    for name, res in rec["reconstruction"].items():
        assert f"  {name}: {len(res.points)} pts from {res.num_frames} " \
            "frames" in out
        if name.startswith("Object_"):
            assert len(res.points) > 0 and np.isfinite(res.points).all()
    rep = rec["headline"]
    assert len(rep["objects"]) == 8
    assert all("cloud" in e for e in rep["objects"].values()
               if e.get("scanned", True))
    assert any(e.get("scanned", True) for e in rep["objects"].values())
    assert np.isfinite(rep["combined_accuracy_cm"])
    assert (tmp_path / "headline" / "hybrid.ply").is_file()
