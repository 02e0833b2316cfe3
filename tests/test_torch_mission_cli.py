"""The `mission` CLI of otslam_tpu_torch on the CPU: a short mission at the
CLI's full widths writes a capture dataset that the port's `reconstruct`
reads. In a file of its own beside tests/test_torch_mission.py, so that
neither file bounds a parallel run."""

import json

import torch_parity  # noqa: F401  (one torch thread per test process)

START = (-0.5, 1.5, -1.2)       # sees the box (test_perception_batch.py)


def test_mission_cli_writes_a_dataset_the_port_reconstructs(tmp_path):
    """The CLI's mission at its full widths (VGA camera, 1440 beams, the
    512^2 evidence grid) on the CPU, briefly, then `reconstruct` on its
    dataset: no jax, and no kernel launch."""
    from test_torch_package import CLI, report, run_py
    work = tmp_path / "m"
    proc = run_py(CLI, "mission", "--device", "cpu", "--workdir", str(work),
                  "--perception-batch", "8", "--max-ticks", "40",
                  f"--start={','.join(map(str, START))}")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.splitlines()[0])
    assert out["platform"] == "cpu" and out["frames"] >= 1
    assert out["stable_objects"] == 1 and out["labels"] == ["Object_0"]
    r = report(proc)
    assert not r["jax"] and not r["otslam_tpu"] and not any(r["launches"])
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"reconstruction": {
        "surface_samples": 5000,
        "tsdf": {"voxel_size": 0.02, "sdf_trunc": 0.08,
                 "dims": [64, 64, 64]}}}))
    rec = run_py(CLI, "reconstruct", "--dataset", out["dataset"], "--config",
                 str(cfg_path), "--auto-origin", "--device", "cpu")
    assert rec.returncode == 0, rec.stderr
    assert f"from {out['frames']} frames" in rec.stdout
    assert not any(report(rec)["launches"])
