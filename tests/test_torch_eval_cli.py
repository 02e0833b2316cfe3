"""The port's capture, report and headline commands against the JAX CLI
(CPU).

The port's commands run in one subprocess through its main() with
--device cpu; the subprocess reports that neither jax nor otslam_tpu was
imported and that no kernel launched. The JAX CLI runs in this process.

* capture at a 160x120 camera: the same saved frame (colour equal, depth
  within 1 mm on every pixel, equal on all but 0.1 % of them: the
  renderers round the last bit differently) and the same pose file;
* report: the same table text and a PNG;
* headline at the CLI's VGA camera with --frames 2 --room-frames 2, on a
  mission-style object directory (the objects_dir mode: the other mode's
  100k-sample clouds keep the port's plain CPU nearest neighbour busy for
  minutes at VGA; it is held to JAX at 160x120 in
  tests/test_torch_headline.py): the same JSON keys, and its accuracies
  within 0.01 cm and reductions within 0.05 points.
"""

import contextlib
import io
import json

import numpy as np
import pytest

from otslam_tpu import cli as jcli
from otslam_tpu.core import io as jio
from otslam_tpu.eval.scenarios import sample_object_surfaces
from otslam_tpu.sim.world import cardboard_room
from otslam_tpu_torch.core import io as tio
from otslam_tpu_torch.kernels._build import SIGNATURES
from test_torch_map_cli import PORT
from test_torch_package import report, run_py
from torch_parity import SMALL_CAM

CFG = {"camera": SMALL_CAM}
RESULTS = "Cardboard Box,0.436,1.018;Cone,2.48,4.18;Table & Chair,2.6,8.5"


def commands(root, out, device):
    dev = ["--device", "cpu"] if device else []
    return [
        ["capture", "--workdir", str(out / "ds"), "--pose", "1.0,0.5,0.3",
         "--label", "Object_0", "--config", str(root / "cfg.json")] + dev,
        ["capture", "--workdir", str(out / "ds"), "--scenario", "cone",
         "--pose=-1.2,0.4,-2.0", "--height", "0.4", "--label", "Object_0",
         "--config", str(root / "cfg.json")] + dev,
        ["report", "--results", RESULTS, "--plot", str(out / "plot.png"),
         "--vs-reference"],
        ["headline", "--workdir", str(out / "hl"), "--frames", "2",
         "--room-frames", "2", "--objects-dir", str(root / "recon")] + dev,
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_cli")
    (root / "cfg.json").write_text(json.dumps(CFG))
    pts = sample_object_surfaces([cardboard_room().objects[0]], 5000, seed=1)
    pts = pts[pts[:, 2] >= 0.03]
    jio.write_ply(str(root / "recon" / "Object_3.ply"), pts,
                  colors=np.full_like(pts, 0.5))
    port, jax = root / "port", root / "jax"
    proc = run_py(PORT, json.dumps(commands(root, port, True)))
    assert proc.returncode == 0, proc.stderr
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for argv in commands(root, jax, False):
            jcli.main(argv)
    return port, proc.stdout, jax, buf.getvalue()


def headline_json(stdout: str) -> dict:
    start = stdout.index('{\n  "objects"')
    return json.loads(stdout[start:stdout.index("\n}", start) + 2])


def test_port_commands_stay_off_jax_and_the_kernels(runs):
    r = report(type("P", (), {"stdout": runs[1], "stderr": ""}))
    assert not r["jax"] and not r["otslam_tpu"]
    assert r["launches"] == [0] * len(SIGNATURES)


def test_capture_saves_the_jax_frame_and_pose(runs):
    port, t_out, jax, j_out = runs
    for n in (1, 2):
        assert f"captured Object_0_{n} at " in t_out
        name = f"Object_0_{n}"
        line = [ln for ln in t_out.splitlines() if name in ln]
        assert line and line[0] in j_out
        np.testing.assert_array_equal(
            tio.read_color(str(port / "ds" / "color" / f"{name}.jpg")),
            jio.read_color(str(jax / "ds" / "color" / f"{name}.jpg")))
        dt = tio.read_depth_png(str(port / "ds" / "depth" / f"{name}.png"))
        dj = jio.read_depth_png(str(jax / "ds" / "depth" / f"{name}.png"))
        assert (dj > 0).mean() > 0.5
        assert np.abs(dt - dj).max() <= 1e-3 + 1e-6
        assert (dt != dj).mean() <= 1e-3
        assert ((port / "ds" / "poses" / f"{name}.txt").read_text()
                == (jax / "ds" / "poses" / f"{name}.txt").read_text())


def test_report_prints_the_jax_table(runs):
    port, t_out, jax, j_out = runs
    table = j_out[j_out.index("Scenario"):j_out.index("plot -> ")]
    assert table.count("\n") == 5
    assert table in t_out
    with open(port / "plot.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_headline_prints_the_jax_report(runs):
    t, j = headline_json(runs[1]), headline_json(runs[3])
    assert sorted(t) == sorted(j)
    assert sorted(t["objects"]) == sorted(j["objects"])
    m, mj = t["objects"]["cardboard_box"], j["objects"]["cardboard_box"]
    assert sorted(m) == sorted(mj) and m["cloud"] == "Object_3"
    for k in ("proposal_accuracy_cm", "proposal_completeness_cm",
              "dense_accuracy_cm", "dense_completeness_cm"):
        assert abs(m[k] - mj[k]) <= 0.01, k
    for k in ("size_reduction_percent", "size_reduction_downsampled_percent",
              "size_reduction_voxel_percent"):
        assert abs(t[k] - j[k]) <= 0.05, k
    assert t["hybrid_map_path"].endswith("hybrid.ply")
