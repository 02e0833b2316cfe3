"""The port's CLI commands of the offline map products against the JAX
CLI on the same files (CPU): reconstruct --mesh, check-frame, probe-depth,
trajectory, hybrid-map and merge-2d.

The port's commands run in one subprocess through its main() with
--device cpu where the command takes it; the subprocess reports that
neither jax nor otslam_tpu was imported and that no kernel launched. The
JAX CLI runs in this process. Tolerances: the host-numpy commands write
what the JAX CLI writes; check-frame's voxel centroids agree to 1e-6 (the
sums within a voxel run in another order, tests/test_torch_geometry.py);
the meshes of reconstruct --mesh have vertex and face counts within 1 %
(fusion rounding ties, tests/torch_parity.py).
"""

import json

import numpy as np
import pytest

from otslam_tpu import cli as jcli
from otslam_tpu.config import CameraConfig as JCam
from otslam_tpu.core import io as jio
from otslam_tpu.core.se3 import T_FIX_OPTICAL
from otslam_tpu.pipeline.dataset import CaptureDataset as JDataset
from otslam_tpu.sim.sensors import look_at_pose
from otslam_tpu.sim.sensors import render_rgbd as j_render
from otslam_tpu.sim.world import cardboard_room as j_room
from otslam_tpu_torch.core import io as tio
from otslam_tpu_torch.kernels._build import SIGNATURES
from test_torch_package import report, run_py
from torch_parity import BOX_CENTER, J_SMALL, SMALL_CAM

CAM = dict(SMALL_CAM, depth_trunc=3.0)
CFG = {"camera": CAM, "reconstruction": {
    "camera": CAM, "tsdf": {"voxel_size": 0.02, "sdf_trunc": 0.08,
                            "dims": [64, 64, 64]}}}

# runs each argv through the port's main(), then reports the modules and
# the launches of each kernel entry point
PORT = """
import json, sys
from otslam_tpu_torch import cli
for argv in json.loads(sys.argv[1]):
    cli.main(argv)
from otslam_tpu_torch.kernels._build import SIGNATURES
from otslam_tpu_torch.utils.profiling import COUNTS
print("REPORT " + json.dumps({
    "jax": "jax" in sys.modules, "otslam_tpu": "otslam_tpu" in sys.modules,
    "launches": [COUNTS["launches." + name] for name in SIGNATURES]}))
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The commands' input files: a 4-frame capture dataset of the
    cardboard box (the JAX package's renderer and writer), its first
    frame's depth and colour, a 2D map with its YAML, an object directory
    and two PGMs to merge."""
    root = tmp_path_factory.mktemp("cli_in")
    ds = JDataset(str(root / "ds"), JCam(**CAM))
    c = np.asarray(BOX_CENTER)
    for i in range(4):
        a = 2 * np.pi * i / 4 + 0.3
        pose = look_at_pose([c[0] + np.cos(a), c[1] + np.sin(a), 0.5], c)
        d, col = j_render(j_room(), pose, J_SMALL, far=5.0)
        ds.save_frame("Object_0", np.asarray(col).astype(np.uint8),
                      np.asarray(d), pose @ T_FIX_OPTICAL.T)
    (root / "cfg.json").write_text(json.dumps(CFG))
    rng = np.random.default_rng(0)
    img = np.full((16, 16), 254, np.uint8)
    img[4:6, 4:6] = 0
    jio.write_pgm(str(root / "map.pgm"), img)
    jio.write_map_yaml(str(root / "map.yaml"), "map.pgm", 0.05,
                       (1.0, -2.0, 0.0))
    jio.write_ply(str(root / "objs" / "Object_0.ply"),
                  rng.standard_normal((30, 3)).astype(np.float32))
    old = np.full((20, 20), 254, np.uint8)
    new = rng.choice(np.array([0, 205, 254], np.uint8), (20, 20))
    jio.write_pgm(str(root / "old.pgm"), old)
    jio.write_pgm(str(root / "new.pgm"), new)
    return root


def commands(i, out, device):
    """The argv of every command, writing into `out`; `device` adds
    --device where a command takes it."""
    dev = ["--device", "cpu"] if device else []
    ds = str(i / "ds")
    return {
        "reconstruct": ["reconstruct", "--dataset", ds, "--save-dir",
                        str(out / "mesh"), "--mesh", "--auto-origin",
                        "--backend", "sparse", "--config",
                        str(i / "cfg.json")] + dev,
        "check-frame": ["check-frame", "--depth", f"{ds}/depth/Object_0_1.png",
                        "--color", f"{ds}/color/Object_0_1.jpg", "--out",
                        str(out / "frame.ply"), "--voxel", "0.02",
                        "--config", str(i / "cfg.json")] + dev,
        "check-frame-raw": ["check-frame", "--depth",
                            f"{ds}/depth/Object_0_2.png", "--out",
                            str(out / "raw.ply"), "--voxel", "0", "--trunc",
                            "2.0", "--config", str(i / "cfg.json")] + dev,
        "probe-depth": ["probe-depth", f"{ds}/depth/Object_0_1.png",
                        "--heat", str(out / "heat.png")],
        "trajectory": ["trajectory", "--poses", f"{ds}/poses", "--out",
                       str(out / "traj.ply")],
        "hybrid-map": ["hybrid-map", "--map-yaml", str(i / "map.yaml"),
                       "--map-pgm", str(i / "map.pgm"), "--objects",
                       str(i / "objs"), "--out", str(out / "hybrid.ply")],
        "merge-2d": ["merge-2d", "--old", str(i / "old.pgm"), "--new",
                     str(i / "new.pgm"), "--regions", "0,0,5,5;10,10,4,4",
                     "--out", str(out / "merged.pgm")],
    }


@pytest.fixture(scope="module")
def port_run(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("cli_port")
    proc = run_py(PORT, json.dumps(list(commands(inputs, out, True)
                                        .values())))
    assert proc.returncode == 0, proc.stderr
    return out, proc.stdout


@pytest.fixture(scope="module")
def jax_run(inputs, tmp_path_factory):
    import contextlib
    import io
    out = tmp_path_factory.mktemp("cli_jax")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for argv in commands(inputs, out, False).values():
            jcli.main(argv)
    return out, buf.getvalue()


def plys(port_run, jax_run, name):
    return (tio.read_ply(str(port_run[0] / name)),
            jio.read_ply(str(jax_run[0] / name)))


def test_port_commands_stay_off_jax_and_the_kernels(port_run):
    r = report(type("P", (), {"stdout": port_run[1], "stderr": ""}))
    assert not r["jax"] and not r["otslam_tpu"]
    assert r["launches"] == [0] * len(SIGNATURES)
    for tag in ("Object_0: ", "points ->", "poses ->", "hybrid map: ",
                "merged 2 regions", "heat image ->"):
        assert tag in port_run[1], tag


def test_reconstruct_mesh_matches_jax(port_run, jax_run):
    t, j = plys(port_run, jax_run, "mesh/Object_0.ply")
    assert "faces" in t and "faces" in j
    nv_t, nv_j = len(t["points"]), len(j["points"])
    nf_t, nf_j = len(t["faces"]), len(j["faces"])
    print(f"vertices {nv_t} vs {nv_j}, faces {nf_t} vs {nf_j}")
    assert nv_t > 1000 and abs(nv_t - nv_j) <= 0.01 * nv_j
    assert abs(nf_t - nf_j) <= 0.01 * nf_j
    assert t["faces"].min() >= 0 and t["faces"].max() < nv_t
    line = [ln for ln in port_run[1].splitlines() if "Object_0: " in ln][0]
    assert f"Object_0: {nv_t} points from 4 frames" in line


@pytest.mark.parametrize("name", ["frame.ply", "raw.ply"])
def test_check_frame_matches_jax(port_run, jax_run, name):
    t, j = plys(port_run, jax_run, name)
    assert sorted(t) == sorted(j)
    assert len(t["points"]) == len(j["points"]) > 100
    np.testing.assert_allclose(t["points"], j["points"], rtol=0, atol=1e-6)
    if "colors" in j:
        # uchar colours in the file: a rounding step at most
        np.testing.assert_allclose(t["colors"], j["colors"], rtol=0,
                                   atol=1 / 255 + 1e-6)


def test_probe_depth_matches_jax(port_run, jax_run):
    def stats(stdout):
        start = stdout.index("{\n")
        return json.loads(stdout[start:stdout.index("\n}", start) + 2])
    assert stats(port_run[1]) == stats(jax_run[1])
    assert stats(port_run[1])["dtype"] == "uint16"
    np.testing.assert_array_equal(tio.read_color(str(port_run[0] / "heat.png")),
                                  jio.read_color(str(jax_run[0] / "heat.png")))


@pytest.mark.parametrize("name", ["traj.ply", "hybrid.ply"])
def test_host_plys_match_jax(port_run, jax_run, name):
    t, j = plys(port_run, jax_run, name)
    assert sorted(t) == sorted(j)
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])
    assert len(t["points"]) == {"traj.ply": 16, "hybrid.ply": 34}[name]


def test_merge_2d_matches_jax(port_run, jax_run):
    t = (port_run[0] / "merged.pgm").read_bytes()
    assert t == (jax_run[0] / "merged.pgm").read_bytes()
    img = tio.read_pgm(str(port_run[0] / "merged.pgm"))
    assert img[7, 7] == 254
