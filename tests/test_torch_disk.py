"""The on-disk deployment: the port's `CaptureDataset.load_object` and
`reconstruct_object` over a capture folder in the scanner's layout, against
the benchmark's plain reader (benchmark/reference/disk.py: PIL and NumPy)
and plain reference (benchmark/reference/recon.py), on tiny seeded folders
written by the benchmark's writer (benchmark/inputs/disk.py); the load's
spans and counters in one record; the file read + decode split against
OpenCV's imread.

This file imports neither jax nor otslam_tpu; on the card run it with

    python -m pytest --noconftest -q tests/test_torch_disk.py
"""

import ast
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.drivers.recon import compare, program_config  # noqa: E402
from benchmark.inputs import disk  # noqa: E402
from benchmark.reference import disk as ref_disk  # noqa: E402
from benchmark.reference import recon as reference  # noqa: E402
from otslam_tpu_torch.core import io as tio  # noqa: E402
from otslam_tpu_torch.core.camera import PinholeIntrinsics  # noqa: E402
from otslam_tpu_torch.pipeline import reconstruct as rc  # noqa: E402
from otslam_tpu_torch.pipeline.dataset import CaptureDataset  # noqa: E402

cv2 = pytest.importorskip("cv2")

CONFIG = json.loads(
    (REPO / "benchmark/configs/object_recon.disk.json").read_text())
TRAFFIC = json.loads(
    (REPO / "benchmark/traffic/captures.disk.json").read_text())
TINY = dict(CONFIG, surface_samples=1500)
TINY["camera"] = dict(CONFIG["camera"], width=64, height=48, fx=56.56009,
                      fy=56.56009, cx=32.05, cy=24.05)
TINY["tsdf"] = dict(CONFIG["tsdf"], voxel_size=0.02, sdf_trunc=0.08,
                    dims=[64, 64, 64], origin=[-0.64, -0.64, -0.14])
OBJECTS = ("chair_1", "cardboard_box", "cone_blue")
LIMITS = {**CONFIG["limits"]["cloud"], **CONFIG["limits"]["poses"]}
TREE = {"recon.object": None, "recon.load": "recon.object",
        "load.read": "recon.load", "load.decode": "recon.load",
        "load.convert": "recon.load", "recon.auto_volume": "recon.object",
        "recon.fuse": "recon.object", "recon.extract": "recon.object"}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """(folder, files by object, draws): three objects x 3 frames at
    64 x 48 from a seed past 32 bits, in the scanner's layout."""
    traffic = dict(TRAFFIC, objects=list(OBJECTS),
                   circle=dict(TRAFFIC["circle"], min_scan_points=3,
                               scan_point_interval=100.0))
    caps, _ = disk.scanner_captures(traffic, TINY["camera"], 2**33 + 17,
                                    "cpu")
    root = str(tmp_path_factory.mktemp("disk") / "captures")
    files = disk.write_folder(caps, root, TINY["camera"]["depth_scale"])
    draws = torch.rand(TINY["surface_samples"],
                       generator=torch.Generator().manual_seed(5))
    return root, files, draws


def dataset(root):
    return CaptureDataset(root, camera=program_config(TINY).camera)


def call(root, name, draws, **kw):
    pcfg = program_config(TINY)
    return rc.reconstruct_object(dataset(root), name, pcfg, TINY["backend"],
                                 output="cloud", auto_origin=True,
                                 device="cpu", draws=draws, **kw)


def test_folder_holds_the_scanners_files(folder):
    root, files, _ = folder
    assert ref_disk.object_names(root) == sorted(OBJECTS)
    assert dataset(root).object_names() == sorted(OBJECTS)
    for name in OBJECTS:
        assert len(files[name]) == 9
        depth = cv2.imread(files[name][1], cv2.IMREAD_UNCHANGED)
        assert depth.dtype == np.uint16 and depth.shape == (48, 64)
        assert depth.max() <= 1000 * TINY["camera"]["depth_max"]


@pytest.mark.parametrize("name", OBJECTS)
def test_load_object_equals_the_plain_reader(folder, name):
    root, _, _ = folder
    batch = dataset(root).load_object(name)
    cap = ref_disk.read_object(root, name, TINY["camera"])
    for got, want in ((batch.depths, cap.depths), (batch.colors, cap.colors),
                      (batch.extrinsics, cap.extrinsics),
                      (batch.poses, cap.poses)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert batch.depths.max() <= TINY["camera"]["depth_trunc"]


@pytest.mark.parametrize("name", OBJECTS)
def test_reconstruct_object_agrees_with_the_reference(folder, name):
    root, _, draws = folder
    res = call(root, name, draws)
    cap = ref_disk.read_object(root, name, TINY["camera"])
    intr_r, params = reference.params_from_config(TINY)
    ref = reference.reconstruct(cap, intr_r, params, draws, "cpu", "cloud")
    gaps = compare(res, ref, "cloud")
    gaps["extrinsics_gap"] = float(np.abs(res.extrinsics
                                          - cap.extrinsics).max())
    assert len(res.points) > 100
    for k, v in gaps.items():
        assert v <= LIMITS[k]["at_most"], (k, v)


def test_traced_record_holds_the_load_under_one_recorder(folder):
    root, files, draws = folder
    timings = {}
    res = call(root, "chair_1", draws, timings=timings)
    assert list(timings) == ["load", "auto_volume", "fuse", "extract",
                             "trace"]
    rec = timings["trace"]
    parents = {s[0]: s[1] for s in rec["spans"]}
    for name, parent in TREE.items():
        assert parents[name] == parent, name
    names = [s[0] for s in rec["spans"]]
    assert names.count("load.read") == names.count("load.decode") \
        == names.count("load.convert") == 1     # one span a phase
    assert names.count("recon.object") == 1
    assert rec["frames"] == res.num_frames == 3
    assert rec["counts"]["load.frames"] == 3
    assert rec["counts"]["load.bytes"] == sum(os.path.getsize(f)
                                              for f in files["chair_1"])
    assert "recon.objects" not in rec["counts"]     # counted before it opens
    load = next(s for s in rec["spans"] if s[0] == "recon.load")
    assert timings["load"] == pytest.approx(1e-9 * (load[3] - load[2]))
    for s in rec["spans"]:
        if s[1] == "recon.load":
            assert load[2] <= s[2] <= s[3] <= load[3]
    plain = call(root, "chair_1", draws)
    for a, b in ((res.points, plain.points), (res.colors, plain.colors),
                 (res.normals, plain.normals)):
        np.testing.assert_array_equal(a, b)


def test_reconstruct_object_is_load_then_frames(folder, tmp_path):
    root, _, draws = folder
    res = call(root, "cone_blue", draws, save_dir=str(tmp_path))
    pcfg = program_config(TINY)
    ds = dataset(root)
    frames = rc.reconstruct_frames(
        ds.load_object("cone_blue"), PinholeIntrinsics.from_config(ds.camera),
        pcfg, TINY["backend"], output="cloud", auto_origin=True,
        device="cpu", draws=draws)
    np.testing.assert_array_equal(res.points, frames.points)
    np.testing.assert_array_equal(res.colors, frames.colors)
    np.testing.assert_array_equal(res.extrinsics, frames.extrinsics)
    ply = tio.read_ply(str(tmp_path / "cone_blue.ply"))
    np.testing.assert_array_equal(ply["points"],
                                  res.points.astype(np.float32))


@pytest.mark.parametrize("kind", ["jpg", "png16"])
def test_read_then_decode_equals_imread(folder, kind):
    root, files, _ = folder
    for name in OBJECTS:
        if kind == "jpg":
            path = files[name][0]
            want = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
            got = tio.decode_color(tio.read_bytes(path))
            np.testing.assert_array_equal(tio.read_color(path), want)
        else:
            path = files[name][1]
            want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            got = tio.decode_depth_png(tio.read_bytes(path))
            np.testing.assert_array_equal(
                tio.read_depth_png(path), want.astype(np.float32) / 1000.0)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_pose_bytes_parse_as_the_file(folder):
    root, files, _ = folder
    for name in OBJECTS:
        path = files[name][2]
        got = tio.parse_pose_txt(tio.read_bytes(path))
        np.testing.assert_array_equal(got, np.loadtxt(path).reshape(4, 4))
        np.testing.assert_array_equal(got, tio.read_pose_txt(path))
        np.testing.assert_array_equal(got, ref_disk.read_pose(path))


def test_undecodable_frame_is_skipped(folder, tmp_path):
    root, files, _ = folder
    broken = tmp_path / "captures"
    for sub in ("color", "depth", "poses"):
        (broken / sub).mkdir(parents=True)
    for f in files["chair_1"]:
        dst = broken / Path(f).parent.name / Path(f).name
        dst.write_bytes(Path(f).read_bytes())
    (broken / "color" / "chair_1_2.jpg").write_bytes(b"not a jpeg")
    batch = dataset(str(broken)).load_object("chair_1")
    assert batch.names == ["chair_1_1.jpg", "chair_1_3.jpg"]


def test_plain_reader_imports_neither_cv2_nor_the_port():
    tree = ast.parse((REPO / "benchmark/reference/disk.py").read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".", 1)[0] not in (
                "cv2", "otslam_tpu_torch", "otslam_tpu", "jax"), n
