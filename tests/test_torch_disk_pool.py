"""`CaptureDataset.load_object`'s frame phases on its pool of host threads,
held byte for byte to a plain serial loop (`serial_load`, the loader as it
was before the pool: one frame after another, then `np.stack`) on tiny
seeded folders in the scanner's layout (benchmark/inputs/disk.py): every
object, explicit frame numbers, frames that fail to read, decode or parse,
frames of another size, the inline path on one core, concurrent callers,
and the spans and counters of a traced `reconstruct_object`.

This file imports neither jax nor otslam_tpu; on the card run it with

    python -m pytest --noconftest -q tests/test_torch_disk_pool.py
"""

import json
import os
import shutil
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.drivers.recon import program_config  # noqa: E402
from benchmark.inputs import disk  # noqa: E402
from otslam_tpu_torch.core import io as tio  # noqa: E402
from otslam_tpu_torch.core.se3 import pose_to_extrinsic  # noqa: E402
from otslam_tpu_torch.pipeline import dataset as dataset_mod  # noqa: E402
from otslam_tpu_torch.pipeline import reconstruct as rc  # noqa: E402
from otslam_tpu_torch.pipeline.dataset import (  # noqa: E402
    CaptureDataset, FrameBatch)
from otslam_tpu_torch.utils.profiling import recording  # noqa: E402

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
FRAMES = 5
LOAD = ("load.read", "load.decode", "load.convert")


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """The scanner's folder of three objects x FRAMES frames at 64 x 48,
    from a seed past 32 bits."""
    traffic = dict(TRAFFIC, objects=list(OBJECTS),
                   circle=dict(TRAFFIC["circle"], min_scan_points=FRAMES,
                               scan_point_interval=100.0))
    caps, _ = disk.scanner_captures(traffic, TINY["camera"], 2**33 + 29,
                                    "cpu")
    root = str(tmp_path_factory.mktemp("pool") / "captures")
    disk.write_folder(caps, root, TINY["camera"]["depth_scale"])
    return root


def dataset(root):
    return CaptureDataset(root, camera=program_config(TINY).camera)


def serial_load(ds, obj_name, frame_numbers=None):
    """The loader before its pool: each frame read, decoded, converted and
    parsed in turn, a failing frame skipped, then the rows stacked."""
    if frame_numbers is None:
        triplets = ds.frame_files(obj_name)
    else:
        triplets = [
            (os.path.join(ds.color_dir, f"{obj_name}_{i}.jpg"),
             os.path.join(ds.depth_dir, f"{obj_name}_{i}.png"),
             os.path.join(ds.pose_dir, f"{obj_name}_{i}.txt"))
            for i in frame_numbers]
    depths, colors, exts, poses, names = [], [], [], [], []
    for cf, df, pf in triplets:
        if not (os.path.exists(cf) and os.path.exists(df)
                and os.path.exists(pf)):
            continue
        try:
            cbytes, dbytes, pbytes = (tio.read_bytes(f) for f in (cf, df, pf))
            raw = tio.decode_depth_png(dbytes)
            rgb = tio.decode_color(cbytes)
            depth = raw.astype(np.float32) / ds.camera.depth_scale
            depth = np.where((depth > 0)
                             & (depth <= ds.camera.depth_trunc),
                             depth, 0.0).astype(np.float32)
            color = rgb.astype(np.float32)
            pose = tio.parse_pose_txt(pbytes)
            ext = pose_to_extrinsic(pose, ds.t_fix).astype(np.float32)
        except Exception:
            continue
        depths.append(depth)
        colors.append(color)
        exts.append(ext)
        poses.append(pose)
        names.append(os.path.basename(cf))
    if not depths:
        raise FileNotFoundError(obj_name)
    return FrameBatch(np.stack(depths), np.stack(colors), np.stack(exts),
                      np.stack(poses), names)


def assert_same(got, want):
    for field in ("depths", "colors", "extrinsics", "poses"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field
    assert got.names == want.names


def load_counted(ds, name, frame_numbers=None):
    with recording() as rec:
        batch = ds.load_object(name, frame_numbers)
    return batch, rec


def copy_object(root, name, dst):
    """A folder holding `name`'s files alone, to break one of them."""
    for sub in ("color", "depth", "poses"):
        (dst / sub).mkdir(parents=True)
        for f in Path(root, sub).glob(f"{name}_*"):
            shutil.copy(f, dst / sub / f.name)
    return dst


@pytest.mark.parametrize("name,frame_numbers", [
    *((n, None) for n in OBJECTS),
    ("chair_1", [4, 1, 9, 2]),       # out of order, and 9 is missing
    ("cone_blue", [3]),              # one frame: the inline path
])
def test_pooled_load_equals_the_serial_loop(folder, name, frame_numbers):
    ds = dataset(folder)
    batch, rec = load_counted(ds, name, frame_numbers)
    want = serial_load(ds, name, frame_numbers)
    assert_same(batch, want)
    counts = rec.counts()
    assert counts["load.frames"] == len(want.names)
    assert counts.get("load.pooled", 0) == (
        len(want.names) if len(want.names) > 1 else 0)
    assert [s[0] for s in rec.spans] == list(LOAD)   # one span a phase


BREAKS = {
    "jpg": ("color", "jpg", b"not a jpeg"),
    "png": ("depth", "png", b"\x89PNG\r\n\x1a\n truncated"),
    "pose": ("poses", "txt", b"1 2 3\n"),
    "read": ("depth", "png", None),        # a folder in the file's place
}


@pytest.mark.parametrize("broken", [("jpg",), ("png",), ("pose",),
                                    ("read",), ("jpg", "pose")])
def test_unusable_frames_are_skipped_as_the_serial_loop_skips(
        folder, tmp_path, broken):
    root = copy_object(folder, "chair_1", tmp_path / "captures")
    for frame, kind in zip((3, 2), broken):       # mid-object frames
        sub, ext, data = BREAKS[kind]
        path = root / sub / f"chair_1_{frame}.{ext}"
        if data is None:
            path.unlink()
            path.mkdir()
        else:
            path.write_bytes(data)
    ds = dataset(str(root))
    batch, rec = load_counted(ds, "chair_1")
    want = serial_load(ds, "chair_1")
    assert_same(batch, want)
    assert len(batch.names) == FRAMES - len(broken)
    assert "chair_1_3.jpg" not in batch.names
    assert rec.counts()["load.frames"] == rec.counts()["load.pooled"] \
        == FRAMES - len(broken)


@pytest.mark.parametrize("odd,pose_broken", [(3, False), (3, True),
                                             (1, True)])
def test_frames_of_another_size_stack_as_the_serial_loop(
        folder, tmp_path, odd, pose_broken):
    """A frame of another size fails the stacking, unless its pose fails
    and it is skipped (frame 1: the rows take the next frame's size)."""
    root = copy_object(folder, "cone_blue", tmp_path / "captures")
    small = cv2.imread(str(root / "depth" / f"cone_blue_{odd}.png"),
                       cv2.IMREAD_UNCHANGED)[:40, :56]
    cv2.imwrite(str(root / "depth" / f"cone_blue_{odd}.png"), small)
    rgb = cv2.imread(str(root / "color" / f"cone_blue_{odd}.jpg"))
    cv2.imwrite(str(root / "color" / f"cone_blue_{odd}.jpg"), rgb[:40, :56])
    if pose_broken:
        (root / "poses" / f"cone_blue_{odd}.txt").write_bytes(b"nan nan\n")
    ds = dataset(str(root))
    if not pose_broken:
        with pytest.raises(ValueError):
            serial_load(ds, "cone_blue")
        with pytest.raises(ValueError):
            ds.load_object("cone_blue")
        return
    batch = ds.load_object("cone_blue")
    assert_same(batch, serial_load(ds, "cone_blue"))
    assert batch.depths.shape == (FRAMES - 1, 48, 64)


@pytest.mark.parametrize("cores", [1, 2, 64])
def test_pool_width_follows_the_usable_cores(folder, monkeypatch, cores):
    """One usable core runs the phases on the calling thread (nothing
    pooled); more run them on the pool's threads, never the caller's."""
    monkeypatch.setattr(os, "sched_getaffinity",
                        lambda pid: set(range(cores)))
    threads = set()
    decode = tio.decode_color

    def watched(data):
        threads.add(threading.get_ident())
        return decode(data)

    monkeypatch.setattr(tio, "decode_color", watched)
    ds = dataset(folder)
    batch, rec = load_counted(ds, "cardboard_box")
    decoded_on = set(threads)
    assert_same(batch, serial_load(ds, "cardboard_box"))
    caller = threading.get_ident()
    if cores == 1:
        assert decoded_on == {caller}
        assert "load.pooled" not in rec.counts()
    else:
        assert caller not in decoded_on
        assert 1 <= len(decoded_on) <= min(cores, FRAMES)
        assert rec.counts()["load.pooled"] == rec.counts()["load.frames"] \
            == FRAMES
        assert dataset_mod._POOL[1] == cores


def test_pool_is_made_again_in_a_forked_child(monkeypatch):
    """A new process id (a forked child holds none of the parent's
    threads) or a new core count gets a new executor; else it is kept."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1, 2})
    pool = dataset_mod._frame_pool(4)
    assert dataset_mod._frame_pool(9) is pool
    assert dataset_mod._frame_pool(1) is None
    pid = os.getpid()
    monkeypatch.setattr(os, "getpid", lambda: pid + 1)
    child = dataset_mod._frame_pool(4)
    assert child is not pool and dataset_mod._POOL[:2] == (pid + 1, 3)
    assert list(child.map(abs, [-1, -2])) == [1, 2]


def test_concurrent_callers_each_get_the_serial_loops_arrays(folder,
                                                             monkeypatch):
    """Callers on several threads share the pool, which is wider than the
    cores, with the interpreter switching threads often: every batch
    still equals the serial loop's (a lost or crossed row write would
    not)."""
    monkeypatch.setattr(os, "sched_getaffinity",
                        lambda pid: set(range(2 * (os.cpu_count() or 1))))
    ds = dataset(folder)
    want = {n: serial_load(ds, n) for n in OBJECTS}
    got, errors = [], []

    def caller(k):
        try:
            for i in range(6):
                name = OBJECTS[(k + i) % len(OBJECTS)]
                got.append((name, ds.load_object(name)))
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=caller, args=(k,))
                   for k in range(4)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert errors == [] and len(got) == 24
    for name, batch in got:
        assert_same(batch, want[name])


def test_traced_spans_all_hang_from_the_calling_thread(folder):
    """Every span of a traced `reconstruct_object` has its parent in the
    tree (a worker opening one would have taken whatever span was open
    on another thread), the three phases once each under recon.load."""
    timings = {}
    draws = torch.rand(TINY["surface_samples"],
                       generator=torch.Generator().manual_seed(5))
    rc.reconstruct_object(dataset(folder), "chair_1", program_config(TINY),
                          TINY["backend"], output="cloud", auto_origin=True,
                          device="cpu", draws=draws, timings=timings)
    rec = timings["trace"]
    spans = {s[0]: s for s in rec["spans"]}
    for name, parent, t0, t1 in rec["spans"]:
        if name == "recon.object":
            assert parent is None
            continue
        assert parent in spans, name
        assert spans[parent][2] <= t0 <= t1 <= spans[parent][3], name
    names = [s[0] for s in rec["spans"]]
    for phase in LOAD:
        assert names.count(phase) == 1
        assert spans[phase][1] == "recon.load"
    assert rec["counts"]["load.pooled"] == rec["counts"]["load.frames"] \
        == FRAMES
