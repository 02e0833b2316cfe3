"""Capture-dataset adapter (the scanner_node on-disk format).

Layout (scanner_node.cpp:268-299):
    <root>/color/<label>_<n>.jpg     RGB
    <root>/depth/<label>_<n>.png     uint16 millimeters
    <root>/poses/<label>_<n>.txt     4x4 map->camera-body matrix

Object grouping mirrors reconstruct_rgbd.py:39-58: the object name is the
filename minus its trailing frame number (``Object_0_3.jpg -> Object_0``).
Frames sort lexically like the reference's sorted(glob(...)).

`load_object` lists an object's frames on the calling thread, then runs
three phases over them, each one `map` over the frames and one span of
the open recorder (utils/profiling.py):

    load.read       each frame's colour, depth and pose files, read whole
    load.decode     its JPG's and PNG's decodes (cv2.imdecode)
    load.convert    its float32 planes, with the depth truncation, written
                    into the object's stacked arrays; its pose and extrinsic

The frames are independent, and the decodes and NumPy's casts release
the interpreter lock, so the phases run on a pool of host threads, one
executor a process (made again in a forked child), as wide as the
usable cores or the frames; with one of either they run inline on the
calling thread. Workers open no spans and touch no counters: the calling
thread counts the frames loaded (``load.frames``), those loaded on the
pool (``load.pooled``) and the bytes of their files (``load.bytes``).
`reconstruct_object` holds the call in its ``recon.load`` stage.
"""

from __future__ import annotations

import glob
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from otslam_tpu_torch.config import CameraConfig
from otslam_tpu_torch.core import io as tio
from otslam_tpu_torch.core.se3 import T_FIX_OPTICAL, pose_to_extrinsic
from otslam_tpu_torch.utils.profiling import count, span


@dataclass
class FrameBatch:
    """Stacked frames of one object, device-upload ready."""

    depths: np.ndarray      # (N, H, W) f32 meters, 0 = invalid
    colors: np.ndarray      # (N, H, W, 3) f32 in [0, 255]
    extrinsics: np.ndarray  # (N, 4, 4) f32 world->optical camera
    poses: np.ndarray       # (N, 4, 4) f64 raw map->body poses
    names: list


_POOL = None    # (pid, cores, ThreadPoolExecutor) of load_object's phases
_POOL_LOCK = threading.Lock()


def _frame_pool(frames: int) -> ThreadPoolExecutor | None:
    """The process's executor for `frames` frames, as wide as its usable
    cores (its threads start as tasks arrive, so a phase runs on at most
    min(frames, cores)); None where one frame or one core leaves nothing
    to share. Made again after a fork, whose child has none of the
    parent's threads, or when the usable cores change; the one it
    replaces is dropped, not shut down, so a call still mapping on it
    finishes (its idle threads end once it is collected)."""
    global _POOL
    cores = len(os.sched_getaffinity(0))
    if min(frames, cores) <= 1:
        return None
    key = (os.getpid(), cores)
    with _POOL_LOCK:
        if _POOL is None or _POOL[:2] != key:
            _POOL = (*key, ThreadPoolExecutor(
                cores, thread_name_prefix="load_object"))
        return _POOL[2]


def _guarded(fn):
    """`fn` of one frame, None where the frame is gone (None) or `fn`
    raises: a frame skipped like the reference's per-frame guards."""
    def call(x):
        if x is None:
            return None
        try:
            return fn(x)
        except Exception:
            return None
    return call


def _read_frame(files: tuple) -> tuple:
    return tuple(tio.read_bytes(f) for f in files)


def _decode_frame(blobs: tuple) -> tuple:
    return tio.decode_depth_png(blobs[1]), tio.decode_color(blobs[0])


def get_unique_object_names(color_dir: str) -> list:
    names = set()
    for f in glob.glob(os.path.join(color_dir, "*.jpg")):
        parts = os.path.basename(f).split("_")
        if len(parts) >= 2:
            names.add("_".join(parts[:-1]))
    return sorted(names)


class CaptureDataset:
    """Reader/writer for a capture dataset directory."""

    def __init__(self, root: str, camera: CameraConfig | None = None,
                 t_fix: np.ndarray = T_FIX_OPTICAL):
        self.root = root
        self.camera = camera or CameraConfig()
        self.t_fix = t_fix
        self.color_dir = os.path.join(root, "color")
        self.depth_dir = os.path.join(root, "depth")
        self.pose_dir = os.path.join(root, "poses")
        self._counters: dict = {}

    # ---- reading -----------------------------------------------------------

    def object_names(self) -> list:
        return get_unique_object_names(self.color_dir)

    def frame_files(self, obj_name: str) -> list[tuple[str, str, str]]:
        colors = sorted(glob.glob(os.path.join(self.color_dir, f"{obj_name}_*.jpg")))
        depths = sorted(glob.glob(os.path.join(self.depth_dir, f"{obj_name}_*.png")))
        poses = sorted(glob.glob(os.path.join(self.pose_dir, f"{obj_name}_*.txt")))
        return list(zip(colors, depths, poses))

    def load_object(self, obj_name: str,
                    frame_numbers: Sequence[int] | None = None) -> FrameBatch:
        """Load all frames of an object (or explicit frame numbers, mirroring
        multi_reconstruct_rgbd_filter.py's OBJECT_RANGES mode). Missing or
        unreadable frames are skipped like the reference's per-frame guards."""
        if frame_numbers is None:
            triplets = self.frame_files(obj_name)
        else:
            triplets = [
                (os.path.join(self.color_dir, f"{obj_name}_{i}.jpg"),
                 os.path.join(self.depth_dir, f"{obj_name}_{i}.png"),
                 os.path.join(self.pose_dir, f"{obj_name}_{i}.txt"))
                for i in frame_numbers]
        frames = [t for t in triplets if all(map(os.path.exists, t))]
        pool = _frame_pool(len(frames))
        run = map if pool is None else pool.map
        with span("load.read"):
            blobs = list(run(_guarded(_read_frame), frames))
        count("load.bytes", sum(len(b) for bs in blobs if bs for b in bs))
        with span("load.decode"):
            images = list(run(_guarded(_decode_frame), blobs))
        with span("load.convert"):
            kept, planes = self._convert(images, blobs, run)
        count("load.frames", len(kept))
        count("load.pooled", 0 if pool is None else len(kept))
        if not kept:
            raise FileNotFoundError(f"no frames for object {obj_name!r} in {self.root}")
        return FrameBatch(*planes, [os.path.basename(frames[i][0])
                                    for i in kept])

    def _convert(self, images: list, blobs: list, run) -> tuple:
        """(the kept frames' indices, their stacked depths, colours,
        extrinsics and poses): `run` parses the decoded frames' poses, then
        writes each kept frame's float planes into its row. A frame whose
        pose fails is not kept; kept frames of another size fail as
        `np.stack` fails."""
        posed = list(run(_guarded(self._pose), [
            None if im is None else b for im, b in zip(images, blobs)]))
        kept = [i for i, p in enumerate(posed) if p is not None]
        if not kept:
            return [], None
        raw, rgb = images[kept[0]]
        if any(images[i][0].shape != raw.shape
               or images[i][1].shape != rgb.shape for i in kept):
            raise ValueError("all input arrays must have the same shape")
        depths = np.empty((len(kept), *raw.shape), np.float32)
        colors = np.empty((len(kept), *rgb.shape), np.float32)
        list(run(lambda r: self._planes(*images[kept[r]], depths[r],
                                        colors[r]), range(len(kept))))
        return kept, (depths, colors, np.stack([posed[i][1] for i in kept]),
                      np.stack([posed[i][0] for i in kept]))

    def _pose(self, blobs: tuple) -> tuple:
        """A frame's map->body pose and its world->optical extrinsic."""
        pose = tio.parse_pose_txt(blobs[2])
        return pose, pose_to_extrinsic(pose, self.t_fix).astype(np.float32)

    def _planes(self, raw: np.ndarray, rgb: np.ndarray, depth: np.ndarray,
                color: np.ndarray) -> None:
        """One frame's float32 depth in meters, 0 outside (0, depth_trunc]
        (the fusion-time truncation, RGBD depth_trunc,
        reconstruct_rgbd.py:101), and float32 colour, into `depth` and
        `color`."""
        np.divide(raw.astype(np.float32), self.camera.depth_scale,
                  out=depth)
        depth[~((depth > 0) & (depth <= self.camera.depth_trunc))] = 0.0
        color[...] = rgb

    def iter_objects(self) -> Iterator[tuple[str, FrameBatch]]:
        for name in self.object_names():
            yield name, self.load_object(name)

    # ---- writing (scanner-node side) --------------------------------------

    def save_frame(self, label: str, color_rgb: np.ndarray,
                   depth_m: np.ndarray, pose: np.ndarray) -> int:
        """Append one capture; returns its 1-based frame number. Applies the
        scanner's save-time depth clipping (NaN -> 0, > depth_max -> 0).
        Numbering resumes after existing files (datasets append across
        processes)."""
        if label not in self._counters:
            existing = [
                int(os.path.basename(f)[len(label) + 1:-4])
                for f in glob.glob(
                    os.path.join(self.color_dir, f"{label}_*.jpg"))
                if os.path.basename(f)[len(label) + 1:-4].isdigit()]
            self._counters[label] = max(existing, default=0)
        self._counters[label] += 1
        n = self._counters[label]
        tio.write_color(os.path.join(self.color_dir, f"{label}_{n}.jpg"),
                        color_rgb)
        tio.write_depth_png(os.path.join(self.depth_dir, f"{label}_{n}.png"),
                            depth_m, self.camera.depth_scale,
                            self.camera.depth_max)
        tio.write_pose_txt(os.path.join(self.pose_dir, f"{label}_{n}.txt"),
                           pose)
        return n
