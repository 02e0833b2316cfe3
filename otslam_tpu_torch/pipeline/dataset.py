"""Capture-dataset adapter (the scanner_node on-disk format).

Layout (scanner_node.cpp:268-299):
    <root>/color/<label>_<n>.jpg     RGB
    <root>/depth/<label>_<n>.png     uint16 millimeters
    <root>/poses/<label>_<n>.txt     4x4 map->camera-body matrix

Object grouping mirrors reconstruct_rgbd.py:39-58: the object name is the
filename minus its trailing frame number (``Object_0_3.jpg -> Object_0``).
Frames sort lexically like the reference's sorted(glob(...)).
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from otslam_tpu_torch.config import CameraConfig
from otslam_tpu_torch.core import io as tio
from otslam_tpu_torch.core.se3 import T_FIX_OPTICAL, pose_to_extrinsic


@dataclass
class FrameBatch:
    """Stacked frames of one object, device-upload ready."""

    depths: np.ndarray      # (N, H, W) f32 meters, 0 = invalid
    colors: np.ndarray      # (N, H, W, 3) f32 in [0, 255]
    extrinsics: np.ndarray  # (N, 4, 4) f32 world->optical camera
    poses: np.ndarray       # (N, 4, 4) f64 raw map->body poses
    names: list


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
        depths, colors, exts, poses, names = [], [], [], [], []
        for cf, df, pf in triplets:
            if not (os.path.exists(cf) and os.path.exists(df)
                    and os.path.exists(pf)):
                continue
            try:
                depth = tio.read_depth_png(df, self.camera.depth_scale)
                color = tio.read_color(cf).astype(np.float32)
                pose = tio.read_pose_txt(pf)
            except Exception:
                continue
            # fusion-time truncation (RGBD depth_trunc, reconstruct_rgbd.py:101)
            depth = np.where((depth > 0) & (depth <= self.camera.depth_trunc),
                             depth, 0.0).astype(np.float32)
            depths.append(depth)
            colors.append(color)
            exts.append(pose_to_extrinsic(pose, self.t_fix).astype(np.float32))
            poses.append(pose)
            names.append(os.path.basename(cf))
        if not depths:
            raise FileNotFoundError(f"no frames for object {obj_name!r} in {self.root}")
        return FrameBatch(np.stack(depths), np.stack(colors), np.stack(exts),
                          np.stack(poses), names)

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
