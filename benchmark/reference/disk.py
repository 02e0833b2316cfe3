"""The plain reader of the on-disk cell: the scanner's capture folder read
as the reference's offline script reads it (3d_model/reconstruct_rgbd.py:
39-58 groups the files by object, 79-118 reads and fuses each), for
reference/recon.py to fuse.

NumPy and PIL alone: it imports neither OpenCV nor anything of the
program. An object is a colour file's name less its trailing "_<n>"; its
frames zip the sorted colour, depth and pose files of its name. Depth is
the PNG's uint16 / depth_scale in float32, 0 past depth_trunc; colour is
the JPEG's RGB as float32; a pose file's 16 numbers are parsed by hand
into the map -> body matrix, whose world -> optical extrinsic is
inv(pose @ T_FIX_OPTICAL) (reconstruct_rgbd.py:93-96), taken as the rigid
inverse [R^T | -R^T t] in float64 and cast to float32.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from benchmark.inputs.captures import T_FIX_OPTICAL, Capture


def object_names(root: str) -> list:
    """The objects of a folder: each colour file's name less "_<n>"."""
    names = set()
    for f in glob.glob(os.path.join(root, "color", "*.jpg")):
        parts = os.path.basename(f).split("_")
        if len(parts) >= 2:
            names.add("_".join(parts[:-1]))
    return sorted(names)


def frame_files(root: str, label: str) -> list:
    """[(colour, depth, pose) paths] of an object, zipped in sorted order."""
    def listed(sub, ext):
        return sorted(glob.glob(os.path.join(root, sub, f"{label}_*{ext}")))
    return list(zip(listed("color", ".jpg"), listed("depth", ".png"),
                    listed("poses", ".txt")))


def read_depth(path: str, depth_scale: float, depth_trunc: float):
    from PIL import Image
    with Image.open(path) as im:
        raw = np.asarray(im)
    if raw.dtype != np.uint16:
        raise ValueError(f"{path}: not a uint16 PNG ({raw.dtype})")
    d = raw.astype(np.float32) / depth_scale
    return np.where((d > 0) & (d <= depth_trunc), d, 0.0).astype(np.float32)


def read_color(path: str):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB")).astype(np.float32)


def read_pose(path: str) -> np.ndarray:
    """The 4x4 matrix of a pose file: 16 numbers, whitespace apart."""
    with open(path) as f:
        vals = [float(tok) for tok in f.read().split()]
    if len(vals) != 16:
        raise ValueError(f"{path}: {len(vals)} numbers, not 16")
    return np.array(vals, np.float64).reshape(4, 4)


def extrinsic(pose: np.ndarray, dtype=np.float64) -> np.ndarray:
    """world -> optical of a map -> body pose, computed in `dtype` (the
    control's bfloat16 is torch's) and returned as float32."""
    if dtype is not np.float64:
        import torch
        T = (torch.as_tensor(pose, dtype=dtype)
             @ torch.as_tensor(T_FIX_OPTICAL, dtype=dtype))
        out = torch.eye(4, dtype=dtype)
        out[:3, :3] = T[:3, :3].T
        out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
        return out.float().numpy()
    T = np.asarray(pose, np.float64) @ T_FIX_OPTICAL
    R, t = T[:3, :3], T[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out.astype(np.float32)


def read_object(root: str, label: str, camera: dict) -> Capture:
    """One object's frames from the capture folder `root`."""
    depths, colors, exts, poses = [], [], [], []
    for cf, df, pf in frame_files(root, label):
        depths.append(read_depth(df, camera["depth_scale"],
                                 camera["depth_trunc"]))
        colors.append(read_color(cf))
        poses.append(read_pose(pf))
        exts.append(extrinsic(poses[-1]))
    if not depths:
        raise FileNotFoundError(f"no frames of {label!r} in {root}")
    return Capture(label, np.stack(depths), np.stack(colors), np.stack(exts),
                   np.stack(poses))
