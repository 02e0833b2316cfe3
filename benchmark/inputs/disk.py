"""The on-disk cell's inputs: the recon cells' captures written once, with
OpenCV, as the scanner writes them (scanner_node.cpp:268-299):

    <root>/color/<label>_<n>.jpg     8-bit colour, cv2.imwrite's JPEG
                                     (its default quality, 95)
    <root>/depth/<label>_<n>.png     uint16 millimetres, cv2.imwrite's PNG
                                     (its default compression)
    <root>/poses/<label>_<n>.txt     the 4x4 map -> body pose, "%.6f"

Frames number from 1. The captures are inputs/captures.py's from the same
seed (the same start angles and rounds), rendered with the depth kept out
to the camera's depth_max, as the scanner keeps it (anything farther is
0); a reader that truncates at depth_trunc gets the recon cells' frames
back. Nothing of the program is imported.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.inputs.captures import make_captures


def scanner_captures(traffic: dict, camera: dict, seed: int, device):
    """make_captures' captures and rounds from `seed`, the depth planes
    cut at depth_max (the scanner's clip) instead of depth_trunc."""
    return make_captures(traffic, dict(camera,
                                       depth_trunc=camera["depth_max"]),
                         seed, device)


def write_frame(root: str, stem: str, color: np.ndarray, depth: np.ndarray,
                pose: np.ndarray, depth_scale: float) -> None:
    """One capture under `stem` (<label>_<n>): colour (H, W, 3) RGB with
    integer values in [0, 255], depth (H, W) metres, its map -> body pose."""
    import cv2
    bgr = np.ascontiguousarray(np.asarray(color).astype(np.uint8)[..., ::-1])
    mm = np.round(np.asarray(depth, np.float64) * depth_scale).astype(
        np.uint16)
    if not (cv2.imwrite(os.path.join(root, "color", f"{stem}.jpg"), bgr)
            and cv2.imwrite(os.path.join(root, "depth", f"{stem}.png"), mm)):
        raise OSError(f"cv2 could not write {stem} under {root}")
    np.savetxt(os.path.join(root, "poses", f"{stem}.txt"),
               np.asarray(pose, np.float64).reshape(4, 4), fmt="%.6f")


def write_folder(caps: dict, root: str, depth_scale: float) -> dict:
    """Every capture of `caps` ({label: Capture}) into the capture folder
    `root`; returns {label: the paths of its files}."""
    for sub in ("color", "depth", "poses"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    files = {}
    for label, cap in caps.items():
        files[label] = []
        for i in range(len(cap.depths)):
            stem = f"{label}_{i + 1}"
            write_frame(root, stem, cap.colors[i], cap.depths[i],
                        cap.poses[i], depth_scale)
            files[label] += [os.path.join(root, sub, stem + ext) for sub, ext
                             in (("color", ".jpg"), ("depth", ".png"),
                                 ("poses", ".txt"))]
    return files
