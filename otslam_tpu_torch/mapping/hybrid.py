"""Hybrid 2D + 3D map assembly.

Equivalent of fusion/hybrid_map.py: occupied pixels of the 2D PGM map become
a dark-gray z=0 wall point cloud using the reference's exact pixel math
(wx = ox + c*res, wy = oy + (h-1-r)*res: hybrid_map.py:50-55); every
per-object PLY is painted red and concatenated; the combined cloud is saved
as one PLY. A manual per-object alignment hook replaces the interactive
W/S/A/D/Z/C aligner of hybrid_map_manual.py.
"""

from __future__ import annotations

import glob
import os
from typing import Mapping, Sequence

import numpy as np

from otslam_tpu_torch.config import MapConfig
from otslam_tpu_torch.core import io as tio
from otslam_tpu_torch.core.grid import OccupancyGrid2D

MAP_COLOR = (0.2, 0.2, 0.2)   # dark gray walls (hybrid_map.py:59)
OBJ_COLOR = (1.0, 0.0, 0.0)   # red objects (hybrid_map.py:88)


def map_to_cloud(grid: OccupancyGrid2D) -> tuple[np.ndarray, np.ndarray]:
    """Occupied cells -> (N,3) wall points at z=0 + (N,3) gray colors."""
    xy = grid.occupied_world_points()
    pts = np.concatenate([xy, np.zeros((len(xy), 1))], axis=-1).astype(np.float32)
    cols = np.tile(np.asarray(MAP_COLOR, np.float32), (len(pts), 1))
    return pts, cols


def load_object_clouds(obj_dir: str) -> list[tuple[str, np.ndarray, np.ndarray]]:
    """All .ply object models in a directory, painted red, sorted by name."""
    out = []
    for f in sorted(glob.glob(os.path.join(obj_dir, "*.ply"))):
        data = tio.read_ply(f)
        pts = data["points"]
        cols = np.tile(np.asarray(OBJ_COLOR, np.float32), (len(pts), 1))
        out.append((os.path.basename(f), pts, cols))
    return out


def _apply_align(pts: np.ndarray, dx: float, dy: float, yaw_deg: float) -> np.ndarray:
    """Manual alignment: translate + yaw about the object's center
    (hybrid_map_manual.py:92-119 semantics)."""
    c = pts.mean(axis=0)
    th = np.radians(yaw_deg)
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0],
                  [0, 0, 1.0]])
    return (pts - c) @ R.T + c + np.array([dx, dy, 0.0])


def build_hybrid_map(grid: OccupancyGrid2D, obj_dir: str,
                     alignments: Mapping[str, Sequence[float]] | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """2D map + object models -> one combined colored point cloud.

    alignments: optional per-object-file (dx, dy, yaw_degrees) manual offsets.
    Returns (points (N,3), colors (N,3) float [0,1]).
    """
    map_pts, map_cols = map_to_cloud(grid)
    all_pts = [map_pts]
    all_cols = [map_cols]
    for name, pts, cols in load_object_clouds(obj_dir):
        if alignments and name in alignments:
            dx, dy, yaw = alignments[name]
            pts = _apply_align(pts, dx, dy, yaw)
        all_pts.append(pts)
        all_cols.append(cols)
    return (np.concatenate(all_pts).astype(np.float32),
            np.concatenate(all_cols).astype(np.float32))


def save_hybrid_map(path: str, grid: OccupancyGrid2D, obj_dir: str,
                    alignments: Mapping[str, Sequence[float]] | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    pts, cols = build_hybrid_map(grid, obj_dir, alignments)
    tio.write_ply(path, pts, colors=cols)
    return pts, cols


def hybrid_map_from_files(yaml_path: str, pgm_path: str, obj_dir: str,
                          save_path: str, cfg: MapConfig | None = None):
    """File-level entry point mirroring hybrid_map.py main()."""
    cfg = cfg or MapConfig()
    meta = tio.read_map_yaml(yaml_path)
    img = tio.read_pgm(pgm_path)
    grid = OccupancyGrid2D.from_pgm(
        img, meta["resolution"], tuple(meta["origin"][:2]),
        occupied_threshold=cfg.occupied_threshold,
        unknown_value=cfg.unknown_value, unknown_band=cfg.unknown_band)
    return save_hybrid_map(save_path, grid, obj_dir)
