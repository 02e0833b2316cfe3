"""Object filters (counterpart of otslam_tpu/mapping/object_filter.py).

WallProximityFilter is the object_filter node (object_filter.cpp:40-160):
the virtual scan converts to map-frame wall points; any candidate object
point within ``proximity_threshold`` (default 0.5 m) of a wall point is
dropped. The C++ brute-force O(N*M) scan becomes the nearest-neighbour
search (kernel K3 on the card). StaticWallFilter gates the removed-evidence
stream on the host in numpy: the JAX package's scipy.ndimage calls (label,
find_objects, binary_dilation) become a breadth-first search over the
occupied cells and shifted ORs, with the same mask.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from otslam_tpu_torch.device import resolve_device
from otslam_tpu_torch.kernels.nn import nn_distance


class WallProximityFilter:
    def __init__(self, proximity_threshold: float = 0.5, device="cuda"):
        self.proximity_threshold = proximity_threshold
        self.device = resolve_device(device)
        self._walls: torch.Tensor | None = None   # (M, 3) map frame, z = 0

    def on_virtual_scan(self, ranges, angles, robot_pose) -> None:
        """Cache the latest wall points (finite virtual returns, map frame)."""
        r = (ranges.cpu().numpy() if isinstance(ranges, torch.Tensor)
             else np.asarray(ranges))
        a = (angles.cpu().numpy() if isinstance(angles, torch.Tensor)
             else np.asarray(angles))
        ok = np.isfinite(r)
        if not ok.any():
            self._walls = None
            return
        x0, y0, yaw = robot_pose
        lx = r[ok] * np.cos(a[ok])
        ly = r[ok] * np.sin(a[ok])
        c, s = np.cos(yaw), np.sin(yaw)
        wx = x0 + lx * c - ly * s
        wy = y0 + lx * s + ly * c
        walls = np.stack([wx, wy, np.zeros_like(wx)], -1).astype(np.float32)
        self._walls = torch.as_tensor(walls, device=self.device)

    def filter(self, object_points: np.ndarray) -> np.ndarray:
        """Drop object points near walls. No wall data yet -> empty output
        (the node returns without publishing, object_filter.cpp:93)."""
        pts = np.asarray(object_points, np.float32).reshape(-1, 2)
        if self._walls is None:
            return pts[:0]
        if len(pts) == 0:
            return pts
        src = torch.as_tensor(np.concatenate(
            [pts, np.zeros((len(pts), 1), np.float32)], -1),
            device=self.device)
        d = nn_distance(src, self._walls).cpu().numpy()
        return pts[d >= self.proximity_threshold]


class StaticWallFilter:
    """Map-structure gate for the REMOVED-evidence stream.

    A removed-object candidate is, by definition, a map-occupied region the
    live scan no longer confirms — so it cannot be distance-gated against
    all occupied cells (that would erase true removals). But residual pose
    error during long transits makes WALL cells flicker as "removed"
    (corner smears pass the selector's bbox thin test, which is the only
    gate the reference has: 3_multi_object_goal_selector.cpp:205-212). The
    distinction is structure: walls belong to LARGE connected components of
    the saved map, removable objects to small ones. This filter labels the
    map's occupied components once, keeps components whose bbox extent
    exceeds ``wall_extent_m`` as walls, dilates them by ``margin_m``, and
    drops evidence points inside the dilated wall mask. Host-side and
    O(1) per point (one precomputed boolean grid lookup).
    """

    def __init__(self, grid, wall_extent_m: float = 2.0,
                 margin_m: float = 0.3):
        data = grid._host_data()
        res = float(grid.resolution)
        occ = data == 100
        wall = np.zeros_like(occ)
        for rows, cols in _components(occ):
            h = (rows.max() - rows.min() + 1) * res
            w = (cols.max() - cols.min() + 1) * res
            if max(h, w) >= wall_extent_m:
                # only this component's cells — the wall RING's bbox spans
                # the whole map and would otherwise swallow every object
                wall[rows, cols] = True
        it = max(1, int(np.ceil(margin_m / res)))
        self._mask = _dilate_cross(wall, it)
        self._res = res
        self._ox = float(grid.origin[0])
        self._oy = float(grid.origin[1])

    def filter(self, points: np.ndarray) -> np.ndarray:
        """Drop map-frame (N, 2) points that fall inside dilated wall
        structure; points outside the grid pass through unchanged."""
        pts = np.asarray(points, np.float32).reshape(-1, 2)
        if len(pts) == 0:
            return pts
        j = np.floor((pts[:, 0] - self._ox) / self._res).astype(int)
        i = np.floor((pts[:, 1] - self._oy) / self._res).astype(int)
        h, w = self._mask.shape
        inside = (i >= 0) & (i < h) & (j >= 0) & (j < w)
        hit = np.zeros(len(pts), bool)
        hit[inside] = self._mask[i[inside], j[inside]]
        return pts[~hit]


def _components(occ: np.ndarray):
    """The 4-connected components of a boolean grid (scipy.ndimage.label's
    default cross structure), each as (rows, cols) index arrays, found by a
    breadth-first search from each unvisited occupied cell in raster
    order."""
    h, w = occ.shape
    seen = np.zeros_like(occ)
    out = []
    for r0, c0 in zip(*np.nonzero(occ)):
        if seen[r0, c0]:
            continue
        seen[r0, c0] = True
        queue, cells = deque([(r0, c0)]), []
        while queue:
            r, c = queue.popleft()
            cells.append((r, c))
            for rr, cc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
                if 0 <= rr < h and 0 <= cc < w and occ[rr, cc] \
                        and not seen[rr, cc]:
                    seen[rr, cc] = True
                    queue.append((rr, cc))
        rows, cols = np.asarray(cells).T
        out.append((rows, cols))
    return out


def _dilate_cross(mask: np.ndarray, iterations: int) -> np.ndarray:
    """scipy.ndimage.binary_dilation(mask, iterations=iterations) with its
    default cross structure and border_value=0: each pass ORs the mask with
    its four one-cell shifts, cells outside the grid counting as False."""
    out = mask.copy()
    for _ in range(iterations):
        prev = out.copy()
        out[1:] |= prev[:-1]
        out[:-1] |= prev[1:]
        out[:, 1:] |= prev[:, :-1]
        out[:, :-1] |= prev[:, 1:]
    return out
