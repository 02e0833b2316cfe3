"""2D occupancy-grid mapping from LiDAR scans in log-odds (counterpart of
otslam_tpu/mapping/grid_mapper.py).

The reference delegates 2D map building to slam_toolbox (README.md:70,
external). This module builds the map natively for the known-pose case
(simulation ground truth or an external localizer): each scan's beams clear
free space up to the return and mark the hit cell, as log-odds updates on a
dense grid; the result exports to the PGM+YAML format the rest of the stack
consumes.

All beams x all ray steps of every scan are evaluated at once; the free and
hit cells of each scan are a boolean scatter into a (scans, cells + 1)
buffer whose last column is the dump slot for samples off the grid. Only
the clipped log-odds update runs scan by scan, in order: each scan's delta
is added and clipped to [L_MIN, L_MAX] before the next, as the JAX
package's ``lax.scan`` does (clipping once after summing every delta gives
another grid wherever a cell saturates).

Rounding. The JAX graph divides by the static resolution as a multiply by
its f32 reciprocal, and XLA:CPU contracts ``x0 + steps * cos`` into a fused
multiply-add. The port does both, through ``recip32`` and ``fma32``. Its
sin and cos are float64 values rounded to float32, the same on the CPU and
the card; XLA's own f32 sin/cos differ from them by one ulp at most, so
the packages can disagree only on a sample that one ulp of its sin or cos
moves across a cell edge (tests/test_torch_grid_mapper.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from otslam_tpu_torch.config import LidarConfig
from otslam_tpu_torch.core.grid import OccupancyGrid2D
from otslam_tpu_torch.device import resolve_device, to_f32
from otslam_tpu_torch.kernels.tsdf import fma32, recip32

L_FREE = -0.4     # log-odds decrement for traversed cells
L_OCC = 0.85      # log-odds increment for hit cells
L_MIN, L_MAX = -4.0, 4.0
OCC_THRESH = 0.7  # p(occupied) above this -> occupied
FREE_THRESH = 0.3


def _cell(v: torch.Tensor, origin: torch.Tensor,
          inv_res: float) -> torch.Tensor:
    """int32 cell index floor((v - origin) / resolution), the division
    taken as the JAX graph takes it: a multiply by the f32 reciprocal."""
    return torch.floor((v - origin) * inv_res).to(torch.int32)


def scan_masks(ranges: torch.Tensor, angles: torch.Tensor,
               poses: torch.Tensor, origin_x: float, origin_y: float,
               resolution: float, range_max: float, gh: int, gw: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(free, hit) (N, gh*gw) bool masks of N scans: ranges (N, B) f32,
    angles (B,) f32, poses (N, 3) f32 (x, y, yaw), all on one device. A
    cell is free in a scan if any beam traversed it short of the return
    and hit if any beam's return lies in it; the masks of all scans come
    from one batched pass."""
    dev = ranges.device
    n = ranges.shape[0]
    cells = gh * gw
    inv_res = recip32(resolution)
    ox = torch.tensor(origin_x, dtype=torch.float32, device=dev)
    oy = torch.tensor(origin_y, dtype=torch.float32, device=dev)
    x0, y0 = poses[:, 0, None], poses[:, 1, None]
    ga = poses[:, 2, None] + angles[None, :]                  # (N, B)
    # sin and cos correctly rounded to f32 (from f64), the same on every
    # device; XLA's f32 sin/cos are within one ulp of these values
    cos_a = torch.cos(ga.double()).to(torch.float32)
    sin_a = torch.sin(ga.double()).to(torch.float32)
    r = torch.nan_to_num(ranges, nan=0.0, posinf=0.0)
    has_hit = (r > 0) & (r <= range_max)
    # trace to the return (or range_max when there is none)
    trace_r = torch.where(has_hit, r, range_max)

    num_steps = int(range_max / resolution) + 1
    steps = (torch.arange(num_steps, dtype=torch.float32, device=dev)
             + 0.5) * resolution
    s = steps[None, None, :]
    gx = _cell(fma32(s, cos_a[..., None], x0[..., None]), ox, inv_res)
    gy = _cell(fma32(s, sin_a[..., None], y0[..., None]), oy, inv_res)
    inb = (gx >= 0) & (gx < gw) & (gy >= 0) & (gy < gh)
    free = inb & (s < (trace_r - resolution)[..., None])
    row = torch.arange(n, device=dev, dtype=torch.int64)[:, None, None]
    flat = torch.where(free, gy.to(torch.int64) * gw + gx, cells)
    free_mask = torch.zeros((n, cells + 1), dtype=torch.bool, device=dev)
    free_mask.view(-1)[(row * (cells + 1) + flat).reshape(-1)] = True

    hgx = _cell(fma32(trace_r, cos_a, x0), ox, inv_res)
    hgy = _cell(fma32(trace_r, sin_a, y0), oy, inv_res)
    hinb = has_hit & (hgx >= 0) & (hgx < gw) & (hgy >= 0) & (hgy < gh)
    hflat = torch.where(hinb, hgy.to(torch.int64) * gw + hgx, cells)
    hit_mask = torch.zeros((n, cells + 1), dtype=torch.bool, device=dev)
    hit_mask.view(-1)[(row[..., 0] * (cells + 1) + hflat).reshape(-1)] = True
    return free_mask[:, :cells], hit_mask[:, :cells]


def apply_scans(logodds: torch.Tensor, free: torch.Tensor,
                hit: torch.Tensor) -> torch.Tensor:
    """Add each scan's delta (L_OCC on its hit cells, L_FREE on its free
    cells that are not hit) and clip to [L_MIN, L_MAX], scan by scan in
    order. logodds (gh, gw) f32; free, hit (N, gh*gw) bool."""
    delta = (torch.where(hit, L_OCC, 0.0)
             + torch.where(free & ~hit, L_FREE, 0.0)).reshape(
                 -1, *logodds.shape)
    for d in delta:
        logodds = torch.clamp(logodds + d, L_MIN, L_MAX)
    return logodds


class GridMapper:
    """Accumulates scans with known poses into an occupancy grid held on
    `device`."""

    def __init__(self, extent=(-6.0, 6.0, -6.0, 6.0), resolution: float = 0.05,
                 lidar: LidarConfig | None = None, device="cuda"):
        self.lidar = lidar or LidarConfig()
        self.device = resolve_device(device)
        xmin, xmax, ymin, ymax = extent
        self.resolution = float(resolution)
        self.origin = (float(xmin), float(ymin))
        self.gw = int(np.ceil((xmax - xmin) / resolution))
        self.gh = int(np.ceil((ymax - ymin) / resolution))
        self.logodds = torch.zeros((self.gh, self.gw), dtype=torch.float32,
                                   device=self.device)

    def add_scan(self, ranges, angles, pose) -> None:
        """One scan: ranges (B,), angles (B,), pose (x, y, yaw)."""
        self.add_trajectory(to_f32(ranges, self.device)[None], angles,
                            to_f32(pose, self.device)[None])

    def add_trajectory(self, ranges_batch, angles, poses) -> None:
        """N scans stacked: ranges_batch (N, B), angles (B,), poses (N, 3);
        arrays or tensors."""
        free, hit = scan_masks(
            to_f32(ranges_batch, self.device), to_f32(angles, self.device),
            to_f32(poses, self.device), self.origin[0], self.origin[1],
            self.resolution, float(self.lidar.range_max), self.gh, self.gw)
        self.logodds = apply_scans(self.logodds, free, hit)

    def to_grid(self) -> OccupancyGrid2D:
        """The ROS occupancy grid (100 occupied, 0 free, -1 unknown) as an
        int8 tensor on the mapper's device."""
        p = 1.0 - 1.0 / (1.0 + torch.exp(self.logodds))
        data = torch.where(p > OCC_THRESH, 100,
                           torch.where(p < FREE_THRESH, 0, -1)).to(torch.int8)
        return OccupancyGrid2D(data, self.resolution, self.origin)

    def save(self, pgm_path: str, yaml_path: str) -> None:
        from otslam_tpu_torch.core import io as tio
        grid = self.to_grid()
        tio.write_pgm(pgm_path, grid.to_pgm())
        tio.write_map_yaml(yaml_path, os.path.basename(pgm_path),
                           self.resolution,
                           (self.origin[0], self.origin[1], 0.0))
