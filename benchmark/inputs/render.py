"""The analytic RGB-D camera and planar LiDAR, frozen for the benchmark.

A copy of the port's `sim/sensors.py` renderers (exact ray-primitive
intersections in torch on a given device), so that a later change to the
port's simulator cannot move the benchmark's inputs or the reference's
real scans. Depth is the optical-frame z (0 = no return), colour is
[0, 255] f32; LiDAR ranges are f32 with +inf for no return.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.inputs.scene import Box, Cone, Scene

_INF = 1e10
_FLOOR_COLOR = (0.9, 0.9, 0.9)


def pixel_rays(width, height, fx, fy, cx, cy, device) -> torch.Tensor:
    """(H, W, 3) camera-frame rays with unit z (pixel centres at integers)."""
    u = np.arange(width, dtype=np.float32)
    v = np.arange(height, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)
    x = (uu - cx) / fx
    y = (vv - cy) / fy
    return torch.as_tensor(np.stack([x, y, np.ones_like(x)], axis=-1),
                           device=device)


def _safe(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(x) > 1e-12, x, 1e-12)


def _to_box(v, c: float, s: float):
    """(..., 3) world vectors into a box's frame, R = [[c, s, 0], [-s, c, 0],
    [0, 0, 1]] written out elementwise: each row's arithmetic is then the
    same whatever the batch shape (a matmul may pick another summation
    order for another row count)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([x * c + y * s, x * (-s) + y * c, z], dim=-1)


def _ray_box(o, d, box: Box):
    c, s = float(np.cos(box.yaw)), float(np.sin(box.yaw))
    ol = _to_box(o - torch.tensor(box.center, dtype=o.dtype,
                                  device=o.device), c, s)
    dl = _to_box(d, c, s)
    half = torch.tensor(box.size, dtype=o.dtype, device=o.device) / 2.0
    dsafe = _safe(dl)
    t1 = (-half - ol) / dsafe
    t2 = (half - ol) / dsafe
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = torch.where(tmin > 0, tmin, tmax)  # inside the box -> exit face
    return torch.where(hit, t, _INF)


def _ray_cone(o, d, cone: Cone):
    """Finite cone, apex at base + height, opening downward to base circle."""
    cx, cy, cz = cone.center
    h = cone.height
    r = cone.radius
    k = r / h
    k2 = k * k
    ox = o[..., 0] - cx
    oy = o[..., 1] - cy
    oz = o[..., 2] - (cz + h)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    a = dx * dx + dy * dy - k2 * dz * dz
    b = 2.0 * (ox * dx + oy * dy - k2 * oz * dz)
    cq = ox * ox + oy * oy - k2 * oz * oz
    disc = b * b - 4 * a * cq
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    asafe = _safe(a)
    t1 = (-b - sq) / (2 * asafe)
    t2 = (-b + sq) / (2 * asafe)

    def ok(t):
        z = o[..., 2] + t * d[..., 2]
        return (disc >= 0) & (t > 0) & (z >= cz) & (z <= cz + h)

    t_lat = torch.where(ok(t1), t1, torch.where(ok(t2), t2, _INF))
    t = (cz - o[..., 2]) / _safe(dz)
    x = o[..., 0] + t * d[..., 0] - cx
    y = o[..., 1] + t * d[..., 1] - cy
    okb = (t > 0) & (x * x + y * y <= r * r)
    return torch.minimum(t_lat, torch.where(okb, t, _INF))


def _ray_solid(o, d, solid):
    if isinstance(solid, Box):
        return _ray_box(o, d, solid)
    if isinstance(solid, Cone):
        return _ray_cone(o, d, solid)
    raise TypeError(type(solid))


def render_rgbd(scene: Scene, cam_pose_world: np.ndarray, rays: torch.Tensor,
                near: float = 0.05, far: float = 10.0):
    """Depth (H, W) f32 metres and colour (H, W, 3) f32 in [0, 255] on the
    rays' device from an optical-frame camera->world pose."""
    dev = rays.device
    solids = scene.all_solids()
    pose = torch.as_tensor(np.asarray(cam_pose_world, np.float32), device=dev)
    R = pose[:3, :3]
    t = pose[:3, 3]
    dirs = rays @ R.T
    o = torch.broadcast_to(t, dirs.shape)
    ts = [_ray_solid(o, dirs, s) for s in solids]
    colors = [s.color for s in solids]
    if scene.floor:
        t_floor = (0.0 - t[2]) / _safe(dirs[..., 2])
        ts.append(torch.where(t_floor > 0, t_floor, _INF))
        colors.append(_FLOOR_COLOR)
    ts = torch.stack(ts)
    tmin, best = torch.min(ts, dim=0)
    depth = torch.where((tmin > near) & (tmin < far), tmin, 0.0)
    palette = torch.tensor(colors, dtype=torch.float32, device=dev) * 255.0
    color = torch.where((depth > 0)[..., None], palette[best], 0.0)
    return depth, color


def render_lidar_path(scene: Scene, poses: np.ndarray, angles: torch.Tensor,
                      range_min: float, range_max: float,
                      sensor_z: float = 0.17,
                      dtype=torch.float32) -> torch.Tensor:
    """(K, B) planar scans at height sensor_z from (K, 3) poses (x, y, yaw);
    angles (B,) f32 in the robot frame, on the scans' device; computed in
    `dtype`, returned as f32."""
    dev = angles.device

    def col(k):
        return torch.as_tensor(np.asarray(poses[:, k], np.float32),
                               device=dev)[:, None].to(dtype)
    x, y, yaw = col(0), col(1), col(2)
    ga = angles.to(dtype) + yaw
    dirs = torch.stack([torch.cos(ga), torch.sin(ga), torch.zeros_like(ga)],
                       dim=-1)
    o = torch.stack([x.expand_as(ga), y.expand_as(ga),
                     torch.full_like(ga, sensor_z)], dim=-1)
    ts = torch.stack([_ray_solid(o, dirs, s) for s in scene.all_solids()])
    tmin = ts.amin(dim=0)
    return torch.where((tmin >= range_min) & (tmin <= range_max), tmin,
                       torch.inf).float()
