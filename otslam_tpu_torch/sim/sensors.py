"""Analytic RGB-D camera and planar LiDAR (counterpart of
otslam_tpu/sim/sensors.py).

Exact ray-primitive intersections, vectorized over pixels x primitives in
torch on a given device. Depth is the z coordinate in the optical frame
(pinhole rays have unit z, so depth = ray parameter t); 0 = no return.
"""

from __future__ import annotations

import numpy as np
import torch

from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.core.se3 import se3
from otslam_tpu_torch.device import resolve_device
from otslam_tpu_torch.sim.world import Box, Cone, Cylinder, Scene

_INF = 1e10
_FLOOR_COLOR = (0.9, 0.9, 0.9)


def look_at_pose(eye, target, up=(0.0, 0.0, -1.0)) -> np.ndarray:
    """Camera->world pose (optical convention: +z forward, +y down) looking
    from eye to target."""
    eye = np.asarray(eye, float)
    fwd = np.asarray(target, float) - eye
    fwd = fwd / np.linalg.norm(fwd)
    upv = np.asarray(up, float)
    right = np.cross(upv, fwd)
    nr = np.linalg.norm(right)
    if nr < 1e-9:
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        nr = np.linalg.norm(right)
    right /= nr
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)
    return se3(R, eye)


# ---------------------------------------------------------------------------
# ray-primitive intersections (origins (..., 3), dirs (..., 3) -> t or _INF)
# ---------------------------------------------------------------------------

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


def _ray_cylinder(o, d, cyl: Cylinder):
    cx, cy, cz = cyl.center
    ox = o[..., 0] - cx
    oy = o[..., 1] - cy
    dx = d[..., 0]
    dy = d[..., 1]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    cq = ox * ox + oy * oy - cyl.radius ** 2
    disc = b * b - 4 * a * cq
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    asafe = _safe(a)
    t_lat1 = (-b - sq) / (2 * asafe)
    t_lat2 = (-b + sq) / (2 * asafe)

    def lat_ok(t):
        z = o[..., 2] + t * d[..., 2]
        return (disc >= 0) & (t > 0) & (z >= cz) & (z <= cz + cyl.height)

    t_lat = torch.where(lat_ok(t_lat1), t_lat1,
                        torch.where(lat_ok(t_lat2), t_lat2, _INF))
    dz = _safe(d[..., 2])
    t_caps = torch.full_like(dz, _INF)
    for zc in (cz, cz + cyl.height):
        t = (zc - o[..., 2]) / dz
        x = o[..., 0] + t * d[..., 0] - cx
        y = o[..., 1] + t * d[..., 1] - cy
        ok = (t > 0) & (x * x + y * y <= cyl.radius ** 2)
        t_caps = torch.minimum(t_caps, torch.where(ok, t, _INF))
    return torch.minimum(t_lat, t_caps)


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
    if isinstance(solid, Cylinder):
        return _ray_cylinder(o, d, solid)
    if isinstance(solid, Cone):
        return _ray_cone(o, d, solid)
    raise TypeError(type(solid))


# ---------------------------------------------------------------------------
# RGB-D camera
# ---------------------------------------------------------------------------

def render_rgbd(scene: Scene, cam_pose_world: np.ndarray,
                intr: PinholeIntrinsics, near: float = 0.05,
                far: float = 10.0, include_floor: bool | None = None,
                device="cuda"):
    """Render depth (H, W) f32 meters (0 = no return) and color (H, W, 3)
    f32 in [0, 255] on `device` from an optical-frame camera->world pose."""
    dev = resolve_device(device)
    if include_floor is None:
        include_floor = scene.floor
    solids = scene.all_solids()
    pose = torch.as_tensor(np.asarray(cam_pose_world, np.float32), device=dev)
    R = pose[:3, :3]
    t = pose[:3, 3]
    dirs = intr.pixel_rays(dev) @ R.T          # (H, W, 3) world, unit z-cam
    o = torch.broadcast_to(t, dirs.shape)

    ts = [_ray_solid(o, dirs, s) for s in solids]
    colors = [s.color for s in solids]
    if include_floor:
        t_floor = (0.0 - t[2]) / _safe(dirs[..., 2])
        ts.append(torch.where(t_floor > 0, t_floor, _INF))
        colors.append(_FLOOR_COLOR)
    ts = torch.stack(ts)                        # (K, H, W)
    tmin, best = torch.min(ts, dim=0)
    depth = torch.where((tmin > near) & (tmin < far), tmin, 0.0)
    palette = torch.tensor(colors, dtype=torch.float32, device=dev) * 255.0
    color = torch.where((depth > 0)[..., None], palette[best], 0.0)
    return depth, color


def render_depth(scene: Scene, cam_pose_world: np.ndarray,
                 intr: PinholeIntrinsics, **kw) -> torch.Tensor:
    """The depth of render_rgbd (same keywords)."""
    return render_rgbd(scene, cam_pose_world, intr, **kw)[0]


# ---------------------------------------------------------------------------
# 2D LiDAR
# ---------------------------------------------------------------------------

def render_lidar(scene: Scene, robot_x: float, robot_y: float,
                 robot_yaw: float, angles, range_min: float = 0.12,
                 range_max: float = 10.0, sensor_z: float = 0.17,
                 device="cuda") -> torch.Tensor:
    """Planar scan at height sensor_z from the robot pose (x, y, yaw);
    angles (B,) in the robot frame. Returns ranges (B,) f32 on `device`,
    +inf = no return."""
    dev = resolve_device(device)
    return _lidar(scene, torch.tensor(robot_x, dtype=torch.float32,
                                      device=dev),
                  torch.tensor(robot_y, dtype=torch.float32, device=dev),
                  torch.tensor(robot_yaw, dtype=torch.float32, device=dev),
                  torch.as_tensor(angles, dtype=torch.float32, device=dev),
                  range_min, range_max, sensor_z)


def render_lidar_path(scene: Scene, xs, ys, yaws, angles,
                      range_min: float = 0.12, range_max: float = 10.0,
                      sensor_z: float = 0.17, device="cuda") -> torch.Tensor:
    """Scans along a path: (K,) pose arrays -> (K, B) ranges on `device`,
    one batched render. Each row is bit-identical to render_lidar at the
    same pose (the same elementwise arithmetic with a leading pose axis)."""
    dev = resolve_device(device)

    def col(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)[:, None]
    return _lidar(scene, col(xs), col(ys), col(yaws),
                  torch.as_tensor(angles, dtype=torch.float32, device=dev),
                  range_min, range_max, sensor_z)


def _lidar(scene: Scene, x, y, yaw, angles, range_min, range_max, sensor_z):
    """Planar scans for f32 pose tensors x, y, yaw (0-d, or (K, 1) for a
    path) and angles (B,): ranges (B,) or (K, B)."""
    ga = angles + yaw
    dirs = torch.stack([torch.cos(ga), torch.sin(ga), torch.zeros_like(ga)],
                       dim=-1)
    o = torch.stack([x.expand_as(ga), y.expand_as(ga),
                     torch.full_like(ga, sensor_z)], dim=-1)
    ts = torch.stack([_ray_solid(o, dirs, s) for s in scene.all_solids()])
    tmin = ts.amin(dim=0)
    return torch.where((tmin >= range_min) & (tmin <= range_max), tmin,
                       torch.inf)
