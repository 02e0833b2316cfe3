"""Ground-truth cloud assembly for the evaluation scenarios.

The reference samples 50k points from the Gazebo asset meshes (DAE/OBJ/STL)
with per-asset scale and placement (eval_table_chair.py:66-88). Those assets
are replaced by the analytic scene primitives (sim/world.py fixtures), whose
surfaces sample *exactly* — deterministic, area-weighted, seeded.
"""

from __future__ import annotations

import numpy as np

from otslam_tpu_torch.sim.world import Box, Cone, Cylinder, Scene


def _sample_box(box: Box, n: int, rng) -> np.ndarray:
    sx, sy, sz = box.size
    areas = np.array([sy * sz, sy * sz, sx * sz, sx * sz, sx * sy, sx * sy])
    face = rng.choice(6, n, p=areas / areas.sum())
    u = rng.uniform(-0.5, 0.5, n)
    v = rng.uniform(-0.5, 0.5, n)
    p = np.zeros((n, 3))
    half = np.array([sx, sy, sz]) / 2.0
    for f in range(6):
        m = face == f
        axis = f // 2
        sign = 1.0 if f % 2 == 0 else -1.0
        o1, o2 = [a for a in range(3) if a != axis]
        p[m, axis] = sign * half[axis]
        p[m, o1] = u[m] * box.size[o1]
        p[m, o2] = v[m] * box.size[o2]
    c, s = np.cos(box.yaw), np.sin(box.yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    return p @ R.T + np.asarray(box.center)


def _sample_cylinder(cyl: Cylinder, n: int, rng) -> np.ndarray:
    a_lat = 2 * np.pi * cyl.radius * cyl.height
    a_cap = np.pi * cyl.radius ** 2
    part = rng.choice(3, n, p=np.array([a_lat, a_cap, a_cap])
                      / (a_lat + 2 * a_cap))
    ang = rng.uniform(0, 2 * np.pi, n)
    p = np.zeros((n, 3))
    lat = part == 0
    p[lat, 0] = cyl.radius * np.cos(ang[lat])
    p[lat, 1] = cyl.radius * np.sin(ang[lat])
    p[lat, 2] = rng.uniform(0, cyl.height, lat.sum())
    for pi, z in ((1, cyl.height), (2, 0.0)):
        m = part == pi
        r = cyl.radius * np.sqrt(rng.uniform(0, 1, m.sum()))
        p[m, 0] = r * np.cos(ang[m])
        p[m, 1] = r * np.sin(ang[m])
        p[m, 2] = z
    return p + np.asarray(cyl.center)


def _sample_cone(cone: Cone, n: int, rng) -> np.ndarray:
    slant = np.hypot(cone.radius, cone.height)
    a_lat = np.pi * cone.radius * slant
    a_base = np.pi * cone.radius ** 2
    lat = rng.uniform(0, 1, n) < a_lat / (a_lat + a_base)
    ang = rng.uniform(0, 2 * np.pi, n)
    p = np.zeros((n, 3))
    # lateral: uniform over the cone surface => radius ~ sqrt(u)
    r = cone.radius * np.sqrt(rng.uniform(0, 1, n))
    z = cone.height * (1.0 - r / cone.radius)
    p[lat, 0] = r[lat] * np.cos(ang[lat])
    p[lat, 1] = r[lat] * np.sin(ang[lat])
    p[lat, 2] = z[lat]
    m = ~lat
    rb = cone.radius * np.sqrt(rng.uniform(0, 1, m.sum()))
    p[m, 0] = rb * np.cos(ang[m])
    p[m, 1] = rb * np.sin(ang[m])
    p[m, 2] = 0.0
    return p + np.asarray(cone.center)


def _sample_solid(solid, n: int, rng) -> np.ndarray:
    if isinstance(solid, Box):
        return _sample_box(solid, n, rng)
    if isinstance(solid, Cylinder):
        return _sample_cylinder(solid, n, rng)
    if isinstance(solid, Cone):
        return _sample_cone(solid, n, rng)
    raise TypeError(type(solid))


def sample_object_surfaces(objects, total: int = 50_000,
                           seed: int = 0) -> np.ndarray:
    """Sample GT points from the given solids, proportionally to rough area."""
    rng = np.random.default_rng(seed)
    if not objects:
        return np.zeros((0, 3), np.float32)
    per = max(1, total // len(objects))
    pts = [_sample_solid(o, per, rng) for o in objects]
    return np.concatenate(pts).astype(np.float32)


def sample_scene_surface(scene: Scene, total: int = 50_000,
                         seed: int = 0, include_walls: bool = False
                         ) -> np.ndarray:
    objs = scene.all_solids() if include_walls else scene.objects
    return sample_object_surfaces(objs, total, seed)


def scenario_gt(name: str, total: int = 50_000, seed: int = 0) -> np.ndarray:
    """GT cloud for a named eval scenario (table_chair / cone / cardboard)."""
    from otslam_tpu_torch.sim.world import (
        cardboard_room, cone_room, table_chair_room)
    scenes = {"table_chair": table_chair_room, "cone": cone_room,
              "cardboard": cardboard_room}
    return sample_scene_surface(scenes[name](), total, seed)


# --- real-format GT assembly (mesh assets, reference protocol) -------------
#
# Mirrors eval_table_chair.py:66-88 / eval_cone.py:27-49: load a DAE/OBJ/STL
# mesh, sample N surface points, apply per-axis scale, then rotate (degrees,
# XYZ euler about the origin) and translate — in exactly that order.

def load_and_scale_gt(filename: str, scale_factors, n: int = 50_000,
                      seed: int = 0, unit_scale: float = 1.0) -> np.ndarray:
    """Mesh file -> (n, 3) sampled + scaled GT points.

    Matches the reference loader (eval_table_chair.py:66-80): sample first,
    then multiply by unit_scale and the per-axis scale_factors.
    """
    from otslam_tpu_torch.core.mesh_io import load_mesh, sample_mesh_surface
    mesh = load_mesh(filename)
    pts = sample_mesh_surface(mesh, n, seed) * unit_scale
    return (pts * np.asarray(scale_factors, np.float64)).astype(np.float32)


def apply_transform(points: np.ndarray, rot_deg, trans) -> np.ndarray:
    """Rotate (XYZ euler, degrees, about the origin) then translate —
    eval_table_chair.py:82-88 apply_transform semantics."""
    rx, ry, rz = np.radians(np.asarray(rot_deg, np.float64))
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    R = Rz @ Ry @ Rx        # o3d get_rotation_matrix_from_xyz convention
    return (points.astype(np.float64) @ R.T
            + np.asarray(trans, np.float64)).astype(np.float32)


def assemble_mesh_gt(assets, n_per: int = 50_000, seed: int = 0,
                     unit_scale: float = 1.0,
                     global_rot=(0.0, 0.0, 0.0),
                     global_trans=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Full reference GT protocol over a list of placed mesh assets.

    assets: iterable of (path, scale_factors, rot_deg, trans) tuples —
    one per scene object, like the TABLE/CHAIR_1..4 blocks of
    eval_table_chair.py:23-33. A final global offset (the per-method
    GT_OFFSET_* alignment, :40-47) applies to the combined cloud.
    """
    parts = []
    for k, (path, scale, rot, trans) in enumerate(assets):
        pts = load_and_scale_gt(path, scale, n_per, seed + k, unit_scale)
        parts.append(apply_transform(pts, rot, trans))
    gt = np.concatenate(parts) if parts else np.zeros((0, 3), np.float32)
    return apply_transform(gt, global_rot, global_trans)
