"""Analytic simulation scenes.

Replaces the Gazebo worlds as the integration fixture (SURVEY.md §4.1): a
scene is a list of primitives (oriented boxes, cylinders, cones) in a walled
room. Everything renders analytically (sim/sensors.py) and samples exact
surface points (eval/scenarios.py) — no meshes, no physics, fully
deterministic.

The default room mirrors gazebo_turtlebot3's test rooms: rectangular walls,
a few objects (cardboard box, table + chairs, cones); Scene.occupancy_grid
rasterizes its footprint into a 2D map.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class Box:
    """Oriented box: center (x, y, z), full size (sx, sy, sz), yaw (rad)."""

    center: Tuple[float, float, float]
    size: Tuple[float, float, float]
    yaw: float = 0.0
    color: Tuple[float, float, float] = (0.8, 0.6, 0.3)
    name: str = "box"


@dataclass(frozen=True)
class Cylinder:
    """Vertical cylinder: center of base (x, y, z), radius, height."""

    center: Tuple[float, float, float]
    radius: float
    height: float
    color: Tuple[float, float, float] = (0.3, 0.5, 0.8)
    name: str = "cylinder"


@dataclass(frozen=True)
class Cone:
    """Vertical cone: center of base (x, y, z), base radius, height (apex up)."""

    center: Tuple[float, float, float]
    radius: float
    height: float
    color: Tuple[float, float, float] = (0.9, 0.4, 0.1)
    name: str = "cone"


@dataclass(frozen=True)
class Scene:
    """Primitives + a rectangular room [xmin, xmax] x [ymin, ymax] with walls."""

    objects: Tuple = ()
    room: Tuple[float, float, float, float] = (-5.0, 5.0, -5.0, 5.0)
    wall_height: float = 2.0
    wall_thickness: float = 0.1
    floor: bool = True

    def wall_boxes(self) -> Tuple[Box, ...]:
        xmin, xmax, ymin, ymax = self.room
        t = self.wall_thickness
        h = self.wall_height
        cx, cy = (xmin + xmax) / 2, (ymin + ymax) / 2
        lx, ly = xmax - xmin, ymax - ymin
        gray = (0.5, 0.5, 0.5)
        return (
            Box((cx, ymax + t / 2, h / 2), (lx + 2 * t, t, h), 0.0, gray, "wall_n"),
            Box((cx, ymin - t / 2, h / 2), (lx + 2 * t, t, h), 0.0, gray, "wall_s"),
            Box((xmax + t / 2, cy, h / 2), (t, ly, h), 0.0, gray, "wall_e"),
            Box((xmin - t / 2, cy, h / 2), (t, ly, h), 0.0, gray, "wall_w"),
        )

    def all_solids(self) -> Tuple:
        return tuple(self.objects) + self.wall_boxes()

    def occupancy_grid(self, resolution: float = 0.05,
                       include_objects: bool = True):
        """Rasterize the scene footprint into a ROS-convention occupancy
        grid (host numpy data). Returns an OccupancyGrid2D."""
        from otslam_tpu_torch.core.grid import OccupancyGrid2D

        xmin, xmax, ymin, ymax = self.room
        t = self.wall_thickness
        ox, oy = xmin - 2 * t, ymin - 2 * t
        W = int(np.ceil((xmax - xmin + 4 * t) / resolution))
        H = int(np.ceil((ymax - ymin + 4 * t) / resolution))
        xs = ox + (np.arange(W) + 0.5) * resolution
        ys = oy + (np.arange(H) + 0.5) * resolution
        gx, gy = np.meshgrid(xs, ys)  # (H, W)
        occ = np.zeros((H, W), bool)
        solids = self.all_solids() if include_objects else self.wall_boxes()
        for s in solids:
            occ |= _footprint_mask(s, gx, gy)
        data = np.where(occ, 100, 0).astype(np.int8)
        return OccupancyGrid2D(data, resolution, (float(ox), float(oy)))


def _footprint_mask(solid, gx, gy):
    if isinstance(solid, Box):
        c, s = np.cos(-solid.yaw), np.sin(-solid.yaw)
        lx = (gx - solid.center[0]) * c - (gy - solid.center[1]) * s
        ly = (gx - solid.center[0]) * s + (gy - solid.center[1]) * c
        return ((np.abs(lx) <= solid.size[0] / 2)
                & (np.abs(ly) <= solid.size[1] / 2))
    r2 = (gx - solid.center[0]) ** 2 + (gy - solid.center[1]) ** 2
    return r2 <= solid.radius ** 2


def cardboard_room() -> Scene:
    """A room with a single cardboard box (eval_cardboard fixture)."""
    return Scene(objects=(
        Box((1.5, 0.5, 0.15), (0.5, 0.4, 0.3), 0.3, (0.76, 0.6, 0.42),
            "cardboard_box"),
    ))


def cone_room() -> Scene:
    """Two construction cones (eval_cone fixture)."""
    return Scene(objects=(
        Cone((1.0, 1.0, 0.0), 0.16, 0.5, (0.9, 0.35, 0.1), "cone_1"),
        Cone((-1.2, 0.8, 0.0), 0.16, 0.5, (0.9, 0.35, 0.1), "cone_2"),
    ))


def full_room() -> Scene:
    """The production 5-object-group scene: marble table + 4 chairs +
    cardboard box + 2 cones in one large room, at the reference world's
    absolute placements (cardboard_table_chairs_cones_room.world:249-378:
    table (-2.23, -3.31), chairs (-1.71, -2.1) (-2.72, -2.1) (-1.68, -4.7)
    (-2.84, -4.7), cardboard_box (5.98, 6.04), cones (-3.99, 6.08)
    (-4.85, 5.23); the Gazebo room is 20x20 — 15x15 here keeps every
    placement in-room while the LiDAR still reaches the far walls)."""
    table = Box((-2.23, -3.31, 0.36), (1.4, 0.8, 0.72), 0.0,
                (0.85, 0.85, 0.8), "table_marble")
    chairs = tuple(
        Box((x, y, 0.45), (0.45, 0.45, 0.9), yaw, (0.4, 0.25, 0.15),
            f"chair_{i+1}")
        for i, (x, y, yaw) in enumerate(
            [(-1.71, -2.1, -np.pi / 2), (-2.72, -2.1, -np.pi / 2),
             (-1.68, -4.7, np.pi / 2), (-2.84, -4.7, np.pi / 2)]))
    box = Box((5.98, 6.04, 0.15), (0.5, 0.4, 0.3), 0.0, (0.76, 0.6, 0.42),
              "cardboard_box")
    cones = (Cone((-3.99, 6.08, 0.0), 0.16, 0.5, (0.2, 0.3, 0.9),
                  "cone_blue"),
             Cone((-4.85, 5.23, 0.0), 0.16, 0.5, (0.9, 0.35, 0.1),
                  "cone_red"))
    return Scene(objects=(table,) + chairs + (box,) + cones,
                 room=(-7.5, 7.5, -7.5, 7.5))


def table_chair_room() -> Scene:
    """Marble table + 4 chairs (eval_table_chair fixture,
    cardboard_table_chairs_cones_room.world:249-378)."""
    table = Box((0.0, 0.2, 0.36), (1.4, 0.8, 0.72), 0.0, (0.85, 0.85, 0.8),
                "table_marble")
    chairs = tuple(
        Box((x, y, 0.45), (0.45, 0.45, 0.9), yaw, (0.4, 0.25, 0.15),
            f"chair_{i+1}")
        for i, (x, y, yaw) in enumerate(
            [(0.6, 1.45, 0.0), (-0.45, 1.45, 0.0),
             (-0.6, -1.25, np.pi), (0.6, -1.25, np.pi)]))
    return Scene(objects=(table,) + chairs)
