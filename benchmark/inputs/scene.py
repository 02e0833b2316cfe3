"""The `full_room` scene, frozen for the benchmark.

A copy of the port's `sim/world.py` primitives and its `full_room()` at the
reference world's placements (cardboard_table_chairs_cones_room.world:
249-378), so that a later change to the port's simulator cannot move the
benchmark's inputs. The saved map of the mission cell adds the phantom
removed box at (4, -4) that MISSION_r04's `--removed` puts there.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
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

    def footprint(self) -> Tuple[float, float]:
        """(x, y) extent of the footprint, the tracker's bounding box."""
        return self.size[0], self.size[1]


@dataclass(frozen=True)
class Cone:
    """Vertical cone: center of base (x, y, z), base radius, height."""

    center: Tuple[float, float, float]
    radius: float
    height: float
    color: Tuple[float, float, float] = (0.9, 0.4, 0.1)
    name: str = "cone"

    def footprint(self) -> Tuple[float, float]:
        return 2 * self.radius, 2 * self.radius


@dataclass(frozen=True)
class Scene:
    """Primitives in a rectangular walled room [xmin, xmax] x [ymin, ymax]."""

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

    def occupancy(self, resolution: float = 0.05):
        """(data (H, W) int8 with 100 = occupied, 0 = free; origin (x, y)):
        the scene's footprint rasterized at cell centres, ROS convention."""
        xmin, xmax, ymin, ymax = self.room
        t = self.wall_thickness
        ox, oy = xmin - 2 * t, ymin - 2 * t
        W = int(np.ceil((xmax - xmin + 4 * t) / resolution))
        H = int(np.ceil((ymax - ymin + 4 * t) / resolution))
        xs = ox + (np.arange(W) + 0.5) * resolution
        ys = oy + (np.arange(H) + 0.5) * resolution
        gx, gy = np.meshgrid(xs, ys)
        occ = np.zeros((H, W), bool)
        for s in self.all_solids():
            occ |= _footprint_mask(s, gx, gy)
        return np.where(occ, 100, 0).astype(np.int8), (float(ox), float(oy))


def _footprint_mask(solid, gx, gy):
    if isinstance(solid, Box):
        c, s = np.cos(-solid.yaw), np.sin(-solid.yaw)
        lx = (gx - solid.center[0]) * c - (gy - solid.center[1]) * s
        ly = (gx - solid.center[0]) * s + (gy - solid.center[1]) * c
        return ((np.abs(lx) <= solid.size[0] / 2)
                & (np.abs(ly) <= solid.size[1] / 2))
    r2 = (gx - solid.center[0]) ** 2 + (gy - solid.center[1]) ** 2
    return r2 <= solid.radius ** 2


PHANTOM = Box((4.0, -4.0, 0.15), (0.5, 0.4, 0.3), 0.0, (0.7, 0.7, 0.7),
              "removed_box")


def full_room() -> Scene:
    """Marble table + 4 chairs + cardboard box + 2 cones in a 15 m room."""
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


SCENES = {"full_room": full_room}


def scene(name: str) -> Scene:
    """The named frozen scene."""
    return SCENES[name]()


def saved_map_scene(world: Scene, phantom: bool) -> Scene:
    """What the saved 2D map knows: the room's walls, plus the phantom
    removed box when asked (the world's objects are what changed)."""
    return replace(world, objects=(PHANTOM,) if phantom else ())


def object_by_name(world: Scene, name: str):
    for o in world.objects:
        if o.name == name:
            return o
    raise KeyError(f"no object {name!r} in the scene")
