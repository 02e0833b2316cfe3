"""The recon cells' inputs: per-object RGB-D captures made from the seed.

One general generator reads a traffic file's parameters:

* ``poses: "visiting"``: the mission's visiting circle around an object
  (3_multi_object_goal_selector.cpp:275-308). Radius r = diag/2 +
  lock_margin + visiting_point_buffer, count = max(min_scan_points,
  round(2 pi r / scan_point_interval)), each viewpoint facing the centre.
* ``poses: "orbit"``: the camera's whole stream along that circle, one
  frame per 1/frame_rate_hz seconds at orbit_speed_m_s:
  round(2 pi r / speed * rate) frames.

The seed picks each object's start angle on its circle (uniform over one
viewpoint step, so every seed sees the same number of frames) and the
order in which the window asks for them, round by round (every
object once a round). Frames are rendered on
the device with the frozen renderer, quantized as the scanner saves them
(uint16 millimetres, uint8 colour), truncated at the camera's depth_trunc
as the capture loader does, and returned as host arrays: what
`CaptureDataset.load_object` hands `reconstruct_frames`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark import harness
from benchmark.inputs.render import pixel_rays, render_rgbd
from benchmark.inputs.scene import object_by_name, scene

# body frame -> optical frame of the forward camera (reconstruct_rgbd_gt.py:
# 52-57) and the capture files' optical fix (reconstruct_rgbd.py:29-34)
T_FIX_GT = np.array([[0.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 0.0, 0.0],
                     [0.0, -1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
T_FIX_OPTICAL = np.array([[0.0, -1.0, 0.0, 0.0], [0.0, 0.0, -1.0, 0.0],
                          [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])


@dataclass
class Capture:
    """One object's frames, as host arrays (the port's FrameBatch fields)."""

    name: str
    depths: np.ndarray      # (N, H, W) f32 metres, 0 invalid
    colors: np.ndarray      # (N, H, W, 3) f32 in [0, 255]
    extrinsics: np.ndarray  # (N, 4, 4) f32 world -> optical camera
    poses: np.ndarray       # (N, 4, 4) f64 map -> body, as the files hold


def circle_radius(obj, rule: dict) -> float:
    sx, sy = obj.footprint()
    return (float(np.hypot(sx, sy)) / 2 + rule["lock_margin"]
            + rule["visiting_point_buffer"])


def frame_count(obj, traffic: dict) -> int:
    rule = traffic["circle"]
    r = circle_radius(obj, rule)
    if traffic["poses"] == "visiting":
        return max(rule["min_scan_points"],
                   int(round(2 * np.pi * r / rule["scan_point_interval"])))
    if traffic["poses"] == "orbit":
        return int(round(2 * np.pi * r / traffic["orbit_speed_m_s"]
                         * traffic["frame_rate_hz"]))
    raise ValueError(f"unknown pose rule {traffic['poses']!r}")


def body_poses(obj, traffic: dict, phase: float) -> np.ndarray:
    """(N, 4, 4) map -> body poses on the object's circle, facing it."""
    r = circle_radius(obj, traffic["circle"])
    n = frame_count(obj, traffic)
    h = traffic["camera_height"]
    out = np.zeros((n, 4, 4))
    for i in range(n):
        ang = phase + 2 * np.pi * i / n
        yaw = ang + np.pi
        c, s = np.cos(yaw), np.sin(yaw)
        out[i] = [[c, -s, 0, obj.center[0] + r * np.cos(ang)],
                  [s, c, 0, obj.center[1] + r * np.sin(ang)],
                  [0, 0, 1, h], [0, 0, 0, 1]]
    return out


def make_capture(world, obj, traffic: dict, camera: dict, phase: float,
                 rays: torch.Tensor) -> Capture:
    """Render, quantize and truncate one object's frames."""
    body = body_poses(obj, traffic, phase)
    depths, colors, exts, files = [], [], [], []
    for pose in body:
        optical = pose @ T_FIX_GT
        d, c = render_rgbd(world, optical, rays, far=camera["depth_max"])
        # scanner_node.cpp:277-281 then the loader's scale and depth_trunc
        mm = torch.round(d * camera["depth_scale"])
        d = mm.to(torch.int32).to(torch.float32) / camera["depth_scale"]
        d = torch.where((d > 0) & (d <= camera["depth_trunc"]), d, 0.0)
        depths.append(d)
        colors.append(c.to(torch.uint8).to(torch.float32))
        exts.append(np.linalg.inv(optical).astype(np.float32))
        files.append(optical @ T_FIX_OPTICAL.T)
    return Capture(obj.name, torch.stack(depths).cpu().numpy(),
                   torch.stack(colors).cpu().numpy(), np.stack(exts),
                   np.stack(files))


def make_captures(traffic: dict, camera: dict, seed: int, device):
    """({name: Capture}, rounds): `rounds` yields round after round, each
    every object once in a seeded order, without end; the window takes
    whole rounds until its deadline."""
    world = scene(traffic["scene"])
    rng = np.random.default_rng(seed)
    rays = pixel_rays(camera["width"], camera["height"], camera["fx"],
                      camera["fy"], camera["cx"], camera["cy"], device)
    caps = {}
    for name in traffic["objects"]:
        obj = object_by_name(world, name)
        step = 2 * np.pi / frame_count(obj, traffic)
        caps[name] = make_capture(world, obj, traffic, camera,
                                  float(rng.uniform(0.0, step)), rays)
    return caps, harness.rounds(rng, [str(n) for n in traffic["objects"]])
