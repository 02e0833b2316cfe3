"""A looped capture for the pose-graph refiner's tests: the visiting
circle's generator at a step of 45 degrees, 8 views, then the first two
again, so frames 8 and 9 revisit frames 0 and 1 (8 frames apart, within
the loop radius) and the loop search has pairs to verify. The poses carry
the traffic's planar localizer error, drawn as the tests draw it.
"""

from __future__ import annotations

import numpy as np

from benchmark.drivers.recon_refine import noisy
from benchmark.inputs.captures import Capture, circle_radius, make_captures
from benchmark.inputs.scene import object_by_name, scene


def looped(camera: dict, traffic: dict, name: str, seed: int) -> Capture:
    """10 views of `name` 45 degrees apart on its visiting circle, the last
    two revisiting the first two, at the traffic's planar pose error."""
    obj = object_by_name(scene(traffic["scene"]), name)
    step = 2 * np.pi * circle_radius(obj, traffic["circle"]) / 8
    t = dict(traffic, objects=[name],
             circle=dict(traffic["circle"], scan_point_interval=step))
    caps, _ = make_captures(t, camera, seed, "cpu")
    c = caps[name]
    idx = list(range(8)) + [0, 1]
    truth = Capture(name, c.depths[idx], c.colors[idx], c.extrinsics[idx],
                    c.poses[idx])
    return noisy(truth, np.random.default_rng([seed, 1]),
                 traffic["pose_noise_xy_m"], traffic["pose_noise_yaw_rad"])
