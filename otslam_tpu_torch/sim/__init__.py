"""Analytic scenes and the RGB-D renderer."""
from otslam_tpu_torch.sim.world import Box, Cylinder, Cone, Scene  # noqa: F401
from otslam_tpu_torch.sim.sensors import (  # noqa: F401
    render_depth,
    render_rgbd,
    render_lidar,
    look_at_pose,
)
