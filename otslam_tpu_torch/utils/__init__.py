"""Stage timers and the stage-isolating debug probes."""

from otslam_tpu_torch.utils.probes import (  # noqa: F401
    depth_stats,
    depth_heat_image,
    trajectory_frames,
)
from otslam_tpu_torch.utils.profiling import StageTimer  # noqa: F401
