"""Dataset reader, the per-object reconstruction pipeline and online
fusion."""

from otslam_tpu_torch.pipeline.online import OnlineFusion  # noqa: F401
