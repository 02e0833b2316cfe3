"""Camera model, SE(3)/frame conventions, file io and volume io."""

from otslam_tpu_torch.core.camera import PinholeIntrinsics  # noqa: F401
