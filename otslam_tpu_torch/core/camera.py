"""Pinhole camera model.

Reference semantics: Open3D `PinholeCameraIntrinsic(width, height, fx, fy, cx, cy)`
as configured in the reference's reconstruct_rgbd.py:12-15 (fx = fy =
565.6009, cx = 320.5, cy = 240.5, 640x480). Counterpart of
otslam_tpu/core/camera.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from otslam_tpu_torch.config import CameraConfig


@dataclass(frozen=True)
class PinholeIntrinsics:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    @classmethod
    def from_config(cls, cfg: CameraConfig) -> "PinholeIntrinsics":
        return cls(cfg.width, cfg.height, cfg.fx, cfg.fy, cfg.cx, cfg.cy)

    @property
    def K(self) -> np.ndarray:
        """3x3 intrinsics matrix."""
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    def pixel_rays_np(self, dtype=np.float32) -> np.ndarray:
        """(H, W, 3) camera-frame ray directions with unit z, host numpy.

        point = depth * ray reproduces Open3D's back-projection
        x = (u - cx) * z / fx, y = (v - cy) * z / fy (pixel centers at
        integer coordinates, matching Open3D's convention).
        """
        u = np.arange(self.width, dtype=dtype)
        v = np.arange(self.height, dtype=dtype)
        uu, vv = np.meshgrid(u, v)  # (H, W)
        x = (uu - self.cx) / self.fx
        y = (vv - self.cy) / self.fy
        return np.stack([x, y, np.ones_like(x)], axis=-1)

    def pixel_rays(self, device: str | torch.device = "cuda") -> torch.Tensor:
        """f32 pixel_rays_np as a tensor on `device` (computed on the host,
        copied once)."""
        return torch.as_tensor(self.pixel_rays_np(), device=device)
