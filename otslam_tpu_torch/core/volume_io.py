"""TSDF volume checkpointing (counterpart of otslam_tpu/core/volume_io.py).

Same `.npz` layout as the JAX package, so either package reads the other's
files: fusion can resume a volume that the other package started.
"""

from __future__ import annotations

import os

import numpy as np

from otslam_tpu_torch.kernels.tsdf import TSDFVolume
from otslam_tpu_torch.kernels.tsdf_block import BlockTSDFVolume


def save_volume(path: str, vol) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if isinstance(vol, BlockTSDFVolume):
        f = vol.to_numpy()
        np.savez_compressed(
            path, kind="block", tsdf=f["tsdf"], weight=f["weight"],
            color=f["color"], created=f["created"],
            origin=np.asarray(vol.origin), voxel_size=vol.voxel_size,
            sdf_trunc=vol.sdf_trunc, grid_blocks=np.asarray(vol.grid_blocks))
    elif isinstance(vol, TSDFVolume):
        f = vol.to_numpy()
        np.savez_compressed(
            path, kind="dense", tsdf=f["tsdf"], weight=f["weight"],
            color=f["color"], origin=np.asarray(vol.origin),
            voxel_size=vol.voxel_size, sdf_trunc=vol.sdf_trunc)
    else:
        raise TypeError(type(vol))


def load_volume(path: str, device="cuda"):
    """The volume saved at `path` (by either package), on `device`."""
    with np.load(path) as z:
        kind = str(z["kind"])
        origin = tuple(float(v) for v in z["origin"])
        if kind == "block":
            return BlockTSDFVolume.from_numpy(
                z["tsdf"], z["weight"], z["color"], z["created"], origin,
                float(z["voxel_size"]), float(z["sdf_trunc"]),
                tuple(int(v) for v in z["grid_blocks"]), device=device)
        return TSDFVolume.from_numpy(
            z["tsdf"], z["weight"], z["color"], origin,
            float(z["voxel_size"]), float(z["sdf_trunc"]), device=device)
