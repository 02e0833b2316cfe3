"""Online (streaming) TSDF fusion (counterpart of
otslam_tpu/pipeline/online.py).

Production serving shape: a sensor/capture thread pushes RGB-D frames into
the native SPSC ring buffer (adapters/native.FrameRing — drop-oldest QoS, no
GIL contention on the copy), and the fusion loop drains them in micro-batches
through the block-sparse schedule (`integrate_frames_cuda`: the depth mips,
K2, the colour pack and K1 on the card) into a persistent volume. Poses ride
a parallel Python-side queue keyed by the frame stamp.

    of = OnlineFusion(cfg.reconstruction, intr)
    of.push(depth, color, pose)          # sensor side (any thread)
    of.drain()                           # fusion side: integrate pending
    pts, cols, mask = of.extract()       # anytime snapshot

The tail micro-batch is fused as it is (the JAX class pads it to the batch
size its Pallas program was compiled for); K1 applies each frame's running
mean in order, so draining in micro-batches equals one batch fusion of the
same frames bit for bit. Kernels launch only from the draining thread.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from otslam_tpu_torch.adapters.native import FrameRing
from otslam_tpu_torch.config import ReconstructionConfig
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.device import resolve_device
from otslam_tpu_torch.kernels.tsdf_block import (
    BlockTSDFVolume, extract_surface_points_sparse, make_block_volume)
from otslam_tpu_torch.kernels.tsdf_cuda import integrate_frames_cuda


class OnlineFusion:
    def __init__(self, cfg: ReconstructionConfig, intr: PinholeIntrinsics,
                 ring_capacity: int = 16, batch: int = 4,
                 max_active: int | None = 2048, device="cuda"):
        self.cfg = cfg
        self.intr = intr
        self.batch = batch
        self.max_active = max_active
        self.device = resolve_device(device)
        self.ring = FrameRing(intr.height, intr.width, ring_capacity)
        self._poses: dict = {}
        self._pose_lock = threading.Lock()
        self._stamp = 0
        self.volume: BlockTSDFVolume = make_block_volume(cfg.tsdf,
                                                         self.device)
        self.frames_fused = 0

    # --- producer side ------------------------------------------------------

    def push(self, depth_m: np.ndarray, color_rgb: np.ndarray,
             extrinsic: np.ndarray) -> int:
        """Enqueue one frame (world->camera extrinsic). Thread-safe SPSC:
        one producer thread, one consumer thread."""
        with self._pose_lock:
            self._stamp += 1
            stamp = self._stamp
            self._poses[stamp] = np.asarray(extrinsic, np.float32)
        self.ring.push(depth_m, color_rgb, stamp=float(stamp))
        return stamp

    # --- consumer side ------------------------------------------------------

    def drain(self, max_batches: Optional[int] = None) -> int:
        """Integrate everything pending (in arrival order); returns the
        number of frames fused this call."""
        fused = 0
        batches = 0
        while max_batches is None or batches < max_batches:
            frames = []
            while len(frames) < self.batch:
                item = self.ring.pop()
                if item is None:
                    break
                frames.append(item)
            if not frames:
                break
            depths = np.stack([f[0] for f in frames])
            colors = np.stack([f[1] for f in frames]).astype(np.float32)
            with self._pose_lock:
                exts = np.stack([self._poses.pop(int(f[2])) for f in frames])
            dev = self.device
            integrate_frames_cuda(
                self.volume, torch.as_tensor(depths, device=dev),
                torch.as_tensor(colors, device=dev),
                torch.as_tensor(exts, device=dev), self.intr,
                max_active=self.max_active)
            fused += len(frames)
            batches += 1
        self.frames_fused += fused
        return fused

    def extract(self, capacity: int = 1_000_000, with_normals: bool = False):
        """Surface points of the created blocks (the JAX class's
        `max_blocks` bound is not needed: the port lists created blocks
        exactly)."""
        return extract_surface_points_sparse(
            self.volume, capacity=capacity, with_normals=with_normals)

    @property
    def dropped_frames(self) -> int:
        return self.ring.dropped
