"""otslam_tpu_torch — the PyTorch/CUDA port of otslam_tpu.

The port mirrors otslam_tpu's module paths, so each counterpart is found by
name; otslam_tpu stays the reference the port is tested against. This
package never imports jax or otslam_tpu.

Layer map (everything the JAX package does except its benchmark):
  core/        camera model, SE(3)/frames, PLY/pose/depth io, volume io,
               occupancy grid
  kernels/     TSDF fusion (dense and block-sparse), resampling, NN/chamfer
               (full and radius-windowed), ICP, frame-to-model tracking,
               pose graph, ray cast, scan diff, evidence grids, host
               clustering; the hand-written CUDA kernels live in csrc/ and
               are built on first use by kernels/_build.py
  pipeline/    dataset reader, pose refinement, frames -> TSDF -> cloud,
               streaming fusion over the native frame ring (online.py)
  adapters/    the native host runtime and mission control plane (their
               C++ in otslam_tpu_torch/native, built with g++ on first
               use), the topic bus
  distributed/ sharded fusion, extraction and eval on torch.distributed
  mapping/     scan-to-map localization, virtual scanner, change detector,
               batched perception ticks, object filters
  mission/     tracker, visiting points, goal queue, manager, scanner
               (host numpy)
  sim/         analytic scenes, RGB-D and planar LiDAR renderers, the
               closed-loop MissionRunner
  eval/        accuracy/completeness metrics (optionally ICP-aligned), GT

Every function that takes a ``device`` argument runs there; a CUDA device
requested on a machine without CUDA raises instead of running on the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry here is precision-critical: TF32 keeps ~10 mantissa bits, the
# same class of error as the bf16 MXU rounding the JAX package pins away
# (otslam_tpu/__init__.py). Pin full f32 for matmuls and convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from otslam_tpu_torch.config import OTSLAMConfig  # noqa: E402,F401
