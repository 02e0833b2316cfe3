"""Occupancy-grid ray casting, the virtual scan (counterpart of
otslam_tpu/kernels/raycast.py).

Behavioral contract from virtual_scan_node.cpp:258-287: for each beam, step
along the ray in ``resolution``-sized increments (distance incremented
*before* the cell test), return the accumulated distance at the first cell
whose value is 100 (occupied), +inf if the ray leaves the map or exceeds
``range_max``.

`ray_keys` computes, per beam, the first-stop and first-occupied step keys:
kernel K5 (csrc/raycast.cu) on CUDA tensors, its plain version
`ray_keys_torch` (all beams x all steps, a gather, a min over step keys) on
CPU tensors. K5 gives each ray a group of `lanes` lanes of a warp that
walks `lanes` steps at once; `lanes_for` picks the count for the card and
`ray_launch` gives the launch shape. `raycast_grid` is the plain path end
to end and `raycast_grid_fast` the routed one; both take one pose or a
batch of K poses, so a perception batch casts all its virtual scans in
one launch.

Not ported, because each exists only for Mosaic and the TPU's VMEM: the
prepared transposed bf16 grid planes (prepare_raycast_grid, gt_pad), the
window sizing (_win_sizes, _R_PLANES, _RAY_LANES, _VMEM_GRID_BUDGET), the
eligibility test (num_steps <= 256, B % 8) and the traced fit flag with its
fall-back to the XLA path. K5 takes any beam count and any step count.
"""

from __future__ import annotations

import torch

from otslam_tpu_torch.kernels import _build
from otslam_tpu_torch.kernels.nn import sm_count

LANE_CHOICES = (8, 16, 32)   # lanes a ray that K5 is compiled for
RAY_THREADS = 128            # threads a block
SM_THREADS = 2048            # threads an SM holds (Hopper)


def lanes_for(rays: int, sms: int) -> int:
    """K5's lanes a ray: the fewest (8, 16 or 32) whose threads fill every
    SM of the card at once, 32 when none does. Fewer lanes walk fewer steps
    past a ray's stop; more cut the chain of rounds when there are too few
    rays to fill the card (the mission's 8 poses: 32; 64 poses: 8)."""
    for lanes in LANE_CHOICES:
        if rays * lanes >= sms * SM_THREADS:
            return lanes
    return LANE_CHOICES[-1]


def ray_launch(rays: int, lanes: int) -> tuple[int, int]:
    """(blocks, threads) of a K5 launch over `rays` rays of `lanes` lanes
    each; refuses a lane count K5 is not compiled for and a negative ray
    count."""
    if lanes not in LANE_CHOICES:
        raise ValueError(f"lanes a ray must be one of {LANE_CHOICES}, got "
                         f"{lanes}")
    if rays < 0:
        raise ValueError(f"ray count must be >= 0, got {rays}")
    return -(-rays * lanes // RAY_THREADS), RAY_THREADS


def num_steps_for(range_max: float, resolution: float) -> int:
    """Steps of the C++ loop: distances (k+1)*res for every k with
    k*res < range_max."""
    return -int(-range_max // resolution)


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def beam_trig(robot_yaw, angles: torch.Tensor):
    """cos and sin of (yaw + angle) in f32: (B,) for a scalar yaw, (K, B)
    for a (K,) yaw. Computed once here, so K5 and its plain version share
    the same transcendental values."""
    ga = _f32(robot_yaw, angles.device)[..., None] + angles
    return torch.cos(ga), torch.sin(ga)


def ray_keys_torch(grid: torch.Tensor, cos_a: torch.Tensor,
                   sin_a: torch.Tensor, pose_xy: torch.Tensor,
                   resolution: float, origin_x: float, origin_y: float,
                   num_steps: int):
    """Plain version of K5: (first_stop, first_occ) int32 (K*B,) step keys.

    grid (H, W) int8; cos_a, sin_a (K, B) f32; pose_xy (K, 2) f32. Every
    sample is d = (s+1)*res, x = px + d*cos, gx = (int)((x - ox)/res), the
    arithmetic K5 performs in the same order; keys are num_steps where
    there is no stop / no occupied cell."""
    H, W = grid.shape
    dev = grid.device
    S = num_steps
    # device tensors, not Python scalars: PyTorch's CUDA division by a host
    # scalar multiplies by its reciprocal, K5 divides
    res = _f32(resolution, dev)
    ox = _f32(origin_x, dev)
    oy = _f32(origin_y, dev)
    d = (torch.arange(S, dtype=torch.float32, device=dev) + 1.0) * res
    c = cos_a.reshape(-1, 1)
    s = sin_a.reshape(-1, 1)
    B = cos_a.shape[-1]
    px = pose_xy[:, 0].repeat_interleave(B)[:, None]
    py = pose_xy[:, 1].repeat_interleave(B)[:, None]
    x = px + d[None, :] * c                               # (K*B, S)
    y = py + d[None, :] * s
    # truncating cast == the C++ (int)((x - ox) / res)
    gx = ((x - ox) / res).to(torch.int32)
    gy = ((y - oy) / res).to(torch.int32)
    oob = (gx < 0) | (gx >= W) | (gy < 0) | (gy >= H)
    flat = gy.clamp(0, H - 1) * W + gx.clamp(0, W - 1)
    occ = (grid.reshape(-1)[flat.long()] == 100) & ~oob
    stop = occ | oob
    steps = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    big = torch.tensor(S, dtype=torch.int32, device=dev)
    first_stop = torch.where(stop, steps, big).amin(dim=1)
    first_occ = torch.where(occ, steps, big).amin(dim=1)
    return first_stop, first_occ


def ray_keys(grid: torch.Tensor, cos_a: torch.Tensor, sin_a: torch.Tensor,
             pose_xy: torch.Tensor, resolution: float, origin_x: float,
             origin_y: float, num_steps: int, *, lanes: int | None = None):
    """(first_stop, first_occ) int32 (K*B,) step keys: kernel K5 on CUDA
    tensors, the plain version on CPU tensors. Identical results either
    way. grid (H, W) int8; cos_a, sin_a (K, B) f32; pose_xy (K, 2) f32.
    `lanes` (8, 16, 32) lanes walk a ray, by default `lanes_for` the ray
    count on this card."""
    if grid.device.type == "cpu":
        return ray_keys_torch(grid, cos_a, sin_a, pose_xy, resolution,
                              origin_x, origin_y, num_steps)
    if grid.dtype != torch.int8 or grid.dim() != 2:
        raise ValueError(f"grid must be (H, W) int8, got {tuple(grid.shape)}"
                         f" {grid.dtype}")
    if cos_a.dim() != 2 or sin_a.shape != cos_a.shape \
            or pose_xy.shape != (cos_a.shape[0], 2):
        raise ValueError(f"cos/sin must be (K, B) and pose_xy (K, 2): "
                         f"{tuple(cos_a.shape)}, {tuple(sin_a.shape)}, "
                         f"{tuple(pose_xy.shape)}")
    for t in (cos_a, sin_a, pose_xy):
        if t.dtype != torch.float32:
            raise ValueError(f"cos/sin/pose must be float32, got {t.dtype}")
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    H, W = grid.shape
    K, B = cos_a.shape
    if lanes is None:
        lanes = lanes_for(K * B, sm_count(grid.device))
    blocks, threads = ray_launch(K * B, lanes)
    first_stop = torch.empty(K * B, dtype=torch.int32, device=grid.device)
    first_occ = torch.empty_like(first_stop)
    _build.check_operands(grid, cos_a, sin_a, pose_xy, first_stop, first_occ)
    lib = _build.load()
    code = lib.otslam_raycast(grid.data_ptr(), H, W, cos_a.data_ptr(),
                              sin_a.data_ptr(), pose_xy.data_ptr(), B, K * B,
                              num_steps, resolution, origin_x, origin_y,
                              lanes, blocks, threads,
                              first_stop.data_ptr(), first_occ.data_ptr(),
                              _build.stream_ptr(grid.device))
    _build.check(code, "otslam_raycast")
    ray_keys.launches += 1
    return first_stop, first_occ


ray_keys.launches = 0


def _ranges_from_keys(first_stop, first_occ, num_steps: int,
                      resolution: float) -> torch.Tensor:
    """(first-stop step key, first-occupied step key) -> beam ranges."""
    hit = (first_stop < num_steps) & (first_occ == first_stop)
    rng = (first_stop.to(torch.float32) + 1.0) * resolution
    return torch.where(hit, rng, torch.inf)


def _cast(keys_fn, grid_data, resolution, origin_x, origin_y, robot_x,
          robot_y, robot_yaw, angles, range_max, num_steps):
    dev = grid_data.device
    if num_steps is None:
        num_steps = num_steps_for(range_max, resolution)
    angles = _f32(angles, dev)
    batched = torch.as_tensor(robot_yaw).dim() > 0
    cos_a, sin_a = beam_trig(robot_yaw, angles)
    pose_xy = torch.stack([_f32(robot_x, dev).reshape(-1),
                           _f32(robot_y, dev).reshape(-1)], dim=1)
    cos_a = cos_a.reshape(pose_xy.shape[0], -1).contiguous()
    sin_a = sin_a.reshape(pose_xy.shape[0], -1).contiguous()
    fs, fo = keys_fn(grid_data, cos_a, sin_a, pose_xy.contiguous(),
                     float(resolution), float(origin_x), float(origin_y),
                     num_steps)
    rng = _ranges_from_keys(fs, fo, num_steps, resolution)
    return rng.reshape(cos_a.shape) if batched else rng


def raycast_grid(grid_data: torch.Tensor, resolution: float,
                 origin_x: float, origin_y: float, robot_x, robot_y,
                 robot_yaw, angles, range_max: float,
                 num_steps: int | None = None) -> torch.Tensor:
    """Cast one ray per angle through an occupancy grid: the plain PyTorch
    path on any device.

    grid_data: (H, W) int8 tensor, row-major with row 0 at origin (ROS
    convention); angles: (B,) beam angles relative to the robot; the pose
    is three scalars (ranges (B,)) or three (K,) tensors (ranges (K, B)).
    Ranges are f32 with +inf for no hit."""
    return _cast(ray_keys_torch, grid_data, resolution, origin_x, origin_y,
                 robot_x, robot_y, robot_yaw, angles, range_max, num_steps)


def raycast_grid_fast(grid_data: torch.Tensor, resolution: float,
                      origin_x: float, origin_y: float, robot_x, robot_y,
                      robot_yaw, angles, range_max: float,
                      num_steps: int | None = None) -> torch.Tensor:
    """raycast_grid routed by the grid's device: kernel K5 for a CUDA grid
    (one launch for all K poses), the plain version for a CPU grid. The
    same ranges either way."""
    return _cast(ray_keys, grid_data, resolution, origin_x, origin_y,
                 robot_x, robot_y, robot_yaw, angles, range_max, num_steps)
