"""SE(3) pose-graph optimization (counterpart of
otslam_tpu/kernels/pose_graph.py).

Odometry/ICP relative-pose edges plus loop-closure edges over the capture
circle are jointly optimized with Gauss-Newton over a right-multiplicative
se(3) retraction. The residuals of all edges are batched, the Jacobian of
the stacked residual comes from forward-mode AD (`torch.func.jacfwd`, 6E x
6N: tiny at mission scale), and the damped normal equations are solved on
the residuals' device. The iterations are a Python loop with no host sync.

Plain PyTorch: no TPU kernel stands behind this module. Edges need no
padding (the JAX package pads them for its jit cache; weight-0 edges are
inert, so a padded and an unpadded graph give the same poses).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from otslam_tpu_torch.kernels.tsdf import recip32


def _hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat map: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation and (..., 3) translation -> (..., 4, 4), built
    without in-place writes (forward-mode AD friendly)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom = torch.cat([bottom[..., :3], torch.ones_like(bottom[..., 3:])],
                       dim=-1)
    return torch.cat([top, bottom], dim=-2)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential. xi = (wx, wy, wz, tx, ty, tz) -> (4, 4).

    Rotation block via Rodrigues; translation through the left Jacobian V.
    Small-angle branches use the Taylor series, chosen with torch.where;
    the sqrt argument itself is branch-guarded, because sqrt'(0) = inf
    would poison both branches under forward-mode AD (as in JAX)."""
    w = xi[..., :3]
    v = xi[..., 3:]
    # keepdim: no 0-dim intermediate (under torch.func.jacfwd a 0-dim
    # operand next to a Python scalar gets a float64 tangent)
    th2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    small = th2 < 1e-8
    th2s = torch.where(small, 1.0, th2)
    th = torch.sqrt(th2s)
    W = _hat(w)
    W2 = W @ W
    A = torch.where(small, 1.0 - th2 * recip32(6.0), torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 * recip32(24.0),
                    (1.0 - torch.cos(th)) / th2s)
    C = torch.where(small, recip32(6.0) - th2 * recip32(120.0),
                    (th - torch.sin(th)) / (th2s * th))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + A * W + B * W2
    V = eye + B * W + C * W2
    t = (V @ v[..., None])[..., 0]
    return _homogeneous(R, t)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """se(3) logarithm. (4, 4) -> (wx, wy, wz, tx, ty, tz).

    Valid for rotation angles < pi; small-angle branches mirror exp_se3,
    and the arccos argument is branch-guarded (arccos'(1) = inf)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    trace = R[..., 0, 0:1] + R[..., 1, 1:2] + R[..., 2, 2:3]   # (..., 1)
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)[..., None]
    # 1 - 1e-6 is representable in f32: the cutover sits at th ~ 1.4e-3
    small = cos > 1.0 - 1e-6
    th = torch.arccos(torch.where(small, 0.0, cos))
    th2_taylor = 2.0 * (1.0 - cos)
    th2 = torch.where(small, th2_taylor, th * th)
    k = torch.where(small, 0.5 + th2_taylor * recip32(12.0),
                    th / (2.0 * torch.sin(th)))
    S = (R - R.transpose(-1, -2)) * k
    w = torch.stack([S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], -1)
    W = _hat(w)
    W2 = W @ W
    # V^{-1} = I - W/2 + coef * W^2
    coef = torch.where(small, recip32(12.0) + th2_taylor * recip32(720.0),
                       (1.0 - (th * torch.cos(th * 0.5))
                        / torch.where(small, 1.0, 2.0 * torch.sin(th * 0.5)))
                       / torch.where(small, 1.0, th2))
    Vinv = torch.eye(3, dtype=T.dtype, device=T.device) - 0.5 * W + coef * W2
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor          # (N, 4, 4) optimized camera->world
    residual_rmse: torch.Tensor  # final edge residual RMSE (se3 norm)
    initial_rmse: torch.Tensor


def optimize_pose_graph(poses: torch.Tensor, edges_i: torch.Tensor,
                        edges_j: torch.Tensor, edges_z: torch.Tensor,
                        weights: torch.Tensor, num_iters: int = 12,
                        damping: float = 1e-4,
                        anchor_weight: float = 1e3) -> PoseGraphResult:
    """Gauss-Newton pose-graph solve.

    poses: (N, 4, 4) initial camera->world transforms T_k. edges_*: (E,)
    endpoints, edges_z (E, 4, 4) measured relative transforms
    Z_e ~= inv(T_i) @ T_j, weights (E,) (0 disables an edge). Node 0 is
    gauge-fixed by a strong prior. Residual per edge:
    log_se3(inv(Z) @ inv(T_i) @ T_j) with T_k <- T_k @ exp_se3(delta_k);
    each step solves the damped normal equations for all deltas jointly and
    keeps the best of {full step, quarter step, no step}."""
    N = poses.shape[0]
    E = edges_i.shape[0]
    f = torch.float64 if poses.dtype == torch.float64 else torch.float32
    dev = poses.device
    poses = poses.to(f)
    edges_z = edges_z.to(device=dev, dtype=f)
    ei = edges_i.to(device=dev, dtype=torch.long)
    ej = edges_j.to(device=dev, dtype=torch.long)
    weights = weights.to(device=dev, dtype=f)
    # a weight-0 edge may carry any (even singular) Z: invert identity
    live = (weights > 0)[:, None, None]
    eye4 = torch.eye(4, dtype=f, device=dev)
    z_inv = torch.linalg.inv(torch.where(live, edges_z, eye4))
    w_sqrt = torch.sqrt(torch.clamp(weights, min=0.0))
    n_live = torch.clamp((weights > 0).sum(), min=1)

    def residuals(deltas, T_all):
        T_pert = T_all @ exp_se3(deltas)                 # (N, 4, 4)
        rel = torch.linalg.inv(T_pert[ei]) @ T_pert[ej]
        r = log_se3(z_inv @ rel)                         # (E, 6)
        return (r * w_sqrt[:, None]).reshape(-1)         # (6E,)

    def rmse(T_all):
        r = residuals(torch.zeros((N, 6), dtype=f, device=dev), T_all)
        return torch.sqrt(torch.sum(r * r) / (6.0 * n_live))

    init_rmse = rmse(poses)
    zero = torch.zeros((N, 6), dtype=f, device=dev)
    # gauge fix: a strong-but-bounded prior on node 0's delta
    diag_prior = torch.cat([torch.full((6,), anchor_weight, dtype=f,
                                       device=dev),
                            torch.zeros((N - 1) * 6, dtype=f, device=dev)])
    jac = torch.func.jacfwd(residuals)
    T_all = poses
    for _ in range(num_iters):
        r = residuals(zero, T_all)                       # (6E,)
        J = jac(zero, T_all).reshape(6 * E, N * 6)
        JtJ = J.T @ J
        Jtr = J.T @ r
        # Levenberg-Marquardt scale-invariant damping on the diagonal
        A = JtJ + torch.diag(diag_prior + damping * torch.diagonal(JtJ)
                             + 1e-9)
        delta = -torch.linalg.solve_ex(A, Jtr)[0].reshape(N, 6)
        cur = rmse(T_all)
        T_full = T_all @ exp_se3(delta)
        T_quarter = T_all @ exp_se3(0.25 * delta)
        r_full = rmse(T_full)
        r_quarter = rmse(T_quarter)
        take_full = (r_full <= r_quarter) & (r_full < cur)
        take_quarter = (~take_full) & (r_quarter < cur)
        T_all = torch.where(take_full, T_full,
                            torch.where(take_quarter, T_quarter, T_all))
    return PoseGraphResult(T_all, rmse(T_all), init_rmse)
