"""Iterative Closest Point registration (counterpart of
otslam_tpu/kernels/icp.py).

Mirrors Open3D ``registration_icp`` with ``TransformationEstimationPointToPoint``
as used by the eval scripts (eval_table_chair.py:90-104: threshold 0.05,
identity init, max 2000 iterations), plus a point-to-plane variant for pose
refinement.

Correspondences come from kernels/nn.py: the full scan (K3) or, with
nn_window > 0, the radius-limited windowed scan (K4). The JAX package's
``lax.while_loop`` becomes a host loop that evaluates the same condition
(Open3D's relative fitness / RMSE criteria), one host sync per iteration
from the third on; ``iterations`` equals the JAX package's. The 3x3 SVD
and the 6x6 solve stay on the clouds' device; ``torch.linalg.solve_ex``
adds no error-check sync, ``torch.linalg.svd`` of the 3x3 waits on the
card twice (`_svd`). Each of these host waits, and the upload of the
loop's first previous fitness, is counted in ``syncs``, and every call
adds its iterations to the process counter ``icp.iterations``
(utils/profiling.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from otslam_tpu_torch.device import to_device
from otslam_tpu_torch.kernels.nn import nn_distance, nn_distance_radius
from otslam_tpu_torch.kernels.pose_graph import _homogeneous
from otslam_tpu_torch.kernels.tsdf import recip32
from otslam_tpu_torch.utils.profiling import count, waited


class ICPResult(NamedTuple):
    transformation: torch.Tensor  # (4, 4) src -> dst
    fitness: torch.Tensor         # inlier fraction (0-dim)
    inlier_rmse: torch.Tensor     # (0-dim)
    iterations: int


def _svd(M: torch.Tensor):
    """torch.linalg.svd of a 3x3, whose CUDA path waits on the card twice;
    both waits are counted."""
    waited(M)
    waited(M)
    return torch.linalg.svd(M)


def _umeyama_rt(src_pts, dst_pts, weights):
    """Weighted rigid alignment (Kabsch/Umeyama, no scaling): R, t
    minimizing sum w |R p + t - q|^2. The rotation is unique whatever
    signs the SVD's singular vectors take."""
    wsum = torch.clamp(torch.sum(weights), min=1e-9)
    cp = torch.sum(src_pts * weights[:, None], dim=0) / wsum
    cq = torch.sum(dst_pts * weights[:, None], dim=0) / wsum
    sp = src_pts - cp
    sq = dst_pts - cq
    H = (sp * weights[:, None]).T @ sq                       # (3, 3)
    U, _, Vh = _svd(H)
    d = torch.sign(torch.linalg.det(Vh.T @ U.T))
    one = torch.ones_like(d)
    R = Vh.T @ torch.diag(torch.stack([one, one, d])) @ U.T
    t = cq - R @ cp
    return R, t


def _sorted_for_window(src, dst, smask, dmask, T0, nn_axis: int):
    """Sort dst (and src, by its initially-transformed coordinate) on the
    window axis, stably as jnp.argsort (invalid rows of a depth frame all
    back-project to the origin and tie). ICP's outputs are
    permutation-invariant up to float reassociation in its sums."""
    od = torch.argsort(dst[:, nn_axis], stable=True)
    dst = dst[od]
    dmask = None if dmask is None else dmask[od]
    p0 = src @ T0[:3, :3].T + T0[:3, 3]
    osrc = torch.argsort(p0[:, nn_axis], stable=True)
    return src[osrc], dst, smask[osrc], dmask, od


def _setup(src, dst, init, src_mask, dst_mask, nn_window, nn_axis):
    n = src.shape[0]
    smask = (torch.ones(n, dtype=torch.bool, device=src.device)
             if src_mask is None else src_mask.to(torch.bool))
    T0 = (torch.eye(4, dtype=torch.float32, device=src.device) if init is None
          else init.to(device=src.device, dtype=torch.float32))
    dmask = None if dst_mask is None else dst_mask.to(torch.bool)
    od = None
    if nn_window > 0:
        src, dst, smask, dmask, od = _sorted_for_window(
            src, dst, smask, dmask, T0, nn_axis)
    return src, dst, smask, dmask, T0, od


def _metrics_fn(src, dst, smask, dmask, threshold, nn_window, nn_axis):
    """T -> (p, idx, inlier, fitness, rmse) of src moved by T."""
    def nn(p):
        if nn_window > 0:
            return nn_distance_radius(p, dst, threshold, smask, dmask,
                                      window_chunks=nn_window, axis=nn_axis,
                                      with_index=True)
        return nn_distance(p, dst, smask, dmask, with_index=True)

    def metrics(T):
        p = src @ T[:3, :3].T + T[:3, 3]
        d, idx = nn(p)
        inlier = smask & (d < threshold)
        nin = torch.sum(inlier)
        fitness = nin / torch.clamp(torch.sum(smask), min=1)
        rmse = torch.sqrt(torch.sum(torch.where(inlier, d * d, 0.0))
                          / torch.clamp(nin, min=1))
        return p, idx, inlier, fitness, rmse
    return metrics


def _keep_going(it, max_iterations, fit, rmse, prev_fit, prev_rmse,
                relative_fitness, relative_rmse) -> bool:
    """The JAX while_loop's cond; syncs only from the third iteration."""
    if it >= max_iterations:
        return False
    if it < 2:
        return True
    keep = ((torch.abs(prev_fit - fit) > relative_fitness)
            | (torch.abs(prev_rmse - rmse) > relative_rmse))
    waited(keep)
    return bool(keep)


def icp_point_to_point(src: torch.Tensor, dst: torch.Tensor,
                       threshold: float = 0.05,
                       init: torch.Tensor | None = None,
                       src_mask: torch.Tensor | None = None,
                       dst_mask: torch.Tensor | None = None,
                       max_iterations: int = 30,
                       relative_fitness: float = 1e-6,
                       relative_rmse: float = 1e-6,
                       nn_window: int = 0, nn_axis: int = 2) -> ICPResult:
    """Point-to-point ICP aligning src onto dst (both on one device).

    nn_window > 0 takes the radius-limited windowed NN (nn_distance_radius,
    K4): both clouds are sorted once on coordinate nn_axis and each
    iteration's correspondence search scans only the destination chunks
    near each source tile; exact for every inlier (the radius is the
    inlier threshold). Size it with auto_nn_window."""
    src, dst, smask, dmask, T0, _ = _setup(src, dst, init, src_mask,
                                           dst_mask, nn_window, nn_axis)
    metrics = _metrics_fn(src, dst, smask, dmask, threshold, nn_window,
                          nn_axis)
    T = T0
    _, idx, inlier, fit, rmse = metrics(T)
    prev_fit = prev_rmse = to_device(-1.0, src.device, torch.float32)
    it = 0
    while _keep_going(it, max_iterations, fit, rmse, prev_fit, prev_rmse,
                      relative_fitness, relative_rmse):
        # one NN pass per iteration: solve with the carried correspondences,
        # then evaluate the new pose (whose correspondences carry forward)
        p = src @ T[:3, :3].T + T[:3, 3]
        R, t = _umeyama_rt(p, dst[idx], inlier.to(torch.float32))
        T_new = _homogeneous(R, t) @ T
        prev_fit, prev_rmse = fit, rmse
        _, idx, inlier, fit, rmse = metrics(T_new)
        T = T_new
        it += 1
    count("icp.iterations", it)
    return ICPResult(T, fit, rmse, it)


def _plane_step(p, q, nrm, w):
    """One damped, clamped point-to-plane Gauss-Newton step as a (4, 4)."""
    r = torch.sum((p - q) * nrm, dim=-1)              # signed plane residual
    c = torch.linalg.cross(p, nrm, dim=-1)            # rotation jacobian
    J = torch.cat([c, nrm], dim=-1)                   # (N, 6)
    Jw = J * w[:, None]
    A = Jw.T @ J
    # relative Tikhonov damping: under-constrained motion modes yield ~zero
    # step instead of a noise-driven walk
    eye6 = torch.eye(6, dtype=A.dtype, device=A.device)
    A = A + (1e-3 * torch.trace(A) * recip32(6.0) + 1e-9) * eye6
    b = -(Jw.T @ r)
    x = torch.linalg.solve_ex(A, b)[0]                # (wx, wy, wz, t)
    # clamp the step: the linearization holds only for small motions
    rot_n = torch.linalg.norm(x[:3])
    tr_n = torch.linalg.norm(x[3:])
    lim = torch.full_like(rot_n, 0.15)
    scale = torch.clamp(torch.minimum(
        lim / torch.clamp(rot_n, min=1e-9), lim / torch.clamp(tr_n, min=1e-9)),
        max=1.0)
    x = x * scale
    wx, wy, wz = x[0], x[1], x[2]
    one = torch.ones_like(wx)
    R = torch.stack([torch.stack([one, -wz, wy]),
                     torch.stack([wz, one, -wx]),
                     torch.stack([-wy, wx, one])])
    # re-orthonormalize the small-angle rotation via SVD projection
    U, _, Vh = _svd(R)
    Rn = U @ Vh
    Rn = Rn * torch.sign(torch.linalg.det(Rn))
    return _homogeneous(Rn, x[3:])


def icp_point_to_plane(src: torch.Tensor, dst: torch.Tensor,
                       dst_normals: torch.Tensor,
                       threshold: float = 0.05,
                       init: torch.Tensor | None = None,
                       src_mask: torch.Tensor | None = None,
                       dst_mask: torch.Tensor | None = None,
                       max_iterations: int = 30,
                       relative_fitness: float = 1e-6,
                       relative_rmse: float = 1e-6,
                       nn_window: int = 0, nn_axis: int = 2) -> ICPResult:
    """Point-to-plane ICP (linearized small-angle 6x6 solve per iteration).

    nn_window: see icp_point_to_point, the same windowed-NN contract. The
    last iterate is returned unless it collapsed (fitness < 0.05); then the
    iterate of lowest inlier RMSE is."""
    src, dst, smask, dmask, T0, od = _setup(src, dst, init, src_mask,
                                            dst_mask, nn_window, nn_axis)
    if od is not None:
        dst_normals = dst_normals[od]
    metrics = _metrics_fn(src, dst, smask, dmask, threshold, nn_window,
                          nn_axis)
    T = T0
    _, idx, inlier, fit, rmse = metrics(T)
    best_T, best_fit, best_rmse = T0, fit, rmse
    prev_fit = prev_rmse = to_device(-1.0, src.device, torch.float32)
    it = 0
    while _keep_going(it, max_iterations, fit, rmse, prev_fit, prev_rmse,
                      relative_fitness, relative_rmse):
        p = src @ T[:3, :3].T + T[:3, 3]
        dT = _plane_step(p, dst[idx], dst_normals[idx],
                         inlier.to(torch.float32))
        T_new = dT @ T
        prev_fit, prev_rmse = fit, rmse
        _, idx, inlier, fit, rmse = metrics(T_new)
        T = T_new
        # fall-back tracking by inlier RMSE only: under partial overlap,
        # fitness can increase for wrong poses (density sliding)
        better = rmse < best_rmse
        best_T = torch.where(better, T, best_T)
        best_fit = torch.where(better, fit, best_fit)
        best_rmse = torch.where(better, rmse, best_rmse)
        it += 1
    count("icp.iterations", it)
    use_best = fit < 0.05
    return ICPResult(torch.where(use_best, best_T, T),
                     torch.where(use_best, best_fit, fit),
                     torch.where(use_best, best_rmse, rmse), it)
