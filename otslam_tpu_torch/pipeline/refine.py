"""Pose refinement before fusion (counterpart of
otslam_tpu/pipeline/refine.py).

Capture poses come from odometry/TF and drift. Three refiners correct them:

* ``refine_trajectory``      — frame-to-frame point-to-plane ICP, chained;
* ``refine_trajectory_f2m``  — frame-to-model tracking against the TSDF
  fused so far (kernels/track.py);
* ``refine_trajectory_pgo``  — a tracked chain plus verified loop-closure
  edges, jointly optimized (kernels/pose_graph.py).

The ICP and pose-graph refiners estimate poses in `_icp_poses` and
`_pgo_poses` (reconstruct.REFINERS), from frames given as arrays or as
tensors on `device`; their public functions upload the frames once, call
them and fuse at the poses. The pose chain stays in host float64, as in the
JAX package, with one small host fetch per registered pair or tracked
frame. Every fusion passes `max_active` to
the block-sparse path (the JAX package's fixed 2048-block capacity per
frame, which the port keeps on purpose: frame-to-model tracking runs
against the model fused under that cap).

A pair's annealed ICP runs on the card with fused kernels, its iteration
replayed from a CUDA graph captured at the pair's first step
(kernels/icp.py icp_plane_annealed; on the CPU its plain version, the host
loop of icp_point_to_plane at each threshold), and its pose, fitness and
RMSE come home in one copy.

Every host wait here is counted in ``syncs`` (utils/profiling.py), with the
counters ``icp.pairs`` (frame pairs registered by ICP) and
``refine.fallbacks`` (corrections the trust region rejected); the rows of
each pair's windowed scans, tallied on the device, come home in the pose
fetch's copy and go to ``nn.window_pairs`` and ``nn.window_scans``
(kernels/nn.py). The frame-to-model tracker counts ``track.frames`` and
``track.iterations`` (its Gauss-Newton iterations, a fixed number a
frame); the pose graph counts ``pgo.loop_candidates`` (frame pairs near
enough to verify), ``pgo.loop_edges`` (those verified), ``pgo.edges``
(chain and loop edges solved) and ``pgo.iterations``. Under a recorder,
the refiners keep the spans

    refine.upload   the frames to the device (or reconstruct_frames' upload)
    refine.frames   points and normals from each frame's depth gradients
    refine.window   the host fetch of a pair's clouds and auto_nn_window
    refine.icp      one pair's annealed ICP
    refine.chain    the pose fetch, the trust region and the host compose
    refine.track    f2m: one frame's tracking solve, to its pose fetch
    refine.model    f2m: one frame fused into the tracking model (frame 0's
                    with the model's allocation), ending in a drain
    refine.loops    pgo: the loop candidates' search and verification
    refine.graph    pgo: the edges' upload, the solve and the poses' copy
    refine.fuse     the public functions' fusion at the refined poses
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from otslam_tpu_torch.config import ReconstructionConfig
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.core.se3 import invert_se3
from otslam_tpu_torch.device import resolve_device, to_device, to_f32, to_host
from otslam_tpu_torch.kernels.icp import (icp_plane_annealed,
                                          icp_point_to_plane)
from otslam_tpu_torch.kernels.nn import auto_nn_window, window_tally
from otslam_tpu_torch.kernels.pose_graph import optimize_pose_graph
from otslam_tpu_torch.kernels.track import track_frame_to_tsdf
from otslam_tpu_torch.kernels.tsdf_block import (integrate_frames_sparse,
                                                 make_block_volume)
from otslam_tpu_torch.utils.profiling import count, drain, span, waited


PAIR_ICP_ITERATIONS = 15    # a frame pair's ICP iterations at each threshold
PAIR_THRESHOLDS = (0.1, 0.05, 0.02)   # a pair's annealed ICP thresholds (m)
PAIR_TRUST = 0.15       # the ICP chain's trust region (m, and rad)
STRIDE, MAX_ACTIVE = 4, 2048    # the points' pixel stride; a frame's blocks
LOOP_MIN_GAP, LOOP_RADIUS, LOOP_MAX_PAIRS = 8, 0.8, 6   # loop closures
PGO_ITERATIONS, PGO_FRONT_END = 12, "f2m"               # the pose graph


@dataclass
class RefineResult:
    extrinsics: np.ndarray               # (N, 4, 4) corrected world->camera
    volume: object                       # BlockTSDFVolume, None: poses only
    fitness: List[float] = field(default_factory=list)
    rmse: List[float] = field(default_factory=list)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true division on every device (the JAX package divides
    eagerly here; PyTorch's CUDA division by a Python scalar multiplies by
    its reciprocal instead)."""
    return x / to_device(c, x.device, x.dtype)


def _pixel_grid(depth: torch.Tensor, intr: PinholeIntrinsics, stride: int):
    """Strided depth (H', W') and the camera-frame points (H', W', 3)."""
    d = depth[::stride, ::stride]
    H, W = d.shape
    us = (torch.arange(W, device=d.device) * stride).to(torch.float32)
    vs = (torch.arange(H, device=d.device) * stride).to(torch.float32)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    P = torch.stack([_div(uu - intr.cx, intr.fx) * d,
                     _div(vv - intr.cy, intr.fy) * d, d], -1)
    return d, P


def _frame_points(depth, intr: PinholeIntrinsics, stride: int = 4,
                  max_points: int = 8192, max_depth: float = 4.0):
    """Subsampled camera-frame points of a depth frame (H, W) tensor:
    (points (P, 3), mask (P,))."""
    d, P = _pixel_grid(depth, intr, stride)
    pts = P.reshape(-1, 3)
    mask = ((d > 0) & (d < max_depth)).reshape(-1)
    if pts.shape[0] > max_points:
        # uniform every-kth subsample of the flattened strided grid: keeps
        # whole-image support (a [:max_points] cut keeps only the top rows)
        step = -(-pts.shape[0] // max_points)
        pts = pts[::step]
        mask = mask[::step]
    return pts, mask


def _frame_points_normals(depth, intr: PinholeIntrinsics, stride: int = 4,
                          max_depth: float = 4.0):
    """Camera-frame points + normals from depth-image gradients:
    normal = normalize(cross(dP/du, dP/dv)), invalid across depth
    discontinuities (a gradient gate) and on the wrap-around border."""
    d, P = _pixel_grid(depth, intr, stride)
    du = torch.roll(P, -1, dims=1) - P
    dv = torch.roll(P, -1, dims=0) - P
    n = torch.linalg.cross(du, dv, dim=-1)
    ln = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.where(ln > 1e-12, ln, 1.0)
    smooth = ((torch.linalg.norm(du, dim=-1) < 0.1)
              & (torch.linalg.norm(dv, dim=-1) < 0.1))
    valid = (d > 0) & (d < max_depth) & smooth
    border = torch.zeros_like(valid)
    border[-1, :] = True
    border[:, -1] = True
    valid = valid & ~border
    return P.reshape(-1, 3), n.reshape(-1, 3), valid.reshape(-1)


def _pair_nn_window(pts_a, pts_b, radius) -> tuple[int, int]:
    """(nn_window, nn_axis) for frame-pair ICP, sized from the concrete
    clouds (invalid rows included: they sort into the window too) and
    rounded to a multiple of 2, as the JAX package does. One host fetch of
    each cloud."""
    return auto_nn_window(to_host(pts_a), to_host(pts_b), radius,
                          round_to=2)


def _annealed_icp(src, pts_i, nrm_i, valid_i, valid_j, thresholds,
                  window: tuple[int, int]):
    """Point-to-plane ICP of src onto frame i, re-solved at each threshold
    from the previous stage's pose, with the (nn_window, nn_axis) given:
    on the card icp_plane_annealed's fused kernels, on the CPU their plain
    version. Returns the last stage's ICPResult."""
    if src.device.type == "cpu":
        return _annealed_icp_plain(src, pts_i, nrm_i, valid_i, valid_j,
                                   thresholds, window)
    nn_w, nn_ax = window
    return icp_plane_annealed(src, pts_i, nrm_i, thresholds,
                              src_mask=valid_j, dst_mask=valid_i,
                              max_iterations=PAIR_ICP_ITERATIONS,
                              nn_window=nn_w, nn_axis=nn_ax)


def _annealed_icp_plain(src, pts_i, nrm_i, valid_i, valid_j, thresholds,
                        window: tuple[int, int]):
    """The plain version of _annealed_icp: icp_point_to_plane's host loop
    at each threshold, chained. Returns the last ICPResult."""
    nn_w, nn_ax = window
    T_acc = torch.eye(4, dtype=torch.float32, device=src.device)
    res = None
    for thr in thresholds:
        res = icp_point_to_plane(src, pts_i, nrm_i, threshold=thr,
                                 init=T_acc, src_mask=valid_j,
                                 dst_mask=valid_i,
                                 max_iterations=PAIR_ICP_ITERATIONS,
                                 nn_window=nn_w, nn_axis=nn_ax)
        T_acc = res.transformation
    return res


def _moved(pts: torch.Tensor, T: np.ndarray) -> torch.Tensor:
    """pts moved by the host transform T (rounded to f32)."""
    R = to_device(T[:3, :3].T.astype(np.float32), pts.device)
    t = to_device(T[:3, 3].astype(np.float32), pts.device)
    return pts @ R + t


def _fetched(t: torch.Tensor) -> float:
    """A 0-dim tensor's value on the host (a host wait on the card)."""
    waited(t)
    return float(t)


def _pair_result(res, tally) -> tuple[np.ndarray, float, float]:
    """A pair's ICP transform (4, 4) as a host float64 array, its fitness
    and inlier RMSE, in one copy. The rows of the windowed scans in `tally`
    (nn.window_tally), summed on the device, come home in the same copy
    and are folded into its counters."""
    parts = [res.transformation.reshape(-1), res.fitness.reshape(1),
             res.inlier_rmse.reshape(1)]
    pairs = tally.pairs()
    if pairs is not None:
        parts.append(pairs.reshape(1))
    host = to_host(torch.cat([t.to(torch.float64) for t in parts]))
    if pairs is not None:
        tally.fold(int(host[18]))
    return host[:16].reshape(4, 4), float(host[16]), float(host[17])


def _outside_trust(dT: np.ndarray, trust_rot: float,
                   trust_translation: float) -> bool:
    """True, and counted in ``refine.fallbacks``, when the correction dT
    turns by more than trust_rot or moves by more than trust_translation."""
    out = bool(_rotation_angle(dT[:3, :3]) > trust_rot
               or np.linalg.norm(dT[:3, 3]) > trust_translation)
    if out:
        count("refine.fallbacks")
    return out


def _rotation_angle(R: np.ndarray):
    """Rotation angle of R (rad), in R's own float type."""
    return np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))


def _refined(estimate, depths, colors, extrinsics, intr, cfg, max_active,
             device, *settings) -> RefineResult:
    """The public refiners: the frames uploaded to `device`, `estimate`'s
    poses from them, and the frames fused at those poses (max_active)."""
    dev = resolve_device(device)
    with span("refine.upload"):
        depths, colors = to_f32(depths, dev), to_f32(colors, dev)
    res = estimate(depths, colors, extrinsics, intr, cfg, *settings, device=dev)
    with span("refine.fuse"):
        res.volume = integrate_frames_sparse(
            make_block_volume(cfg.tsdf, dev), depths, colors,
            to_f32(res.extrinsics, dev), intr, max_active=max_active)
    return res


def refine_trajectory(depths, colors, extrinsics, intr: PinholeIntrinsics,
                      cfg: ReconstructionConfig, max_active: int = MAX_ACTIVE,
                      thresholds=PAIR_THRESHOLDS, stride: int = STRIDE,
                      trust_translation: float = PAIR_TRUST,
                      trust_rot: float = PAIR_TRUST,
                      device="cuda") -> RefineResult:
    """Frame-to-frame point-to-plane tracking, then fusion with the
    corrected poses.

    Each frame registers against its predecessor with normals from the
    predecessor's depth gradients; the threshold anneals coarse-to-fine.
    Relative corrections compose along the chain; frame 0 anchors it. A
    correction beyond the trust region keeps the odometry prior.

    depths (N,H,W) f32 meters and colors (N,H,W,3) [0,255] as arrays or
    tensors, extrinsics (N,4,4) world->camera priors as a host array; the
    work runs on `device`."""
    return _refined(_icp_poses, depths, colors, extrinsics, intr, cfg,
                    max_active, device, thresholds, stride,
                    trust_translation, trust_rot)


def _icp_poses(depths, colors, extrinsics, intr, cfg,
               thresholds=PAIR_THRESHOLDS, stride=STRIDE,
               trust_translation=PAIR_TRUST, trust_rot=PAIR_TRUST,
               device="cuda") -> RefineResult:
    """refine_trajectory's poses, no volume; colors and cfg go unused."""
    depths_t = to_f32(depths, resolve_device(device))
    ext = np.asarray(extrinsics, np.float64)
    n = depths_t.shape[0]
    out_ext = [ext[0]]
    fitness, rmses = [], []

    with span("refine.frames"):
        prev_pts, prev_nrm, prev_valid = _frame_points_normals(
            depths_t[0], intr, stride)
    for i in range(1, n):
        with span("refine.frames"):
            cur_pts, cur_nrm, cur_valid = _frame_points_normals(
                depths_t[i], intr, stride)
        with span("refine.window"):
            # per-pair window, sized at the widest annealing threshold
            window = _pair_nn_window(cur_pts, prev_pts, max(thresholds))
        # prior relative transform camera_i -> camera_{i-1}
        Tr_prior = ext[i - 1] @ invert_se3(ext[i])
        with span("refine.icp"), window_tally() as tally:
            res = _annealed_icp(_moved(cur_pts, Tr_prior), prev_pts,
                                prev_nrm, prev_valid, cur_valid, thresholds,
                                window)
        count("icp.pairs")
        with span("refine.chain"):
            dT, fit, rmse = _pair_result(res, tally)
            # trust region around the odometry prior: low-overlap pairs can
            # score a wrong pose higher (density sliding)
            if _outside_trust(dT, trust_rot, trust_translation):
                dT = np.eye(4)
            # E_i = Tr^{-1} E_{i-1}, chained through the corrected
            # predecessor
            out_ext.append(invert_se3(dT @ Tr_prior) @ out_ext[-1])
            fitness.append(fit)
            rmses.append(rmse)
        prev_pts, prev_nrm, prev_valid = cur_pts, cur_nrm, cur_valid

    return RefineResult(np.stack(out_ext).astype(np.float32), None, fitness,
                        rmses)


def refine_trajectory_f2m(depths, colors, extrinsics, intr: PinholeIntrinsics,
                          cfg: ReconstructionConfig, max_active: int = 2048,
                          stride: int = 4, max_iterations: int = 15,
                          trust_translation: float = 0.2,
                          trust_rot: float = 0.2,
                          device="cuda") -> RefineResult:
    """Frame-to-model tracking: each frame's pose is solved by Gauss-Newton
    on the signed distance field fused so far (kernels/track.py), then the
    frame fuses at the corrected pose, so per-frame errors do not compound
    along the chain. The frame's odometry increment (not its absolute
    pose) seeds the solve. Same I/O contract as refine_trajectory."""
    dev = resolve_device(device)
    depths_t, colors_t = to_f32(depths, dev), to_f32(colors, dev)
    ext = np.asarray(extrinsics, np.float64)
    n = depths_t.shape[0]
    out_ext = [ext[0]]
    fitness, rmses = [], []

    with span("refine.model"):
        vol = integrate_frames_sparse(make_block_volume(cfg.tsdf, dev),
                                      depths_t[:1], colors_t[:1],
                                      to_f32(extrinsics[:1], dev), intr,
                                      max_active=max_active)
        drain(dev)
    for i in range(1, n):
        with span("refine.track"):
            # odometry increment composed onto the corrected predecessor
            E_prior = (ext[i] @ invert_se3(ext[i - 1])) @ out_ext[-1]
            pts, mask = _frame_points(depths_t[i], intr, stride)
            res = track_frame_to_tsdf(vol, pts, mask,
                                      to_f32(invert_se3(E_prior), dev),
                                      max_iterations=max_iterations)
            count("track.frames")
            count("track.iterations", max_iterations)
            T = to_host(res.transformation).astype(np.float64)
            dT = T @ E_prior                    # camera->world correction
            if _outside_trust(dT, trust_rot, trust_translation):
                corrected = E_prior
            else:
                corrected = invert_se3(T)
            out_ext.append(corrected)
            fitness.append(_fetched(res.inlier_fraction))
            rmses.append(_fetched(res.rmse))
        with span("refine.model"):
            vol = integrate_frames_sparse(vol, depths_t[i:i + 1],
                                          colors_t[i:i + 1],
                                          to_f32(corrected[None], dev), intr,
                                          max_active=max_active)
            drain(dev)

    return RefineResult(np.stack(out_ext).astype(np.float32), vol, fitness,
                        rmses)


def _register_pair(pts_i, nrm_i, valid_i, pts_j, valid_j, prior_rel,
                   thresholds=PAIR_THRESHOLDS):
    """Annealed point-to-plane registration of frame j onto frame i.

    pts/nrm are camera-frame tensors from _frame_points_normals; prior_rel
    is the prior camera_j -> camera_i transform. Returns (M, fitness,
    rmse) with M the measured camera_j -> camera_i transform."""
    src = _moved(pts_j, prior_rel)
    window = _pair_nn_window(src, pts_i, max(thresholds))
    with window_tally() as tally:
        res = _annealed_icp(src, pts_i, nrm_i, valid_i, valid_j, thresholds,
                            window)
    count("icp.pairs")
    dT, fit, rmse = _pair_result(res, tally)
    return dT @ np.asarray(prior_rel, np.float64), fit, rmse


def detect_loop_closures(depths, extrinsics, intr: PinholeIntrinsics,
                         stride: int = STRIDE, min_gap: int = LOOP_MIN_GAP,
                         radius: float = LOOP_RADIUS,
                         max_pairs: int = LOOP_MAX_PAIRS,
                         min_fitness: float = 0.5, device="cuda"):
    """Propose + verify loop-closure edges over a trajectory.

    Candidates: frame pairs (i, j) with |i - j| >= min_gap whose estimated
    camera centers lie within `radius`; each is verified by annealed
    point-to-plane ICP and kept if its fitness reaches min_fitness.
    Longest loops first (then closest centers), each frame in at most one
    edge, at most max_pairs edges. Returns [(i, j, Z, fitness)] with Z the
    measured camera_j -> camera_i transform."""
    dev = resolve_device(device)
    depths_t = to_f32(depths, dev)
    n = depths_t.shape[0]
    ext = np.asarray(extrinsics, np.float64)
    centers = np.stack([invert_se3(e)[:3, 3] for e in ext])
    cand = []
    for i in range(n):
        for j in range(i + min_gap, n):
            d = np.linalg.norm(centers[i] - centers[j])
            if d < radius:
                cand.append((j - i, d, i, j))
    cand.sort(key=lambda c: (-c[0], c[1]))
    count("pgo.loop_candidates", len(cand))
    used = set()
    edges = []
    cache = {}

    def frame(k):
        if k not in cache:
            cache[k] = _frame_points_normals(depths_t[k], intr, stride)
        return cache[k]

    for _, _, i, j in cand:
        if len(edges) >= max_pairs:
            break
        if i in used or j in used:
            continue
        pi, ni, vi = frame(i)
        pj, _, vj = frame(j)
        M, fit, _ = _register_pair(pi, ni, vi, pj, vj,
                                   ext[i] @ invert_se3(ext[j]))
        if fit >= min_fitness:
            edges.append((i, j, M, fit))
            used.add(i)
            used.add(j)
    count("pgo.loop_edges", len(edges))
    return edges


def refine_trajectory_pgo(depths, colors, extrinsics, intr: PinholeIntrinsics,
                          cfg: ReconstructionConfig,
                          max_active: int = MAX_ACTIVE, stride: int = STRIDE,
                          min_gap: int = LOOP_MIN_GAP,
                          loop_radius: float = LOOP_RADIUS,
                          max_loop_pairs: int = LOOP_MAX_PAIRS,
                          num_iters: int = PGO_ITERATIONS,
                          front_end: str = PGO_FRONT_END,
                          device="cuda") -> RefineResult:
    """Pose-graph refinement: a tracked odometry chain plus loop-closure
    edges, jointly optimized with Gauss-Newton, then fused.

    front_end selects the chain tracker: "f2m" (direct TSDF tracking, the
    default) or "icp" (frame-to-frame point-to-plane pairs). Chain edges
    weigh 1, loop edges 2."""
    return _refined(_pgo_poses, depths, colors, extrinsics, intr, cfg,
                    max_active, device, max_active, stride, min_gap,
                    loop_radius, max_loop_pairs, num_iters, front_end)


def _pgo_poses(depths, colors, extrinsics, intr, cfg, max_active=MAX_ACTIVE,
               stride=STRIDE, min_gap=LOOP_MIN_GAP, loop_radius=LOOP_RADIUS,
               max_loop_pairs=LOOP_MAX_PAIRS, num_iters=PGO_ITERATIONS,
               front_end=PGO_FRONT_END, device="cuda") -> RefineResult:
    """refine_trajectory_pgo's poses, no volume."""
    dev = resolve_device(device)
    depths_t, colors_t = to_f32(depths, dev), to_f32(colors, dev)
    n = depths_t.shape[0]
    ei, ej, Zs, ws = [], [], [], []
    fitness, rmses = [], []

    if front_end == "f2m":
        fe = refine_trajectory_f2m(depths_t, colors_t, extrinsics, intr, cfg,
                                   max_active=max_active, stride=stride,
                                   device=dev)
        ext_chain = fe.extrinsics.astype(np.float64)
        fitness, rmses = fe.fitness, fe.rmse
        for i in range(n - 1):
            # Z_e = inv(T_i) @ T_j = E_i @ inv(E_j): camera_j -> camera_i
            ei.append(i)
            ej.append(i + 1)
            Zs.append(ext_chain[i] @ invert_se3(ext_chain[i + 1]))
            ws.append(1.0)
    elif front_end == "icp":
        ext = np.asarray(extrinsics, np.float64)
        frames = [_frame_points_normals(depths_t[k], intr, stride)
                  for k in range(n)]
        chain = [invert_se3(ext[0])]
        for i in range(n - 1):
            pi, ni, vi = frames[i]
            pj, _, vj = frames[i + 1]
            prior_rel = ext[i] @ invert_se3(ext[i + 1])
            M, fit, rmse = _register_pair(pi, ni, vi, pj, vj, prior_rel)
            # trust region: keep the odometry prior on failed registrations
            dT = M @ invert_se3(prior_rel)
            if _outside_trust(dT, 0.2, 0.2) or fit < 0.3:
                M = prior_rel
            ei.append(i)
            ej.append(i + 1)
            Zs.append(M)
            ws.append(1.0)
            fitness.append(fit)
            rmses.append(rmse)
            chain.append(chain[-1] @ M)
        ext_chain = np.stack([invert_se3(t) for t in chain])
    else:
        raise ValueError(f"unknown front_end {front_end!r}")

    with span("refine.loops"):
        loops = detect_loop_closures(depths_t, ext_chain, intr,
                                     stride=stride, min_gap=min_gap,
                                     radius=loop_radius,
                                     max_pairs=max_loop_pairs, device=dev)
    with span("refine.graph"):
        for i, j, M, _ in loops:
            ei.append(i)
            ej.append(j)
            Zs.append(M)
            ws.append(2.0)  # loop edges weigh more: they carry global truth

        poses0 = np.stack([invert_se3(e) for e in ext_chain]).astype(
            np.float32)
        res = optimize_pose_graph(
            to_f32(poses0, dev), to_device(ei, dev), to_device(ej, dev),
            to_f32(np.stack(Zs).astype(np.float32), dev),
            to_device(ws, dev, torch.float32), num_iters=num_iters)
        count("pgo.edges", len(ei))
        count("pgo.iterations", num_iters)
        T_opt = to_host(res.poses).astype(np.float64)
    ext_out = np.stack([invert_se3(t) for t in T_opt]).astype(np.float32)
    return RefineResult(ext_out, None, fitness, rmses)


def trajectory_error(ext_est, ext_gt):
    """(translation RMSE m, rotation RMSE rad) of camera poses given
    world->camera extrinsics (host numpy, as the JAX package's)."""
    t_err, r_err = [], []
    for a, b in zip(np.asarray(ext_est), np.asarray(ext_gt)):
        Ta = invert_se3(a)
        Tb = invert_se3(b)
        t_err.append(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]) ** 2)
        r_err.append(_rotation_angle(Ta[:3, :3].T @ Tb[:3, :3]) ** 2)
    return float(np.sqrt(np.mean(t_err))), float(np.sqrt(np.mean(r_err)))
