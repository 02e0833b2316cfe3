"""The plain reference of the estimated-pose recon cell: frame-to-frame
point-to-plane ICP refinement of a capture's poses, and the cloud fused at
given poses.

Plain PyTorch and NumPy, in float32 with TF32 off, importing nothing of the
program. `refine_trajectory` follows this description of the refiner:

* each frame's points and normals come from its depth image, sampled every
  `stride` pixels: the camera-frame point of each pixel (a true division by
  the focal lengths), the normal as the normalised cross product of the
  differences to the next point right and the next point down, valid where
  0 < depth < 4 m, where both differences are shorter than 0.1 m, and off
  the last row and column (whose differences wrap around);
* each consecutive pair (i - 1, i): frame i's points moved by the prior
  relative transform E_{i-1} E_i^-1 (rounded to float32), then registered
  onto frame i - 1 by point-to-plane ICP at each threshold in turn, each
  stage starting from the last one's transform;
* one ICP iteration: the nearest valid destination of every source point
  (brute force, the lowest index on ties), inliers nearer than the
  threshold, one Gauss-Newton step on the plane residuals
  ((p - q) . n, Jacobian [p x n, n]) with relative damping
  1e-3 tr(A) / 6 + 1e-9, the step clamped to 0.15 (radians and metres),
  the small-angle rotation re-orthonormalised by its SVD; the iterations
  stop at `max_iterations` or, from the third on, when neither fitness nor
  inlier RMSE moved by more than its relative criterion (Open3D's rule);
  when the last fitness is below 0.05 the iterate of least RMSE is kept;
* a correction turning more than `trust_rotation_rad` or moving more than
  `trust_translation_m` is dropped (the prior stands), and the chain is
  composed in float64 on the host with frame 0 as its anchor.

The nearest-neighbour search is exhaustive over the destination, with no
windows and no kernels. Both clouds are stably sorted on the axis of the
destination's widest extent (the source by its coordinate at the stage's
starting transform) before each stage, as the program orders them, so that
ties between equidistant neighbours break alike and sums run in the same
order.

`dtype` stores the clouds and normals in another type: the control runs
them in bfloat16, the step below the float32 the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import recon

GRADIENT_GATE_M = 0.1
MAX_DEPTH_M = 4.0
STEP_CLAMP = 0.15
FALLBACK_FITNESS = 0.05
BIG = 3.0e38
PAIRS_PER_STEP = 1 << 27     # (source, destination) pairs a search step


def settings_from_config(cfg: dict) -> dict:
    """The refiner's settings from a configuration's `refine_settings`."""
    s = cfg["refine_settings"]
    return {"thresholds": tuple(s["thresholds_m"]), "stride": s["stride"],
            "max_iterations": s["max_iterations"],
            "trust_translation": s["trust_translation_m"],
            "trust_rot": s["trust_rotation_rad"],
            "relative_fitness": s["relative_fitness"],
            "relative_rmse": s["relative_rmse"]}


def frame_points_normals(depth: torch.Tensor, intr, stride: int):
    """(points (P, 3), normals (P, 3), valid (P,)) of one depth frame."""
    d = depth[::stride, ::stride]
    H, W = d.shape
    dev = d.device
    f32 = torch.float32
    u = (torch.arange(W, device=dev) * stride).to(f32)
    v = (torch.arange(H, device=dev) * stride).to(f32)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    fx = torch.tensor(intr.fx, dtype=f32, device=dev)
    fy = torch.tensor(intr.fy, dtype=f32, device=dev)
    P = torch.stack([(uu - intr.cx) / fx * d, (vv - intr.cy) / fy * d, d],
                    dim=-1)
    right = torch.roll(P, -1, dims=1) - P
    down = torch.roll(P, -1, dims=0) - P
    n = torch.linalg.cross(right, down, dim=-1)
    length = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.where(length > 1e-12, length, 1.0)
    valid = ((d > 0) & (d < MAX_DEPTH_M)
             & (torch.linalg.norm(right, dim=-1) < GRADIENT_GATE_M)
             & (torch.linalg.norm(down, dim=-1) < GRADIENT_GATE_M))
    valid[-1, :] = False
    valid[:, -1] = False
    return P.reshape(-1, 3), n.reshape(-1, 3), valid.reshape(-1)


def nearest(src: torch.Tensor, dst: torch.Tensor):
    """(distance, index) of each source point's nearest destination by
    exhaustive search: d^2 = (dx dx + dy dy) + dz dz, each operation
    rounded once, the lowest index among equal d^2, then the distance
    recomputed from the winning pair."""
    n, m = src.shape[0], dst.shape[0]
    step = max(1, PAIRS_PER_STEP // max(m, 1))
    best = [torch.empty(0, dtype=torch.int64, device=src.device)]
    for s in range(0, n, step):
        a = src[s:s + step]
        d2 = a[:, None, 0] - dst[None, :, 0]
        d2.mul_(d2)
        for k in (1, 2):
            t = a[:, None, k] - dst[None, :, k]
            d2.add_(t.mul_(t))
            del t
        best.append(torch.argmin(d2, dim=1))
        del d2
    bi = torch.cat(best)
    diff = src - dst[bi]
    return torch.sqrt(torch.sum(diff * diff, dim=-1)), bi


def _metrics(src, dst, smask, dmask, threshold, T):
    """Source moved by T: (correspondence index, inlier mask, fitness,
    inlier RMSE). Only valid source points are searched, and only over the
    valid destinations (kept in order, so the lowest index still wins)."""
    p = src @ T[:3, :3].T + T[:3, 3]
    d = torch.zeros(src.shape[0], device=src.device)
    idx = torch.zeros(src.shape[0], dtype=torch.int64, device=src.device)
    rows = torch.nonzero(smask)[:, 0]
    cols = torch.nonzero(dmask)[:, 0]
    if len(cols):
        dv, iv = nearest(p[rows], dst[cols])
        d[rows] = dv
        idx[rows] = cols[iv]
    else:
        d[rows] = BIG ** 0.5
    inlier = smask & (d < threshold)
    nin = torch.sum(inlier)
    fitness = nin / torch.clamp(torch.sum(smask), min=1)
    rmse = torch.sqrt(torch.sum(torch.where(inlier, d * d, 0.0))
                      / torch.clamp(nin, min=1))
    return idx, inlier, fitness, rmse


def _homogeneous(R, t):
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def plane_step(p, q, nrm, w):
    """One damped, clamped point-to-plane Gauss-Newton step as a (4, 4)."""
    r = torch.sum((p - q) * nrm, dim=-1)
    J = torch.cat([torch.linalg.cross(p, nrm, dim=-1), nrm], dim=-1)
    Jw = J * w[:, None]
    A = Jw.T @ J
    A = A + (1e-3 * torch.trace(A) / 6.0 + 1e-9) * torch.eye(
        6, dtype=A.dtype, device=A.device)
    x = torch.linalg.solve(A, -(Jw.T @ r))
    rot = torch.linalg.norm(x[:3])
    tr = torch.linalg.norm(x[3:])
    lim = torch.full_like(rot, STEP_CLAMP)
    scale = torch.clamp(torch.minimum(lim / torch.clamp(rot, min=1e-9),
                                      lim / torch.clamp(tr, min=1e-9)),
                        max=1.0)
    x = x * scale
    one = torch.ones_like(x[0])
    R = torch.stack([torch.stack([one, -x[2], x[1]]),
                     torch.stack([x[2], one, -x[0]]),
                     torch.stack([-x[1], x[0], one])])
    U, _, Vh = torch.linalg.svd(R)
    Rn = U @ Vh
    Rn = Rn * torch.sign(torch.linalg.det(Rn))
    return _homogeneous(Rn, x[3:])


def icp_point_to_plane(src, dst, nrm, smask, dmask, threshold, init, st):
    """The transform (4, 4) registering src onto dst from `init`."""
    idx, inlier, fit, rmse = _metrics(src, dst, smask, dmask, threshold,
                                      init)
    T = init
    best_T, best_rmse = init, rmse
    prev_fit = prev_rmse = None
    it = 0
    while it < st["max_iterations"]:
        if it >= 2 and not bool(
                (torch.abs(prev_fit - fit) > st["relative_fitness"])
                | (torch.abs(prev_rmse - rmse) > st["relative_rmse"])):
            break
        p = src @ T[:3, :3].T + T[:3, 3]
        T_new = plane_step(p, dst[idx], nrm[idx], inlier.to(torch.float32)) @ T
        prev_fit, prev_rmse = fit, rmse
        idx, inlier, fit, rmse = _metrics(src, dst, smask, dmask, threshold,
                                          T_new)
        T = T_new
        if bool(rmse < best_rmse):
            best_T, best_rmse = T, rmse
        it += 1
    return best_T if bool(fit < FALLBACK_FITNESS) else T


def register_pair(src, smask, dst, dnrm, dmask, st):
    """Annealed ICP of the (already moved) source onto frame i - 1's
    points: the correction (4, 4) float32."""
    axis = int(torch.argmax(dst.amax(dim=0) - dst.amin(dim=0)))
    od = torch.argsort(dst[:, axis], stable=True)
    dst, dnrm, dmask = dst[od], dnrm[od], dmask[od]
    T = torch.eye(4, dtype=torch.float32, device=src.device)
    for thr in st["thresholds"]:
        p0 = src @ T[:3, :3].T + T[:3, 3]
        os_ = torch.argsort(p0[:, axis], stable=True)
        T = icp_point_to_plane(src[os_], dst, dnrm, smask[os_], dmask, thr,
                               T, st)
    return T


def _invert(T: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def rotation_angle(R: np.ndarray) -> float:
    """The angle (rad) of rotation R, from its skew part and its trace."""
    s = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                              R[1, 0] - R[0, 1]])
    return float(np.arctan2(s, 0.5 * (np.trace(R) - 1.0)))


def refine_trajectory(cap, intr, st: dict, device, dtype=torch.float32):
    """(N, 4, 4) float32 refined world->camera extrinsics of a capture from
    its (prior) extrinsics, and the number of corrections dropped."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    depths = torch.as_tensor(cap.depths, dtype=torch.float32, device=device)
    ext = np.asarray(cap.extrinsics, np.float64)

    def frame(k):
        pts, nrm, valid = frame_points_normals(depths[k], intr, st["stride"])
        return (pts.to(dtype).to(torch.float32),
                nrm.to(dtype).to(torch.float32), valid)

    out = [ext[0]]
    dropped = 0
    prev = frame(0)
    for i in range(1, len(ext)):
        cur = frame(i)
        prior = ext[i - 1] @ _invert(ext[i])
        R = torch.as_tensor(prior[:3, :3].T.astype(np.float32), device=device)
        t = torch.as_tensor(prior[:3, 3].astype(np.float32), device=device)
        dT = register_pair(cur[0] @ R + t, cur[2], prev[0], prev[1], prev[2],
                           st).cpu().numpy().astype(np.float64)
        if (rotation_angle(dT[:3, :3]) > st["trust_rot"]
                or np.linalg.norm(dT[:3, 3]) > st["trust_translation"]):
            dT = np.eye(4)
            dropped += 1
        out.append(_invert(dT @ prior) @ out[-1])
        prev = cur
    return np.stack(out).astype(np.float32), dropped


def pose_gaps(ext_a, ext_b) -> dict:
    """The largest camera-centre gap (m) and relative rotation angle (rad)
    between two (N, 4, 4) world->camera trajectories."""
    gm, gr = 0.0, 0.0
    for a, b in zip(np.asarray(ext_a, np.float64),
                    np.asarray(ext_b, np.float64)):
        ca = -a[:3, :3].T @ a[:3, 3]
        cb = -b[:3, :3].T @ b[:3, 3]
        gm = max(gm, float(np.linalg.norm(ca - cb)))
        gr = max(gr, rotation_angle(a[:3, :3] @ b[:3, :3].T))
    return {"pose_gap_m": gm, "pose_gap_rad": gr}


def fused_cloud(cap, extrinsics, intr, params, draws, device,
                dtype=torch.float32) -> dict:
    """The cloud of a capture fused at `extrinsics` in a volume auto-sized
    from the capture's own (prior) extrinsics, as reference/recon.py
    computes it: extraction, resampling with `draws`, floor filter."""
    params = recon.auto_volume_config(cap, intr, params)
    f32 = torch.float32
    depths = torch.as_tensor(cap.depths, dtype=f32, device=device)
    colors = torch.as_tensor(cap.colors, dtype=f32, device=device)
    exts = torch.as_tensor(np.asarray(extrinsics, np.float32), dtype=f32,
                           device=device)
    vol = recon.fuse(recon.make_block_volume(params.tsdf, device, dtype),
                     depths, colors, exts, intr)
    del depths, colors
    pts, cols, mask, nrm = recon.extract_surface_points_sparse(
        vol, capacity=2_000_000, with_normals=True)
    raw = int(mask.sum())
    s_pts, s_cols, s_nrm = recon.resample_points(
        pts, mask, params.surface_samples, colors=cols, normals=nrm,
        draws=draws)
    p = s_pts.float().cpu().numpy()
    c = s_cols.float().cpu().numpy()
    n = s_nrm.float().cpu().numpy()
    keep = p[:, 2] >= params.z_filter_threshold
    return {"points": p[keep], "colors": c[keep], "normals": n[keep],
            "raw_surface_count": raw, "dims": params.tsdf.dims}
