"""The plain reference of the pose-graph recon cell: a capture's poses
refined as `reconstruct --refine pgo` refines them (a frame-to-model
tracked chain, verified loop closures, a pose-graph solve).

Plain PyTorch and NumPy, in float32 with TF32 off, importing nothing of the
program. `refine_trajectory` follows this description of the refiner:

* The tracked chain. A tracking model, a block TSDF volume of the object's
  geometry, holds frame 0 fused at its prior pose. For each later frame i:
  - its prior is the odometry increment composed onto the corrected
    predecessor, E'_i = (E_i E_{i-1}^-1) C_{i-1} (float64 on the host);
  - its camera-frame points are the depth's pixels at every `stride`-th
    row and column (true divisions by the focal lengths), valid where
    0 < depth < `max_depth_m`; where the grid holds more than
    `max_points`, every k-th is kept, k = ceil(P / max_points);
  - T, camera to world, starts at E'_i^-1 rounded to float32 and takes
    `max_iterations` Gauss-Newton steps. A step moves the points by T
    (q = p R^T + t) and reads the model at q by trilinear interpolation
    of the 8 surrounding voxel centres: the continuous voxel coordinate
    (q - origin) / voxel - 1/2 is formed exactly and rounded once to
    float32, and a point is valid only where all 8 corners lie in the grid
    and have been observed (weight > 0). The interpolated tsdf s and its
    analytic gradient g (per world metre) give the level-set residual
    r = s / max(|g|, 1e-9) and the normal n = g / max(|g|, 1e-9). A point
    weighs 1 where valid, inside the band (-0.95 < s < 0.95) and steep
    enough (|g| > 0.1 / sdf_trunc), times the Huber weight
    min(1, voxel / max(|r|, 1e-9)). With J = [q x n | n], the step solves
    (A + (1e-3 tr(A) / 6 + 1e-9) I) x = -J^T W r, A = J^T W J; x is scaled
    down so that neither its rotation nor its translation exceeds 0.1 (rad,
    m), and T <- exp(x) T with the se(3) exponential (Rodrigues; its series
    where the angle's square is below 1e-8);
  - with dT = T E'_i, a correction turning more than `trust_rotation_rad`
    or moving more than `trust_translation_m` keeps E'_i; otherwise
    C_i = T^-1;
  - the frame is fused into the model at C_i (float32) by
    reference/recon.py's fusion, each frame's active blocks cut to its
    `max_active` lowest block ids (creation takes the whole band).
* Loop search. Candidates are frame pairs (i, j), j - i >= `min_gap`,
  whose chain camera centres lie nearer than `loop_radius_m`, taken
  longest first, then closest. Each, while fewer than `max_loop_pairs`
  edges are kept and neither frame is in one yet, is verified by
  reference/refine.py's annealed pair ICP of frame j onto frame i from
  the chain's relative pose (`pair_thresholds_m`); it is kept where the
  last stage's fitness reaches `min_fitness`, as the measured relative
  transform M = dT (E_i E_j^-1).
* The pose graph. Nodes are the chain's camera-to-world poses (float32).
  Chain edges (i, i + 1) carry the chain's own relative transform and
  weigh `chain_weight`; loop edges carry M and weigh `loop_weight`. An
  edge's residual is sqrt(w) log(Z^-1 T_i^-1 T_j) under the right
  retraction T_k <- T_k exp(d_k). Each of `graph_iterations` Gauss-Newton
  steps solves (J^T J + diag(p + `graph_damping` diag(J^T J) + 1e-9)) d
  = -J^T r, with p = `anchor_weight` on node 0's six entries (the gauge),
  and keeps the full step, the quarter step or none, whichever leaves the
  smallest residual RMS (the full step where it ties the quarter), a step
  only where it lowers it. The Jacobian is forward-mode autograd's
  (torch.func.jacfwd) of the stacked residual; the inverses of the edges'
  transforms are torch.linalg.inv's, as any 4x4 inverse.

Departures, each to keep the rounding the program's (a frame-to-model
chain moves by 1e-4 to 1e-3 when one voxel lands across a .5-pixel
rounding tie, so the reference computes as the program does wherever the
description leaves an order free): the eight corners are summed in the
order (0,0,0), (0,0,1), ..., (1,1,1); a product of three weights is
((a b) c); divisions by a constant that the description writes as a
division are true divisions by a tensor of it, except the damping's 1/6,
taken as the float32 reciprocal of 6 as a product; the exponential's and
the pose graph's matrix products are 4x4 products. The tracker's own
fitness and RMSE are not computed: the judge reads poses.

`dtype` stores the tracking model and the frames' points in another type:
the control runs them in bfloat16, the step below the float32 the
configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import recon
from benchmark.reference import refine as pair
from benchmark.reference.recon import recip32
from benchmark.reference.refine import _invert

BAND = 0.95              # |s| below this stays in the tracker's band
EPS = 1e-9


def settings_from_config(cfg: dict) -> dict:
    """The refiner's settings from a configuration's `refine_settings`."""
    s = dict(cfg["refine_settings"])
    if s.pop("front_end") != "f2m":
        raise ValueError("the reference tracks frame to model only")
    return s


# ---------------------------------------------------------------------------
# se(3)
# ---------------------------------------------------------------------------

def _skew(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _rigid(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) of a rotation and a translation, with no in-place write
    (forward-mode autograd follows it)."""
    top = torch.cat([R, t[..., None]], -1)
    last = torch.zeros_like(top[..., :1, :])
    last = torch.cat([last[..., :3], torch.ones_like(last[..., 3:])], -1)
    return torch.cat([top, last], -2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) = (rotation vector, translation part) -> (..., 4, 4)."""
    w, v = xi[..., :3], xi[..., 3:]
    th2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    series = th2 < 1e-8
    th2_safe = torch.where(series, 1.0, th2)
    th = torch.sqrt(th2_safe)
    K = _skew(w)
    K2 = K @ K
    a = torch.where(series, 1.0 - th2 * recip32(6.0), torch.sin(th) / th)
    b = torch.where(series, 0.5 - th2 * recip32(24.0),
                    (1.0 - torch.cos(th)) / th2_safe)
    c = torch.where(series, recip32(6.0) - th2 * recip32(120.0),
                    (th - torch.sin(th)) / (th2_safe * th))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * K + b * K2
    V = eye + b * K + c * K2
    return _rigid(R, (V @ v[..., None])[..., 0])


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6), for rotations below pi. Where the angle is
    below ~1.4e-3 (cos above 1 - 1e-6) the series stand in; every branch
    is guarded, so forward-mode autograd stays finite."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    tr = R[..., 0, 0:1] + R[..., 1, 1:2] + R[..., 2, 2:3]
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)[..., None]
    series = cos > 1.0 - 1e-6
    th = torch.arccos(torch.where(series, 0.0, cos))
    th2_series = 2.0 * (1.0 - cos)
    th2 = torch.where(series, th2_series, th * th)
    k = torch.where(series, 0.5 + th2_series * recip32(12.0),
                    th / (2.0 * torch.sin(th)))
    S = (R - R.transpose(-1, -2)) * k
    w = torch.stack([S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], -1)
    K = _skew(w)
    half_sin = torch.where(series, 1.0, 2.0 * torch.sin(th * 0.5))
    coef = torch.where(series, recip32(12.0) + th2_series * recip32(720.0),
                       (1.0 - th * torch.cos(th * 0.5) / half_sin)
                       / torch.where(series, 1.0, th2))
    Vinv = torch.eye(3, dtype=T.dtype, device=T.device) - 0.5 * K \
        + coef * (K @ K)
    return torch.cat([w, (Vinv @ t[..., None])[..., 0]], -1)


# ---------------------------------------------------------------------------
# the tracked chain
# ---------------------------------------------------------------------------

def frame_points(depth: torch.Tensor, intr, st: dict):
    """(points (P, 3), valid (P,)) of one depth frame for the tracker."""
    pts, _, _ = pair.frame_points_normals(depth, intr, st["stride"])
    d = depth[::st["stride"], ::st["stride"]].reshape(-1)
    valid = (d > 0) & (d < st["max_depth_m"])
    if pts.shape[0] > st["max_points"]:
        k = -(-pts.shape[0] // st["max_points"])
        pts, valid = pts[::k], valid[::k]
    return pts, valid


def trilinear(vol, q: torch.Tensor):
    """(s (P,), g (P, 3) per metre, valid (P,)) of the model at world
    points q."""
    bx, by, bz = vol.grid_blocks
    nb = bx * by * bz
    B = recon.BLOCK
    size = (bx * B, by * B, bz * B)
    dev = q.device
    inv_voxel = recip32(vol.voxel_size)
    origin = torch.tensor(vol.origin, dtype=torch.float32, device=dev)
    x = ((q - origin).double() * inv_voxel - 0.5).float()
    base = torch.floor(x).to(torch.int32)
    frac = x - base.to(torch.float32)
    tsdf = vol.tsdf[:nb].reshape(-1)
    weight = vol.weight[:nb].reshape(-1)
    s = torch.zeros(q.shape[0], dtype=torch.float32, device=dev)
    g = [torch.zeros_like(s) for _ in range(3)]
    valid = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
    # per axis, the two corners' weights and the slopes of those weights
    lo_hi = [(1.0 - frac[:, k], frac[:, k]) for k in range(3)]
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                idx = [base[:, 0] + cx, base[:, 1] + cy, base[:, 2] + cz]
                inside = torch.ones_like(valid)
                for k in range(3):
                    inside &= (idx[k] >= 0) & (idx[k] < size[k])
                c = [torch.clamp(idx[k], 0, size[k] - 1).long()
                     for k in range(3)]
                block = ((c[0] // B) * (by * bz) + (c[1] // B) * bz
                         + c[2] // B)
                voxel = (c[0] % B) * (B * B) + (c[1] % B) * B + c[2] % B
                row = block * recon.BLOCK_VOXELS + voxel
                val = tsdf[row]
                valid &= (weight[row] > 0) & inside
                wx, wy, wz = lo_hi[0][cx], lo_hi[1][cy], lo_hi[2][cz]
                sx, sy, sz = (1.0 if cx else -1.0, 1.0 if cy else -1.0,
                              1.0 if cz else -1.0)
                s = s + val * (wx * wy * wz)
                g[0] = g[0] + val * (sx * wy * wz)
                g[1] = g[1] + val * (wx * sy * wz)
                g[2] = g[2] + val * (wx * wy * sz)
    return s, torch.stack(g, dim=-1) * inv_voxel, valid


def track(vol, pts, valid, T0: torch.Tensor, st: dict) -> torch.Tensor:
    """The frame's camera-to-world pose (4, 4) float32 after the tracker's
    Gauss-Newton steps from T0."""
    T = T0
    dev = pts.device
    huber = vol.voxel_size
    steep = 0.1 / vol.sdf_trunc
    for _ in range(st["max_iterations"]):
        q = pts @ T[:3, :3].T + T[:3, 3]
        s, g, ok = trilinear(vol, q)
        glen = torch.linalg.norm(g, dim=-1)
        glen_safe = torch.clamp(glen, min=EPS)
        n = g / glen_safe[:, None]
        r = s / glen_safe
        w = (valid & ok & (s > -BAND) & (s < BAND)
             & (glen > steep)).to(torch.float32)
        w = w * torch.clamp(torch.full_like(r, huber)
                            / torch.clamp(torch.abs(r), min=EPS), max=1.0)
        J = torch.cat([torch.linalg.cross(q, n, dim=-1), n], dim=-1)
        Jw = J * w[:, None]
        A = Jw.T @ J
        A = A + (st["damping"] * torch.trace(A) * recip32(6.0) + EPS) \
            * torch.eye(6, dtype=torch.float32, device=dev)
        x = torch.linalg.solve(A, -(Jw.T @ r))
        rot, tr = torch.linalg.norm(x[:3]), torch.linalg.norm(x[3:])
        scale = torch.clamp(torch.minimum(
            torch.full_like(rot, st["step_rotation_rad"])
            / torch.clamp(rot, min=EPS),
            torch.full_like(tr, st["step_translation_m"])
            / torch.clamp(tr, min=EPS)), max=1.0)
        T = se3_exp(x * scale) @ T
    return T


def fuse_capped(vol, depth, color, extrinsic, intr, max_active: int):
    """One frame into `vol` (in place) by reference/recon.py's fusion, its
    active blocks cut to the max_active lowest ids."""
    nb = vol.num_blocks
    band, visible = recon._active_blocks(vol.meta, depth[None],
                                         extrinsic[None], intr)
    created, active = recon.created_and_active(band, visible,
                                               vol.created[:nb])
    active &= torch.cumsum(active, dim=1) <= max_active
    nz = torch.nonzero(active.t())               # block-major (block, frame)
    ids, counts = torch.unique(nz[:, 0], return_counts=True)
    ptr = torch.zeros(len(ids) + 1, dtype=torch.int64, device=depth.device)
    ptr[1:] = torch.cumsum(counts, 0)
    recon.fuse_blocks_torch(vol, ids, ptr, nz[:, 1], depth[None],
                            recon.pack_rgb(color[None]), extrinsic[None],
                            intr)
    vol.created[:nb] = created[-1]


def tracked_chain(cap, intr, params, st: dict, device, dtype):
    """(N, 4, 4) float32 world-to-camera poses of the tracked chain, and
    the number of corrections the trust region dropped."""
    tp = recon.auto_volume_config(cap, intr, params).tsdf
    f32 = torch.float32
    depths = torch.as_tensor(cap.depths, dtype=f32, device=device)
    colors = torch.as_tensor(cap.colors, dtype=f32, device=device)
    ext = np.asarray(cap.extrinsics, np.float64)
    vol = recon.make_block_volume(tp, device, dtype)
    fuse_capped(vol, depths[0], colors[0],
                torch.as_tensor(cap.extrinsics[0], dtype=f32, device=device),
                intr, st["max_active"])
    out, dropped = [ext[0]], 0
    for i in range(1, len(ext)):
        prior = (ext[i] @ _invert(ext[i - 1])) @ out[-1]
        pts, valid = frame_points(depths[i], intr, st)
        pts = pts.to(dtype).to(f32)
        T0 = torch.as_tensor(_invert(prior).astype(np.float32),
                             device=device)
        T = track(vol, pts, valid, T0, st).cpu().numpy().astype(np.float64)
        dT = T @ prior
        if (pair.rotation_angle(dT[:3, :3]) > st["trust_rotation_rad"]
                or np.linalg.norm(dT[:3, 3]) > st["trust_translation_m"]):
            corrected = prior
            dropped += 1
        else:
            corrected = _invert(T)
        out.append(corrected)
        fuse_capped(vol, depths[i], colors[i],
                    torch.as_tensor(corrected.astype(np.float32),
                                    device=device), intr, st["max_active"])
    return np.stack(out).astype(np.float32), dropped


# ---------------------------------------------------------------------------
# loop closures
# ---------------------------------------------------------------------------

def _pair_settings(st: dict) -> dict:
    return {"thresholds": tuple(st["pair_thresholds_m"]),
            "max_iterations": st["pair_iterations"],
            "relative_fitness": st["pair_relative_fitness"],
            "relative_rmse": st["pair_relative_rmse"]}


def verify(depths, i: int, j: int, prior_rel: np.ndarray, intr, st: dict):
    """(M, fitness): frame j registered onto frame i from prior_rel
    (camera_j -> camera_i) by the annealed pair ICP."""
    ps = _pair_settings(st)
    pi, ni, vi = pair.frame_points_normals(depths[i], intr, st["stride"])
    pj, _, vj = pair.frame_points_normals(depths[j], intr, st["stride"])
    dev = pj.device
    R = torch.as_tensor(prior_rel[:3, :3].T.astype(np.float32), device=dev)
    t = torch.as_tensor(prior_rel[:3, 3].astype(np.float32), device=dev)
    src = pj @ R + t
    T = pair.register_pair(src, vj, pi, ni, vi, ps)
    _, _, fit, _ = pair._metrics(src, pi, vj, vi, ps["thresholds"][-1], T)
    dT = T.cpu().numpy().astype(np.float64)
    return dT @ prior_rel, float(fit)


def loop_closures(depths, chain: np.ndarray, intr, st: dict):
    """([(i, j, M)] verified loop edges, candidates found)."""
    ext = np.asarray(chain, np.float64)
    centres = np.stack([_invert(e)[:3, 3] for e in ext])
    n = len(ext)
    cand = []
    for i in range(n):
        for j in range(i + st["min_gap"], n):
            d = float(np.linalg.norm(centres[i] - centres[j]))
            if d < st["loop_radius_m"]:
                cand.append((j - i, d, i, j))
    cand.sort(key=lambda c: (-c[0], c[1]))
    edges, used = [], set()
    for _, _, i, j in cand:
        if len(edges) >= st["max_loop_pairs"]:
            break
        if i in used or j in used:
            continue
        M, fit = verify(depths, i, j, ext[i] @ _invert(ext[j]), intr, st)
        if fit >= st["min_fitness"]:
            edges.append((i, j, M))
            used.update((i, j))
    return edges, len(cand)


# ---------------------------------------------------------------------------
# the pose graph
# ---------------------------------------------------------------------------

def solve_graph(poses: torch.Tensor, edges: list, st: dict) -> torch.Tensor:
    """(N, 4, 4) camera-to-world poses after the Gauss-Newton solve of
    `edges` [(i, j, Z (4, 4) float32, weight)]."""
    dev, f32 = poses.device, torch.float32
    N = poses.shape[0]
    ei = torch.tensor([e[0] for e in edges], device=dev)
    ej = torch.tensor([e[1] for e in edges], device=dev)
    Z = torch.stack([e[2] for e in edges])
    w = torch.tensor([e[3] for e in edges], dtype=f32, device=dev)
    Zinv = torch.linalg.inv(Z)
    root_w = torch.sqrt(w)[:, None]

    def residual(d, T):
        moved = T @ se3_exp(d)
        rel = torch.linalg.inv(moved[ei]) @ moved[ej]
        return (se3_log(Zinv @ rel) * root_w).reshape(-1)

    def rms(T):
        r = residual(torch.zeros((N, 6), dtype=f32, device=dev), T)
        return torch.sqrt(torch.sum(r * r) / (6.0 * len(edges)))

    zero = torch.zeros((N, 6), dtype=f32, device=dev)
    prior = torch.zeros(6 * N, dtype=f32, device=dev)
    prior[:6] = st["anchor_weight"]
    jacobian = torch.func.jacfwd(residual)
    T = poses
    for _ in range(st["graph_iterations"]):
        r = residual(zero, T)
        J = jacobian(zero, T).reshape(r.shape[0], 6 * N)
        JtJ = J.T @ J
        A = JtJ + torch.diag(prior + st["graph_damping"]
                             * torch.diagonal(JtJ) + EPS)
        d = -torch.linalg.solve(A, J.T @ r).reshape(N, 6)
        now = rms(T)
        full, quarter = T @ se3_exp(d), T @ se3_exp(0.25 * d)
        r_full, r_quarter = rms(full), rms(quarter)
        if bool((r_full <= r_quarter) & (r_full < now)):
            T = full
        elif bool(r_quarter < now):
            T = quarter
    return T


def refine_trajectory(cap, intr, params, st: dict, device,
                      dtype=torch.float32):
    """(N, 4, 4) float32 refined world-to-camera extrinsics of a capture
    from its (prior) extrinsics, and a record: the loop candidates, the
    verified loop edges and the corrections the tracker's trust region
    dropped."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chain, dropped = tracked_chain(cap, intr, params, st, device, dtype)
    depths = torch.as_tensor(cap.depths, dtype=torch.float32, device=device)
    loops, candidates = loop_closures(depths, chain, intr, st)
    ext = chain.astype(np.float64)
    edges = [(i, i + 1, ext[i] @ _invert(ext[i + 1]), st["chain_weight"])
             for i in range(len(ext) - 1)]
    edges += [(i, j, M, st["loop_weight"]) for i, j, M in loops]
    edges = [(i, j, torch.as_tensor(Z.astype(np.float32), device=device), w)
             for i, j, Z, w in edges]
    poses = torch.as_tensor(np.stack([_invert(e) for e in ext])
                            .astype(np.float32), device=device)
    T = solve_graph(poses, edges, st).cpu().numpy().astype(np.float64)
    out = np.stack([_invert(t) for t in T]).astype(np.float32)
    return out, {"loop_candidates": candidates, "loop_edges": len(loops),
                 "dropped": dropped}
