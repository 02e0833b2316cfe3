"""The plain reference of the mission cell: a perception batch (virtual
scans, scan diff, evidence dwell, compaction of confident cells), the
scan-to-map localization, and the real LiDAR scans.

Plain PyTorch and NumPy in float32 with TF32 off, importing nothing of the
program. The saved map, its occupied points, the beam angles and the real
scans are made here from the frozen scene (benchmark/inputs/). The ray
cast, scan diff and evidence functions are frozen copies of the port's
plain versions (kernels/raycast.py `ray_keys_torch`, kernels/scan_diff.py,
kernels/evidence.py, mapping/perception.py); the localizer is
point-to-point ICP (Open3D's criteria, as kernels/icp.py) over a
brute-force nearest-neighbour search, where the port searches a window.

A closed-loop mission can only be followed step by step: each judged
perception batch starts from the program's carried evidence grids and
believed poses, and each judged localization from the program's real scan
and odometry prior. The start (the first batch, from empty grids) and the
real scans (from the true poses) are checked by themselves.

`dtype` runs the real scans', the ray cast's and the ICP's arithmetic in
another type: the control runs them in bfloat16, the step below the
configuration's float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.inputs.render import render_lidar_path
from benchmark.inputs.scene import saved_map_scene, scene

BIG = 3.0e38


class MissionReference:
    """The saved map and LiDAR model of a configuration, on a device."""

    def __init__(self, cfg: dict, traffic: dict, device,
                 dtype=torch.float32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = device
        self.dtype = dtype
        self.lidar = cfg["lidar"]
        self.cd = cfg["change_detect"]
        self.world = scene(traffic["scene"])
        grid, origin = saved_map_scene(self.world, traffic["removed"]
                                       ).occupancy(cfg["map_resolution"])
        self.res = float(cfg["map_resolution"])
        self.origin = origin
        self.grid_np = grid
        self.grid = torch.as_tensor(grid, device=device)
        n = self.lidar["num_beams"]
        inc = (self.lidar["angle_max"] - self.lidar["angle_min"]) / n
        self.angles = torch.as_tensor(
            (self.lidar["angle_min"] + np.arange(n) * inc).astype(np.float32),
            device=device)
        loc = cfg["localizer"]
        rows, cols = np.nonzero(grid == 100)
        pts = np.stack([origin[0] + cols * self.res,
                        origin[1] + rows * self.res], -1) + self.res / 2.0
        if len(pts) > loc["max_map_points"]:
            sel = np.random.default_rng(0).choice(
                len(pts), loc["max_map_points"], replace=False)
            pts = pts[sel]
        self.map_pts = torch.as_tensor(np.concatenate(
            [pts, np.zeros((len(pts), 1))], -1).astype(np.float32),
            device=device)
        self.loc = loc

    # --- sensors -----------------------------------------------------------

    def real_scans(self, true_poses: np.ndarray) -> torch.Tensor:
        return render_lidar_path(self.world, np.asarray(true_poses),
                                 self.angles, self.lidar["range_min"],
                                 self.lidar["range_max"], dtype=self.dtype)

    # --- perception --------------------------------------------------------

    def virtual_scans(self, poses: torch.Tensor) -> torch.Tensor:
        res, (ox, oy) = self.res, self.origin
        S = -int(-self.lidar["range_max"] // res)
        dt = self.dtype
        ga = poses[:, 2:3].float() + self.angles
        cos_a, sin_a = torch.cos(ga).to(dt), torch.sin(ga).to(dt)
        fs, fo = _ray_keys(self.grid, cos_a, sin_a, poses[:, :2].to(dt),
                           res, ox, oy, S, dt)
        hit = (fs < S) & (fo == fs)
        rng = (fs.to(torch.float32) + 1.0) * res
        return torch.where(hit, rng, torch.inf).reshape(cos_a.shape)

    def perception(self, new_grid, gone_grid, reals, poses, dts,
                   max_points: int) -> dict:
        """One batch of K ticks from the carried grids."""
        cd = self.cd
        poses = poses.to(torch.float32)
        virt = self.virtual_scans(poses)
        new_mask, removed_mask = scan_diff(
            reals, virt, self.angles, self.lidar["range_max"],
            cd["distance_threshold"], cd["search_window"])
        x0, y0, yaw = poses[:, 0:1], poses[:, 1:2], poses[:, 2:3]
        c, s = torch.cos(yaw), torch.sin(yaw)

        def to_map(r):
            lx = r * torch.cos(self.angles)
            ly = r * torch.sin(self.angles)
            return x0 + lx * c - ly * s, y0 + lx * s + ly * c

        rx, ry = to_map(torch.nan_to_num(reals, posinf=0.0))
        vx, vy = to_map(torch.nan_to_num(virt, posinf=0.0))
        g = cd["grid_resolution"]
        new_hits = scatter_hits(new_grid, rx, ry, new_mask, g)
        gone_hits = scatter_hits(new_grid, vx, vy, removed_mask, g)
        ng, gg = new_grid, gone_grid
        ngs, ggs = [], []
        for i in range(reals.shape[0]):
            ng = update_evidence(ng, new_hits[i], dts[i],
                                 cd["time_threshold"], cd["decay_rate"])
            gg = update_evidence(gg, gone_hits[i], dts[i],
                                 cd["time_threshold"], cd["decay_rate"])
            ngs.append(ng)
            ggs.append(gg)
        apts, acnt = compact_confident(torch.stack(ngs), g,
                                       cd["time_threshold"], max_points)
        rpts, rcnt = compact_confident(torch.stack(ggs), g,
                                       cd["time_threshold"], max_points)
        return {"new_grid": ng, "gone_grid": gg, "virtual": virt,
                "added_pts": apts, "added_cnt": acnt,
                "removed_pts": rpts, "removed_cnt": rcnt}

    # --- localization ------------------------------------------------------

    def localize(self, ranges: torch.Tensor, prior) -> tuple:
        """(x, y, yaw) from a scan and an odometry prior, or the prior when
        the fit is degenerate or corrects by more than the limits."""
        loc = self.loc
        r = ranges.float().cpu().numpy()
        a = self.angles.cpu().numpy()
        ok = np.isfinite(r) & (r > 0)
        x0, y0, yaw0 = (float(v) for v in prior)
        if not ok.any() or len(self.map_pts) == 0:
            return x0, y0, yaw0
        c, s = np.cos(yaw0), np.sin(yaw0)
        lx = np.where(ok, r, 0.0) * np.cos(a)
        ly = np.where(ok, r, 0.0) * np.sin(a)
        src = np.stack([x0 + lx * c - ly * s, y0 + lx * s + ly * c,
                        np.zeros_like(lx)], -1).astype(np.float32)
        T = icp_point_to_point(
            torch.as_tensor(src, device=self.device), self.map_pts,
            torch.as_tensor(ok, device=self.device), loc["threshold"],
            loc["max_iterations"], self.dtype).cpu().numpy()
        dyaw = float(np.arctan2(T[1, 0], T[0, 0]))
        cx, sx = np.cos(dyaw), np.sin(dyaw)
        nx = T[0, 3] + cx * x0 - sx * y0
        ny = T[1, 3] + sx * x0 + cx * y0
        if (not np.isfinite([nx, ny, dyaw]).all()
                or np.hypot(nx - x0, ny - y0) > loc["max_correction"]
                or abs(dyaw) > loc["max_yaw_correction"]):
            return x0, y0, yaw0
        return float(nx), float(ny), yaw0 + dyaw


# --- frozen plain versions ---------------------------------------------------

def _ray_keys(grid, cos_a, sin_a, pose_xy, resolution, origin_x, origin_y,
              num_steps, dtype):
    """First-stop and first-occupied step keys per beam (K5's contract):
    sample d = (s+1)*res, x = px + d*cos, gx = (int)((x - ox)/res)."""
    H, W = grid.shape
    dev = grid.device
    S = num_steps
    res = torch.as_tensor(resolution, dtype=dtype, device=dev)
    ox = torch.as_tensor(origin_x, dtype=dtype, device=dev)
    oy = torch.as_tensor(origin_y, dtype=dtype, device=dev)
    d = (torch.arange(S, dtype=dtype, device=dev) + 1.0) * res
    c = cos_a.reshape(-1, 1)
    s = sin_a.reshape(-1, 1)
    B = cos_a.shape[-1]
    px = pose_xy[:, 0].repeat_interleave(B)[:, None]
    py = pose_xy[:, 1].repeat_interleave(B)[:, None]
    x = px + d[None, :] * c
    y = py + d[None, :] * s
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


def _window(q, W, fill):
    n = q.shape[-1]
    qp = torch.nn.functional.pad(q, (W, W), value=fill)
    return qp.unfold(-1, 2 * W, 1)[..., :n, :]


def scan_diff(real, virt, angles, range_max, distance_threshold,
              search_window):
    """(new, removed) beam masks: a real return with no virtual return
    within the threshold inside a +/- W beam window, and the converse
    (diff_node.cpp:102-158)."""
    W = search_window
    real_finite = torch.isfinite(real) & (real <= range_max)
    virt_finite = torch.isfinite(virt)
    rx, ry = real * torch.cos(angles), real * torch.sin(angles)
    vx, vy = virt * torch.cos(angles), virt * torch.sin(angles)
    thr2 = distance_threshold * distance_threshold

    def near(px, py, qx, qy, qvalid):
        qxw = _window(qx, W, 0.0)
        qyw = _window(qy, W, 0.0)
        qvw = _window(qvalid, W, False)
        d2 = (px[..., None] - qxw) ** 2 + (py[..., None] - qyw) ** 2
        return (qvw & (d2 < thr2)).any(dim=-1)

    new = real_finite & ~near(rx, ry, vx, vy, virt_finite)
    removed = virt_finite & ~near(vx, vy, rx, ry, real_finite)
    return new, removed


def scatter_hits(ref, xs, ys, mask, resolution):
    """(K, GH, GW) boolean hit grids; world cell (0, 0) at the centre,
    keys truncated toward zero as the C++ (int)(x / res)."""
    GH, GW = ref.shape[-2:]
    res = torch.tensor(resolution, dtype=torch.float32, device=xs.device)
    gx = (xs / res).to(torch.int32) + GW // 2
    gy = (ys / res).to(torch.int32) + GH // 2
    inb = mask & (gx >= 0) & (gx < GW) & (gy >= 0) & (gy < GH)
    k = math.prod(xs.shape[:-1])
    base = (torch.arange(k, device=xs.device) * (GH * GW)).reshape(
        *xs.shape[:-1], 1)
    dead = k * GH * GW
    flat = torch.where(inb, base + gy.long() * GW + gx.long(), dead)
    hits = torch.zeros(dead + 1, dtype=torch.bool, device=xs.device)
    hits[flat.reshape(-1)] = True
    return hits[:-1].reshape(*xs.shape[:-1], GH, GW)


def update_evidence(dwell, hits, dt, time_threshold, decay_rate):
    """One dwell/decay step (diff_node.cpp:169-185)."""
    grown = torch.clamp(dwell + dt, max=1.5 * time_threshold)
    decayed = torch.clamp(dwell - decay_rate * dt, min=0.0)
    return torch.where(hits, grown, torch.where(dwell > 0, decayed, 0.0))


def cell_centers(keys, resolution):
    """f32 key * res + res/2 rounded once."""
    res = float(torch.tensor(resolution, dtype=torch.float32))
    half = float(torch.tensor(resolution / 2.0, dtype=torch.float32))
    return (keys.to(torch.float64) * res + half).to(torch.float32)


def compact_confident(dwell, resolution, time_threshold, max_points):
    """Confident cell centres of each tick's grid, the first max_points in
    row-major order: (points (K, P, 2) zero beyond the count, counts)."""
    K, GH, GW = dwell.shape
    conf = (dwell > time_threshold).reshape(K, GH * GW)
    pts = torch.zeros((K, max_points, 2), dtype=torch.float32,
                      device=dwell.device)
    cnt = torch.clamp(conf.sum(dim=-1, dtype=torch.int32), max=max_points)
    for k in range(K):
        ids = torch.nonzero(conf[k]).reshape(-1)[:max_points]
        ky = ids // GW - GH // 2
        kx = ids % GW - GW // 2
        pts[k, :len(ids), 0] = cell_centers(kx, resolution)
        pts[k, :len(ids), 1] = cell_centers(ky, resolution)
    return pts, cnt


def _nearest(p, dst, chunk=4096):
    """(distance, index) of each row's nearest dst row, lowest index on
    ties, brute force."""
    ds, ids = [], []
    for s in range(0, p.shape[0], chunk):
        a = p[s:s + chunk]
        dx = a[:, None, 0] - dst[None, :, 0]
        dy = a[:, None, 1] - dst[None, :, 1]
        dz = a[:, None, 2] - dst[None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz
        i = torch.argmin(d2, dim=1)
        ds.append(torch.gather(d2, 1, i[:, None])[:, 0])
        ids.append(i)
    d2 = torch.cat(ds)
    i = torch.cat(ids)
    diff = p - dst[i]
    exact = torch.sum(diff * diff, dim=-1)
    return torch.sqrt(torch.clamp(exact.float(), min=0.0)), i


def icp_point_to_point(src, dst, smask, threshold, max_iterations, dtype,
                       relative_fitness=1e-6, relative_rmse=1e-6):
    """(4, 4) src -> dst by point-to-point ICP with Open3D's stopping
    criteria; one correspondence search per iteration."""
    src = src.to(dtype)
    dst = dst.to(dtype)
    T = torch.eye(4, dtype=torch.float32, device=src.device)

    def metrics(T):
        p = src @ T[:3, :3].T.to(dtype) + T[:3, 3].to(dtype)
        d, idx = _nearest(p, dst)
        d = torch.where(smask, d, 0.0)
        idx = torch.where(smask, idx, 0)
        inlier = smask & (d < threshold)
        nin = torch.sum(inlier)
        fit = nin / torch.clamp(torch.sum(smask), min=1)
        rmse = torch.sqrt(torch.sum(torch.where(inlier, d * d, 0.0))
                          / torch.clamp(nin, min=1))
        return idx, inlier, fit, rmse

    idx, inlier, fit, rmse = metrics(T)
    prev_fit = prev_rmse = torch.tensor(-1.0, device=src.device)
    it = 0
    while it < max_iterations:
        if it >= 2 and not bool(
                (torch.abs(prev_fit - fit) > relative_fitness)
                | (torch.abs(prev_rmse - rmse) > relative_rmse)):
            break
        p = (src @ T[:3, :3].T.to(dtype) + T[:3, 3].to(dtype)).float()
        q = dst[idx].float()
        w = inlier.to(torch.float32)
        wsum = torch.clamp(torch.sum(w), min=1e-9)
        cp = torch.sum(p * w[:, None], dim=0) / wsum
        cq = torch.sum(q * w[:, None], dim=0) / wsum
        H = ((p - cp) * w[:, None]).T @ (q - cq)
        U, _, Vh = torch.linalg.svd(H)
        dsign = torch.sign(torch.linalg.det(Vh.T @ U.T))
        one = torch.ones_like(dsign)
        R = Vh.T @ torch.diag(torch.stack([one, one, dsign])) @ U.T
        t = cq - R @ cp
        step = torch.eye(4, dtype=torch.float32, device=src.device)
        step[:3, :3] = R
        step[:3, 3] = t
        T = step @ T
        prev_fit, prev_rmse = fit, rmse
        idx, inlier, fit, rmse = metrics(T)
        it += 1
    return T


# --- the comparison ------------------------------------------------------------

def range_gap(a: np.ndarray, b: np.ndarray) -> tuple:
    """(widest |a - b| over beams where both have a return, number of
    beams where one side has a return and the other none)."""
    fa, fb = np.isfinite(a), np.isfinite(b)
    both = fa & fb
    gap = np.abs(a[both].astype(np.float64) - b[both])
    return (float(gap.max()) if gap.size else 0.0), int((fa != fb).sum())


def perception_gaps(prog: dict, ref: dict) -> dict:
    """The widest gaps of one batch, program against reference (host)."""
    def h(x):
        return x.float().cpu().numpy() if isinstance(x, torch.Tensor) else x
    gap, off = range_gap(h(prog["virtual"]), h(ref["virtual"]))
    out = {"virtual_gap_m": gap, "virtual_beams_off": off,
           "grid_gap_s": max(
               float(np.abs(h(prog["new_grid"]) - h(ref["new_grid"])).max()),
               float(np.abs(h(prog["gone_grid"]) - h(ref["gone_grid"])).max()))}
    cnt_gap, pt_gap = 0, 0.0
    for k in ("added", "removed"):
        pc, rc = h(prog[f"{k}_cnt"]), h(ref[f"{k}_cnt"])
        cnt_gap = max(cnt_gap, int(np.abs(pc.astype(np.int64)
                                          - rc.astype(np.int64)).max()))
        pt_gap = max(pt_gap, float(np.abs(h(prog[f"{k}_pts"])
                                          - h(ref[f"{k}_pts"])).max()))
    out["cell_count_gap"] = cnt_gap
    out["cell_gap_m"] = pt_gap
    return out
