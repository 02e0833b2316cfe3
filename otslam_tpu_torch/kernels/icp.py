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

`icp_plane_annealed` is point-to-plane ICP at several thresholds in turn
(the pose refiner's pairs) on CUDA tensors with csrc/icp_plane.cu's fused
kernels: ~13 calls and one host wait an iteration instead of the host
loop's ~95 and three, the loop's condition evaluated on the card, and the
same results bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from otslam_tpu_torch.device import to_device
from otslam_tpu_torch.kernels import _build
from otslam_tpu_torch.kernels.nn import (DST_CHUNK, SRC_TILE, nn_distance,
                                         nn_distance_radius, nn_min_windowed)
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


# icp_plane_annealed's state on the card: csrc/icp_plane.cu's PairState, in
# 32-bit words
STATE_WORDS = 41      # sizeof(PairState) / 4
FIT_WORD = 32         # fit, then rmse: the last stage's result
KEEP_WORD = 40        # the loop's condition at the last evaluation

# The library calls of the fused loop's step, made as PyTorch makes them on
# the card for these shapes, so that they give its results bit for bit
# (tests/test_torch_cuda.py and chip_smoke's pair phase hold the poses
# equal): a matrix product is cuBLAS's sgemm (a matrix-vector one its
# sgemv) with the operands' layouts as PyTorch passes them;
# torch.linalg.solve_ex of a 6x6 and one right-hand side factors A by
# cuSOLVER's getrf and solves by cuBLAS's getrsBatched; torch.linalg.svd
# of a 3x3 calls cuSOLVER's gesvdjBatched with sorted singular values and
# the f32 epsilon as its tolerance.
_OP_N, _OP_T = 0, 1
_EIG_MODE_VECTOR = 1
_GESVDJ_TOLERANCE = float(torch.finfo(torch.float32).eps)


class _StepLibrary:
    """One device's cuBLAS and cuSOLVER calls of the fused ICP step, on
    handles of its own over the libraries PyTorch loaded, into fixed
    buffers: without the host waits of torch.linalg.svd (its convergence
    check) and without PyTorch's per-call set-up. `bind(stream)` before a
    pair's calls; then

        normal(J, Jw, r)     A = Jw^T J and g = Jw^T r of (n, 6), (n,) rows
        solve()              rhs = lu^-1 rhs, lu column-major (destroyed)
        svd()                a (column-major, destroyed) = U S Vh
        rotation()           Rn = U @ Vh
        compose(dT, T, out)  out = dT @ T, all (4, 4)
    """

    def __init__(self, dev: torch.device):
        v, i = ctypes.c_void_p, ctypes.c_int
        fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(i)
        solver = ctypes.CDLL("libcusolver.so.11")
        blas = ctypes.CDLL("libcublas.so.12")
        solver.cusolverDnSetStream.argtypes = [v, v]
        solver.cusolverDnXgesvdjSetSortEig.argtypes = [v, i]
        solver.cusolverDnXgesvdjSetTolerance.argtypes = [v, ctypes.c_double]
        solver.cusolverDnSgesvdjBatched_bufferSize.argtypes = [
            v, i, i, i, v, i, v, v, i, v, i, ip, v, i]
        solver.cusolverDnSgesvdjBatched.argtypes = [
            v, i, i, i, v, i, v, v, i, v, i, v, i, v, v, i]
        solver.cusolverDnSgetrf_bufferSize.argtypes = [v, i, i, v, i, ip]
        solver.cusolverDnSgetrf.argtypes = [v, i, i, v, i, v, v, v]
        blas.cublasSetStream_v2.argtypes = [v, v]
        blas.cublasSgemm_v2.argtypes = [v, i, i, i, i, i, fp, v, i, v, i, fp,
                                        v, i]
        blas.cublasSgemv_v2.argtypes = [v, i, i, i, fp, v, i, v, i, fp, v, i]
        blas.cublasSgetrsBatched.argtypes = [v, i, i, i, v, i, v, v, i, ip,
                                             i]
        self.solver, self.blas = solver, blas
        self.dn, self.bh, self.params = v(), v(), v()
        self.one, self.zero = ctypes.c_float(1.0), ctypes.c_float(0.0)
        f32 = dict(dtype=torch.float32, device=dev)
        self.A, self.g = torch.empty((6, 6), **f32), torch.empty(6, **f32)
        self.lu, self.rhs = torch.empty(36, **f32), torch.empty(6, **f32)
        self.piv = torch.empty(6, dtype=torch.int32, device=dev)
        self.a, self.s = torch.empty(9, **f32), torch.empty(3, **f32)
        self.u, self.v = torch.empty(9, **f32), torch.empty(9, **f32)
        self.Rn = torch.empty((3, 3), **f32)
        self.info = torch.zeros(1, dtype=torch.int32, device=dev)
        self.getrs_info = i()
        getrf_work, gesvdj_work = i(), i()
        with torch.cuda.device(dev):
            _library_check(solver.cusolverDnCreate(ctypes.byref(self.dn)))
            _library_check(blas.cublasCreate_v2(ctypes.byref(self.bh)))
        _library_check(solver.cusolverDnCreateGesvdjInfo(
            ctypes.byref(self.params)))
        _library_check(solver.cusolverDnXgesvdjSetSortEig(self.params, 1))
        _library_check(solver.cusolverDnXgesvdjSetTolerance(
            self.params, _GESVDJ_TOLERANCE))
        _library_check(solver.cusolverDnSgetrf_bufferSize(
            self.dn, 6, 6, self.lu.data_ptr(), 6, ctypes.byref(getrf_work)))
        _library_check(solver.cusolverDnSgesvdjBatched_bufferSize(
            self.dn, _EIG_MODE_VECTOR, 3, 3, self.a.data_ptr(), 3,
            self.s.data_ptr(), self.u.data_ptr(), 3, self.v.data_ptr(), 3,
            ctypes.byref(gesvdj_work), self.params, 1))
        self.getrf_work = torch.empty(max(getrf_work.value, 1), **f32)
        self.gesvdj_work = torch.empty(max(gesvdj_work.value, 1), **f32)
        # getrsBatched's arrays of matrix pointers
        self.lu_ptrs = to_device([self.lu.data_ptr()], dev, torch.int64)
        self.rhs_ptrs = to_device([self.rhs.data_ptr()], dev, torch.int64)

    def bind(self, stream: int) -> None:
        _library_check(self.solver.cusolverDnSetStream(self.dn, stream))
        _library_check(self.blas.cublasSetStream_v2(self.bh, stream))

    def _gemm(self, ta, tb, m, n, k, a, lda, b, ldb, c, ldc) -> None:
        # column-major c (m x n) = op(a) op(b)
        _library_check(self.blas.cublasSgemm_v2(
            self.bh, ta, tb, m, n, k, ctypes.byref(self.one), a, lda, b, ldb,
            ctypes.byref(self.zero), c, ldc))

    def normal(self, J: torch.Tensor, Jw: torch.Tensor,
               r: torch.Tensor) -> None:
        n = J.shape[0]
        # Jw.T @ J and Jw.T @ r of row-major (n, 6) J and Jw
        self._gemm(_OP_N, _OP_T, 6, 6, n, J.data_ptr(), 6, Jw.data_ptr(), 6,
                   self.A.data_ptr(), 6)
        _library_check(self.blas.cublasSgemv_v2(
            self.bh, _OP_N, 6, n, ctypes.byref(self.one), Jw.data_ptr(), 6,
            r.data_ptr(), 1, ctypes.byref(self.zero), self.g.data_ptr(), 1))

    def solve(self) -> None:
        _library_check(self.solver.cusolverDnSgetrf(
            self.dn, 6, 6, self.lu.data_ptr(), 6, self.getrf_work.data_ptr(),
            self.piv.data_ptr(), self.info.data_ptr()))
        _library_check(self.blas.cublasSgetrsBatched(
            self.bh, _OP_N, 6, 1, self.lu_ptrs.data_ptr(), 6,
            self.piv.data_ptr(), self.rhs_ptrs.data_ptr(), 6,
            ctypes.byref(self.getrs_info), 1))

    def svd(self) -> None:
        _library_check(self.solver.cusolverDnSgesvdjBatched(
            self.dn, _EIG_MODE_VECTOR, 3, 3, self.a.data_ptr(), 3,
            self.s.data_ptr(), self.u.data_ptr(), 3, self.v.data_ptr(), 3,
            self.gesvdj_work.data_ptr(), self.gesvdj_work.numel(),
            self.info.data_ptr(), self.params, 1))

    def rotation(self) -> None:
        # Rn = U @ Vh, U column-major and Vh = V^T with V column-major, as
        # torch.linalg.svd lays them out
        self._gemm(_OP_N, _OP_T, 3, 3, 3, self.v.data_ptr(), 3,
                   self.u.data_ptr(), 3, self.Rn.data_ptr(), 3)

    def compose(self, dT: torch.Tensor, T: torch.Tensor,
                out: torch.Tensor) -> None:
        self._gemm(_OP_N, _OP_N, 4, 4, 4, T.data_ptr(), 4, dT.data_ptr(), 4,
                   out.data_ptr(), 4)


def _library_check(status: int) -> None:
    if status != 0:
        raise RuntimeError(f"cuSOLVER/cuBLAS status {status}")


@functools.lru_cache(maxsize=None)
def _step_library(dev: torch.device) -> _StepLibrary:
    return _StepLibrary(dev)


def icp_plane_annealed(src: torch.Tensor, dst: torch.Tensor,
                       dst_normals: torch.Tensor, thresholds,
                       src_mask: torch.Tensor | None = None,
                       dst_mask: torch.Tensor | None = None,
                       max_iterations: int = 30,
                       relative_fitness: float = 1e-6,
                       relative_rmse: float = 1e-6,
                       nn_window: int = 1, nn_axis: int = 2) -> ICPResult:
    """icp_point_to_plane at each threshold in turn, the first stage from
    the identity and each next one from the last one's transformation, on
    CUDA tensors with csrc/icp_plane.cu's kernels: bit for bit the results
    of the plain version (that chain of host loops,
    refine._annealed_icp_plain) on the card.

    An iteration: the prep kernel (src moved by the pose, each tile's
    chunk range), K4 (nn_min_windowed; over the whole destination where
    the window of nn_window >= 1 chunks covers it, where the host loop
    takes K3, which gives the same minima and indices), the terms kernel,
    the plain version's sum of d^2 (torch.sum), the normal equations, the
    eval kernel (metrics, best pose, the loop's condition, the damped
    system), then, while the condition holds, the solve, the rotation
    kernel, the SVD, U @ Vh, the dt kernel and dT @ T (cuBLAS and
    cuSOLVER called as PyTorch calls them, without its waits and per-call
    set-up: `_StepLibrary`). The host reads the condition once an
    evaluation, its one wait (a counted sync). The destination is sorted once for all
    stages, the source at each stage's start, as `_setup` sorts them.

    Returns the last stage's ICPResult; the transformation, fitness and
    RMSE are views of the pair's state on the card."""
    dev = src.device
    n, m = src.shape[0], dst.shape[0]
    if n == 0 or m == 0 or not thresholds or nn_window < 1:
        raise ValueError(f"icp_plane_annealed: {n} x {m} points, "
                         f"{len(thresholds)} thresholds, window {nn_window}")
    src = src.to(torch.float32)
    smask = (torch.ones(n, dtype=torch.bool, device=dev)
             if src_mask is None else src_mask.to(torch.bool))
    dmask = (torch.ones(m, dtype=torch.bool, device=dev)
             if dst_mask is None else dst_mask.to(torch.bool))
    od = torch.argsort(dst[:, nn_axis], stable=True)
    dst = dst.to(torch.float32)[od]
    dmask, dst_normals = dmask[od], dst_normals.to(torch.float32)[od]
    # the destination padded to whole chunks and its chunk bounds, as
    # nn.window_ranges makes them each iteration
    mpad = -(-m // DST_CHUNK) * DST_CHUNK
    dstp = torch.cat([dst, dst[-1:].expand(mpad - m, 3)])
    dmaskp = torch.nn.functional.pad(dmask, (0, mpad - m)).contiguous()
    nrm = dst_normals.contiguous()
    dz = dstp[:, nn_axis]
    chunk_lo = dz[::DST_CHUNK].contiguous()
    chunk_hi = dz[DST_CHUNK - 1::DST_CHUNK].contiguous()
    sorted_ok = torch.all(dz[1:] >= dz[:-1])
    full = int(nn_window * DST_CHUNK >= m)

    f32 = dict(dtype=torch.float32, device=dev)
    state = torch.zeros(STATE_WORDS, dtype=torch.int32, device=dev)
    words = state.view(torch.float32)
    T_state = words[:16].view(4, 4)
    words[0:16:5] = 1.0                        # the identity
    tiles = -(-n // SRC_TILE)
    ranges = torch.empty((len(thresholds) * (max_iterations + 1), 2, tiles),
                         dtype=torch.int32, device=dev)
    p = torch.empty((n, 3), **f32)
    J, Jw = torch.empty((n, 6), **f32), torch.empty((n, 6), **f32)
    r, dd = torch.empty(n, **f32), torch.empty(n, **f32)
    xs, dT = torch.empty(6, **f32), torch.empty((4, 4), **f32)
    poses = torch.empty((2, 4, 4), **f32)      # the iterates, in turn
    keep = state[KEEP_WORD]
    lin = _step_library(dev)
    _build.check_operands(src, smask, dstp, dmaskp, nrm, chunk_lo, chunk_hi,
                          sorted_ok, state, ranges, p, J, Jw, r, dd, xs, dT,
                          poses, lin.A)
    lib = _build.load()
    stream = _build.stream_ptr(dev)
    lin.bind(stream)
    views = iter(ranges)
    it = 0
    for thr in thresholds:
        p0 = src @ T_state[:3, :3].T + T_state[:3, 3]
        order = torch.argsort(p0[:, nn_axis], stable=True)
        src_k, smask_k = src[order], smask[order]
        T = T_state
        it = 0
        while True:
            c0, c1 = next(views)
            _build.check(lib.otslam_icp_prep(
                src_k.data_ptr(), T.data_ptr(), chunk_lo.data_ptr(),
                chunk_hi.data_ptr(), sorted_ok.data_ptr(), n,
                mpad // DST_CHUNK, nn_axis, thr, full, p.data_ptr(),
                c0.data_ptr(), c1.data_ptr(), stream), "otslam_icp_prep")
            best_d, best_i = nn_min_windowed(p, dstp, dmaskp, c0, c1)
            _build.check(lib.otslam_icp_terms(
                p.data_ptr(), smask_k.data_ptr(), dstp.data_ptr(),
                nrm.data_ptr(), best_d.data_ptr(), best_i.data_ptr(), n, m,
                thr, J.data_ptr(), Jw.data_ptr(), r.data_ptr(),
                dd.data_ptr(), state.data_ptr(), stream), "otslam_icp_terms")
            sdd = torch.sum(dd)
            lin.normal(J, Jw, r)
            _build.check(lib.otslam_icp_eval(
                state.data_ptr(), T.data_ptr(), sdd.data_ptr(),
                lin.A.data_ptr(), lin.g.data_ptr(), it, max_iterations,
                relative_fitness,
                relative_rmse, lin.lu.data_ptr(), lin.rhs.data_ptr(), stream),
                "otslam_icp_eval")
            waited(keep)
            if not bool(keep):
                break
            lin.solve()
            _build.check(lib.otslam_icp_rotation(
                lin.rhs.data_ptr(), xs.data_ptr(), lin.a.data_ptr(), stream),
                "otslam_icp_rotation")
            lin.svd()
            lin.rotation()
            _build.check(lib.otslam_icp_dt(lin.Rn.data_ptr(), xs.data_ptr(),
                                           dT.data_ptr(), stream),
                         "otslam_icp_dt")
            lin.compose(dT, T, poses[it % 2])
            T = poses[it % 2]
            it += 1
        count("icp.iterations", it)
    return ICPResult(T_state, words[FIT_WORD], words[FIT_WORD + 1], it)
