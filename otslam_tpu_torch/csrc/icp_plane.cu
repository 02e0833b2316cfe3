// Pair ICP's fused kernels: the per-point work and the loop's condition of
// the annealed point-to-plane ICP of pipeline/refine.py _annealed_icp on
// the card (kernels/icp.py icp_plane_annealed drives them).
//
// Replaces no Pallas kernel. The JAX package runs the loop as XLA's
// lax.while_loop (otslam_tpu/kernels/icp.py icp_point_to_plane); the port's
// plain version, icp_point_to_plane chained over the thresholds
// (refine._annealed_icp_plain), issues ~95 small PyTorch operations and
// three host waits an iteration (the transform, window_ranges, the exact
// recompute, the metrics, the step's terms and algebra, the best-pose and
// condition updates). Contract: bit for bit the plain version's results on
// the card. ICP on frames 60 degrees apart is chaotic: one ulp of
// difference in a step moved some pairs' poses by centimetres, so every
// number these kernels produce is rounded as PyTorch's CUDA operations
// round it (the orders and contractions below were read off those
// operations on an H100), and the sums and solves no kernel here can
// reproduce stay the library calls the plain version makes: the f32 sum of
// the inliers' d^2 (torch.sum), and the step's products, 6x6 solve and
// 3x3 SVD, which icp.py's _StepLibrary makes on cuBLAS and cuSOLVER as
// PyTorch makes them, minus torch.linalg.svd's two host waits.
//
// What bounds it: the host's calls (tens of microseconds each), not the
// card. An iteration is 13 calls, which icp.py captures in a CUDA graph
// once for each key of pair shapes and settings and replays: one launch
// and one host wait an iteration instead of ~95 calls and three waits.
// Nothing that changes from one iteration, stage or pair of a key to the
// next is a launch argument: the iteration, the ranges' slot and the
// stage's threshold live in the pair's state, and the poses and the
// pair's destination in the tensors icp.py keeps for the key. The calls:
//   otslam_icp_prep      p = src R^T + t and each 256-row tile's chunk
//                        range [c0, c1) (nn.py window_ranges), also kept
//                        in the evaluation's slot of the pair's ranges;
//   otslam_nn_window     K4 (csrc/nn.cu, unchanged);
//   otslam_icp_terms     the exact distance, inliers, d^2, the counts, and
//                        the step's J, J w and plane residual r;
//   torch.sum, sgemm,    the sum of d^2, J_w^T J, J_w^T r;
//   sgemv
//   otslam_icp_eval      fitness, RMSE, the best pose by RMSE, the loop's
//                        condition (the host reads it: the one wait) and
//                        the damped system, or the stage's result; the
//                        pose evaluated, for the next step;
//   getrf, getrsBatched  the 6x6 solve;
//   otslam_icp_rotation  the step clamped, and I + [w]x;
//   gesvdjBatched, sgemm the SVD projection U Vh;
//   otslam_icp_dt        dT = [R | t], then dT T (sgemm).
//
// Orders (f32, -fmad=false, so each product and sum rounds once unless
// written as fmaf):
// - src @ R^T + t: cuBLAS's f32 kernel, fused multiply-adds over k from 0,
//   then the bias;
// - torch.sum over a last dimension of 3: (a0 + a2) + a1;
// - torch.linalg.cross: a1 b2 - a2 b1 as fmaf(a1, b2, -(a2 b1)), cyclic;
// - torch.linalg.norm of 3: sqrt((a0^2 + a2^2) + a1^2);
// - torch.trace of a 6x6: ((d0 + d4) + d2) + ((d1 + d5) + d3);
// - a Python scalar in an f32 operation rounds to f32 first.

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kTile = 256;             // source rows a block (nn.SRC_TILE)
constexpr int kWarps = kTile / 32;
constexpr float kBig = 3.0e38f;        // nn.BIG
constexpr float kFallbackFitness = 0.05f;
constexpr float kStepClamp = 0.15f;

// One pair's state on the card (icp.py's word offsets).
struct PairState {
  float T[16];           // the stage's result, row-major
  float best_T[16];      // the evaluated pose of least inlier RMSE
  float fit, rmse;       // the stage's result
  float prev_fit, prev_rmse;
  float best_fit, best_rmse;
  int nv, nin;           // the running iteration's counts (terms adds)
  int keep;              // the loop's condition at the last evaluation
  int it;                // the stage's iteration at the next evaluation
  int slot;              // the pair's evaluations so far: the next's slot
  float threshold;       // the running stage's (the host writes it)
};
static_assert(sizeof(PairState) == 44 * 4, "icp.py STATE_WORDS");
static_assert(offsetof(PairState, fit) == 32 * 4, "icp.py FIT_WORD");
static_assert(offsetof(PairState, keep) == 40 * 4, "icp.py KEEP_WORD");
static_assert(offsetof(PairState, threshold) == 43 * 4,
              "icp.py THRESHOLD_WORD");

// torch.searchsorted(a, v, side="left"): the first i with !(a[i] < v)
__device__ int search_left(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// side="right": the first i with a[i] > v
__device__ int search_right(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// torch.clamp(v, min=lo) and torch.minimum, NaN kept
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__global__ void __launch_bounds__(kTile)
icp_prep_kernel(const float* __restrict__ src,          // (n, 3)
                const float* __restrict__ T,            // (4, 4)
                const float* __restrict__ chunk_lo,     // (nchunks,)
                const float* __restrict__ chunk_hi,
                const bool* __restrict__ sorted_ok,     // dst sorted on axis
                int n, int nchunks, int axis,
                const PairState* __restrict__ st,       // the stage's radius
                int full,
                float* __restrict__ p,                  // (n, 3)
                int* __restrict__ c0, int* __restrict__ c1,
                int* __restrict__ ranges) {   // (slots, 2, tiles) history
  const int b = blockIdx.x, t = threadIdx.x, i = b * kTile + t;
  const float inf = __int_as_float(0x7f800000);
  float lo = inf, hi = -inf;
  if (i < n) {
    const float x = src[3 * (size_t)i], y = src[3 * (size_t)i + 1],
                z = src[3 * (size_t)i + 2];
    float q[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      q[j] = fmaf(z, T[4 * j + 2], fmaf(y, T[4 * j + 1], x * T[4 * j])) +
             T[4 * j + 3];
      p[3 * (size_t)i + j] = q[j];
    }
    lo = hi = q[axis];
  }
  // the tile's extent on the window axis (the plain version pads the last
  // tile with the cloud's last row, which changes neither)
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, s));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, s));
  }
  __shared__ float wlo[kWarps], whi[kWarps];
  if ((t & 31) == 0) {
    wlo[t >> 5] = lo;
    whi[t >> 5] = hi;
  }
  __syncthreads();
  if (t != 0) return;
  int first = 0, end = nchunks;
  if (!full && *sorted_ok) {
    for (int w = 1; w < kWarps; ++w) {
      lo = fminf(lo, wlo[w]);
      hi = fmaxf(hi, whi[w]);
    }
    const float radius = st->threshold;
    first = search_left(chunk_hi, nchunks, lo - radius);
    end = search_right(chunk_lo, nchunks, hi + radius);
  }
  c0[b] = first;
  c1[b] = end;
  int* const slot = ranges + 2 * (size_t)st->slot * gridDim.x;
  slot[b] = first;
  slot[gridDim.x + b] = end;
}

__global__ void __launch_bounds__(kTile)
icp_terms_kernel(const float* __restrict__ p,             // (n, 3)
                 const bool* __restrict__ smask,           // (n,)
                 const float* __restrict__ dst,            // (>= m, 3)
                 const float* __restrict__ nrm,            // (m, 3)
                 const float* __restrict__ best_d,         // K4's (n,)
                 const long long* __restrict__ best_i,
                 int n, int m,
                 float* __restrict__ J,                    // (n, 6)
                 float* __restrict__ Jw,                   // (n, 6)
                 float* __restrict__ r,                    // (n,)
                 float* __restrict__ dd,                   // (n,)
                 PairState* __restrict__ st) {
  const int t = threadIdx.x, i = blockIdx.x * kTile + t;
  const float threshold = st->threshold;
  int nv = 0, nin = 0;
  if (i < n) {
    const float px = p[3 * (size_t)i], py = p[3 * (size_t)i + 1],
                pz = p[3 * (size_t)i + 2];
    const bool valid = smask[i];
    const long long bi = best_i[i];
    // the winning pair's exact distance (nn.py's tail: sum(diff * diff))
    const long long k = bi < m ? bi : 0;
    const float e0 = px - dst[3 * k], e1 = py - dst[3 * k + 1],
                e2 = pz - dst[3 * k + 2];
    const float bd = best_d[i];
    float d2 = bd >= 0.5f * kBig ? bd : (e0 * e0 + e2 * e2) + e1 * e1;
    d2 = valid ? d2 : 0.0f;
    const float d = sqrtf(clamp_min(d2, 0.0f));
    const bool inl = valid && d < threshold;
    nv = valid;
    nin = inl;
    dd[i] = inl ? d * d : 0.0f;
    // the step's terms at the correspondence where(smask, best_i, 0)
    const long long j = valid ? k : 0;
    const float qx = dst[3 * j], qy = dst[3 * j + 1], qz = dst[3 * j + 2];
    const float nx = nrm[3 * j], ny = nrm[3 * j + 1], nz = nrm[3 * j + 2];
    const float a0 = (px - qx) * nx, a1 = (py - qy) * ny,
                a2 = (pz - qz) * nz;
    r[i] = (a0 + a2) + a1;
    const float row[6] = {fmaf(py, nz, -(pz * ny)), fmaf(pz, nx, -(px * nz)),
                          fmaf(px, ny, -(py * nx)), nx, ny, nz};
    const float w = inl ? 1.0f : 0.0f;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      J[6 * (size_t)i + c] = row[c];
      Jw[6 * (size_t)i + c] = row[c] * w;
    }
  }
  // the block's counts, added to the pair's (integers: any order is exact)
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    nv += __shfl_xor_sync(0xffffffffu, nv, s);
    nin += __shfl_xor_sync(0xffffffffu, nin, s);
  }
  __shared__ int wnv[kWarps], wnin[kWarps];
  if ((t & 31) == 0) {
    wnv[t >> 5] = nv;
    wnin[t >> 5] = nin;
  }
  __syncthreads();
  if (t != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    nv += wnv[w];
    nin += wnin[w];
  }
  atomicAdd(&st->nv, nv);
  atomicAdd(&st->nin, nin);
}

// One thread: the metrics of the pose T just evaluated (counts from the
// terms kernel, sdd = torch.sum of d^2), the best pose, the loop's
// condition at the state's iteration; T copied to `cur`, where the next
// step starts from; while the condition holds the damped system, Ad
// column-major and b, for the solve, and the next iteration, else the
// stage's result in the state and the next stage's iteration 0.
__global__ void icp_eval_kernel(PairState* __restrict__ st,
                                const float* __restrict__ T,
                                const float* __restrict__ sdd,
                                const float* __restrict__ A,   // J_w^T J
                                const float* __restrict__ g,   // J_w^T r
                                int max_iterations, float rel_fit,
                                float rel_rmse, float* __restrict__ Ad,
                                float* __restrict__ b,
                                float* __restrict__ cur) {
  const int it = st->it;
  const int nv = st->nv, nin = st->nin;
  st->nv = st->nin = 0;
  const float fit = (float)nin / (float)max(nv, 1);
  const float rmse = sqrtf(*sdd / (float)max(nin, 1));
  if (it == 0 || rmse < st->best_rmse) {
    for (int k = 0; k < 16; ++k) st->best_T[k] = T[k];
    st->best_fit = fit;
    st->best_rmse = rmse;
  }
  const bool keep =
      it < max_iterations &&
      (it < 2 || fabsf(st->prev_fit - fit) > rel_fit ||
       fabsf(st->prev_rmse - rmse) > rel_rmse);
  for (int k = 0; k < 16; ++k) cur[k] = T[k];
  st->keep = keep;
  st->slot += 1;
  if (!keep) {
    const bool use_best = fit < kFallbackFitness;   // collapsed
    for (int k = 0; k < 16; ++k) st->T[k] = use_best ? st->best_T[k] : T[k];
    st->fit = use_best ? st->best_fit : fit;
    st->rmse = use_best ? st->best_rmse : rmse;
    st->it = 0;
    return;
  }
  st->it = it + 1;
  st->prev_fit = fit;
  st->prev_rmse = rmse;
  // A + (1e-3 tr(A) / 6 + 1e-9) I, b = -g
  const float tr = ((A[0] + A[28]) + A[14]) + ((A[7] + A[35]) + A[21]);
  const float lam = 1e-3f * tr * (1.0f / 6.0f) + 1e-9f;
  for (int r = 0; r < 6; ++r) {
    for (int c = 0; c < 6; ++c)
      Ad[r + 6 * c] = A[6 * r + c] + lam * (r == c ? 1.0f : 0.0f);
    b[r] = -g[r];
  }
}

// One thread: the solve's x clamped to kStepClamp (rad and m) into xs, and
// R = I + [w]x of its rotation part, column-major, for the SVD projection.
__global__ void icp_rotation_kernel(const float* __restrict__ x,
                                    float* __restrict__ xs,
                                    float* __restrict__ R) {
  const float rot = sqrtf((x[0] * x[0] + x[2] * x[2]) + x[1] * x[1]);
  const float tn = sqrtf((x[3] * x[3] + x[5] * x[5]) + x[4] * x[4]);
  float scale = nan_min(kStepClamp / clamp_min(rot, 1e-9f),
                        kStepClamp / clamp_min(tn, 1e-9f));
  scale = scale > 1.0f ? 1.0f : scale;                 // clamp(max=1)
  for (int k = 0; k < 6; ++k) xs[k] = x[k] * scale;
  const float wx = xs[0], wy = xs[1], wz = xs[2];
  const float m[9] = {1.0f, wz, -wy, -wz, 1.0f, wx, wy, -wx, 1.0f};
  for (int k = 0; k < 9; ++k) R[k] = m[k];
}

// One thread: dT = [Rn | t; 0 0 0 1], t the clamped step's translation.
__global__ void icp_dt_kernel(const float* __restrict__ Rn,
                              const float* __restrict__ xs,
                              float* __restrict__ dT) {
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) dT[4 * r + c] = Rn[3 * r + c];
    dT[4 * r + 3] = xs[3 + r];
  }
  dT[12] = dT[13] = dT[14] = 0.0f;
  dT[15] = 1.0f;
}

}  // namespace

extern "C" int otslam_icp_prep(const void* src, const void* T,
                               const void* chunk_lo, const void* chunk_hi,
                               const void* sorted_ok, int n, int nchunks,
                               int axis, const void* state, int full,
                               void* p, void* c0, void* c1, void* ranges,
                               void* stream) {
  if (n <= 0 || axis < 0 || axis > 2) return (int)cudaErrorInvalidValue;
  icp_prep_kernel<<<(n + kTile - 1) / kTile, kTile, 0,
                    (cudaStream_t)stream>>>(
      (const float*)src, (const float*)T, (const float*)chunk_lo,
      (const float*)chunk_hi, (const bool*)sorted_ok, n, nchunks, axis,
      (const PairState*)state, full, (float*)p, (int*)c0, (int*)c1,
      (int*)ranges);
  return (int)cudaGetLastError();
}

extern "C" int otslam_icp_terms(const void* p, const void* smask,
                                const void* dst, const void* nrm,
                                const void* best_d, const void* best_i, int n,
                                int m, void* J, void* Jw, void* r, void* dd,
                                void* state, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  icp_terms_kernel<<<(n + kTile - 1) / kTile, kTile, 0,
                     (cudaStream_t)stream>>>(
      (const float*)p, (const bool*)smask, (const float*)dst,
      (const float*)nrm, (const float*)best_d, (const long long*)best_i, n, m,
      (float*)J, (float*)Jw, (float*)r, (float*)dd, (PairState*)state);
  return (int)cudaGetLastError();
}

extern "C" int otslam_icp_eval(void* state, const void* T, const void* sdd,
                               const void* A, const void* g,
                               int max_iterations, float rel_fit,
                               float rel_rmse, void* Ad, void* b, void* cur,
                               void* stream) {
  icp_eval_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (PairState*)state, (const float*)T, (const float*)sdd,
      (const float*)A, (const float*)g, max_iterations, rel_fit, rel_rmse,
      (float*)Ad, (float*)b, (float*)cur);
  return (int)cudaGetLastError();
}

extern "C" int otslam_icp_rotation(const void* x, void* xs, void* R,
                                   void* stream) {
  icp_rotation_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)xs, (float*)R);
  return (int)cudaGetLastError();
}

extern "C" int otslam_icp_dt(const void* Rn, const void* xs, void* dT,
                             void* stream) {
  icp_dt_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const float*)Rn, (const float*)xs, (float*)dT);
  return (int)cudaGetLastError();
}
