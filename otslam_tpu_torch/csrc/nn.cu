// Kernels K3 and K4: brute-force nearest neighbour (squared distance and
// index), over the whole destination (K3) or over a chunk range per source
// tile (K4).
//
// K3 replaces otslam_tpu/kernels/nn.py::_make_nn_kernel (launched by
// _nn_min_pallas_slab / _nn_min_pallas, behind nn_distance and
// chamfer_metrics). Contract: the exact path it stands in for,
// nn._nn_min_xla, whose plain PyTorch version is
// otslam_tpu_torch/kernels/nn.py::nn_min_torch — the minimum squared
// distance over valid destination points and the LOWEST index among ties;
// all destinations masked gives (3e38, 0).
//
// K4 replaces otslam_tpu/kernels/nn.py::_make_nn_kernel_windowed (launched
// by _nn_min_windowed, behind nn_distance_radius: ICP, trajectory
// refinement, scan localization, the eval's GT alignment). The destination
// is sorted on one axis and padded to whole 1024-row chunks; source tile b
// (256 rows, one thread block) scans only chunks [c0[b], c1[b]), the
// chunks whose sort-coordinate span meets the tile's span +- radius
// (computed on the device by nn.py::window_ranges). Its plain version is
// nn.py::nn_min_windowed_torch: the same minimum over that range, (3e38, 0)
// when the range holds no valid destination. Unlike the TPU kernel, the
// range is exact per tile (no fixed window width, no fit flag and no
// fall-back to the full kernel), so the result is exact for every source
// point whose nearest neighbour lies within the radius, and >= the true
// distance for every other.
//
// What bounds them on the card: arithmetic, ~9 f32 operations per
// (source, destination) pair — 100k x 50k pairs is ~45 GFLOP of plain f32
// (no tensor cores), about 0.7 ms at the H100's published f32 rate; memory
// traffic is tiny. K4 does the same work per pair and scans a fraction of
// the pairs. Design: one thread per source point, 256 per block;
// destination points are staged through shared memory in chunks of
// (x, y, z, valid) float4s that every thread then reads as a broadcast.
// (x - y)^2 is taken directly in f32, so there is no |a|^2 + |b|^2 - 2ab
// cancellation and no hi/lo operand split as on the TPU. Strict `<` over
// ascending indices keeps the lowest index on ties.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // source rows per block (nn._SRC_TILE)
constexpr int kChunk = 2048;      // K3's shared-memory stage
constexpr int kWinChunk = 1024;   // K4's window chunk (nn._DST_CHUNK)
constexpr float kBig = 3.0e38f;   // nn._BIG

// Scans destinations [lo, hi) through a shared-memory stage of STAGE
// float4s, updating (bd, bi) in ascending index order. Every thread of the
// block calls it with the same lo and hi.
template <int STAGE>
__device__ __forceinline__ void scan_range(float sx, float sy, float sz,
                                           const float4* __restrict__ dst,
                                           int lo, int hi, float4* stage,
                                           float& bd, int& bi) {
  for (int base = lo; base < hi; base += STAGE) {
    const int cnt = min(STAGE, hi - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kThreads) stage[j] = dst[base + j];
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float4 q = stage[j];
      const float dx = sx - q.x;
      const float dy = sy - q.y;
      const float dz = sz - q.z;
      const float d2 = (dx * dx + dy * dy) + dz * dz;
      if (q.w != 0.0f && d2 < bd) {
        bd = d2;
        bi = base + j;
      }
    }
  }
}

__device__ __forceinline__ void load_src(const float* __restrict__ src,
                                         int i, int n, float& sx, float& sy,
                                         float& sz) {
  sx = sy = sz = 0.0f;
  if (i < n) {
    sx = src[3 * (size_t)i];
    sy = src[3 * (size_t)i + 1];
    sz = src[3 * (size_t)i + 2];
  }
}

__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ src,    // (n, 3)
          const float4* __restrict__ dst,   // (m,) x, y, z, valid (1 or 0)
          int n, int m, float* __restrict__ best_d,
          int* __restrict__ best_i) {
  __shared__ float4 stage[kChunk];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float sx, sy, sz;
  load_src(src, i, n, sx, sy, sz);
  float bd = kBig;
  int bi = 0;
  scan_range<kChunk>(sx, sy, sz, dst, 0, m, stage, bd, bi);
  if (i < n) {
    best_d[i] = bd;
    best_i[i] = bi;
  }
}

__global__ void __launch_bounds__(kThreads)
nn_window_kernel(const float* __restrict__ src,   // (n, 3)
                 const float4* __restrict__ dst,  // (mp,), mp % 1024 == 0
                 const int* __restrict__ c0,      // (ceil(n / 256),)
                 const int* __restrict__ c1,
                 int n, int mp, float* __restrict__ best_d,
                 int* __restrict__ best_i) {
  __shared__ float4 stage[kWinChunk];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float sx, sy, sz;
  load_src(src, i, n, sx, sy, sz);
  // the range is the block's own: every thread reads the same two words
  const int lo = max(c0[blockIdx.x], 0) * kWinChunk;
  const int hi = min(c1[blockIdx.x] * kWinChunk, mp);
  float bd = kBig;
  int bi = 0;
  scan_range<kWinChunk>(sx, sy, sz, dst, lo, hi, stage, bd, bi);
  if (i < n) {
    best_d[i] = bd;
    best_i[i] = bi;
  }
}

}  // namespace

extern "C" int otslam_nn(const void* src, const void* dst, int n, int m,
                         void* best_d, void* best_i, void* stream) {
  if (n > 0) {
    nn_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                (cudaStream_t)stream>>>((const float*)src, (const float4*)dst,
                                        n, m, (float*)best_d, (int*)best_i);
  }
  return (int)cudaGetLastError();
}

extern "C" int otslam_nn_window(const void* src, const void* dst,
                                const void* c0, const void* c1, int n, int mp,
                                void* best_d, void* best_i, void* stream) {
  if (n > 0) {
    nn_window_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(
        (const float*)src, (const float4*)dst, (const int*)c0,
        (const int*)c1, n, mp, (float*)best_d, (int*)best_i);
  }
  return (int)cudaGetLastError();
}
