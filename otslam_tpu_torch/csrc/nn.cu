// Kernel K3: brute-force nearest neighbour (squared distance and index).
//
// Replaces otslam_tpu/kernels/nn.py::_make_nn_kernel (launched by
// _nn_min_pallas_slab / _nn_min_pallas, behind nn_distance and
// chamfer_metrics). Contract: the exact path it stands in for,
// nn._nn_min_xla, whose plain PyTorch version is
// otslam_tpu_torch/kernels/nn.py::nn_min_torch — the minimum squared
// distance over valid destination points and the LOWEST index among ties;
// all destinations masked gives (3e38, 0).
//
// What bounds it on the card: arithmetic, ~9 f32 operations per
// (source, destination) pair — 100k x 50k pairs is ~45 GFLOP of plain f32
// (no tensor cores), about 0.7 ms at the H100's published f32 rate; memory
// traffic is tiny. Design: one thread per source point, 256 per block;
// destination points are staged through shared memory in chunks of 2048
// (x, y, z, valid) float4s (32 KB) that every thread then reads as a
// broadcast. (x - y)^2 is taken directly in f32, so there is no
// |a|^2 + |b|^2 - 2ab cancellation and no hi/lo operand split as on the TPU.
// Strict `<` over ascending indices keeps the lowest index on ties.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;
constexpr float kBig = 3.0e38f;  // nn._BIG

__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ src,    // (n, 3)
          const float4* __restrict__ dst,   // (m,) x, y, z, valid (1 or 0)
          int n, int m, float* __restrict__ best_d,
          int* __restrict__ best_i) {
  __shared__ float4 stage[kChunk];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  if (i < n) {
    sx = src[3 * (size_t)i];
    sy = src[3 * (size_t)i + 1];
    sz = src[3 * (size_t)i + 2];
  }
  float bd = kBig;
  int bi = 0;
  for (int base = 0; base < m; base += kChunk) {
    const int cnt = min(kChunk, m - base);
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
