// Kernel K2: per-(frame, block) classification for block-sparse TSDF fusion.
//
// Replaces otslam_tpu/kernels/tsdf_pallas.py::_make_classify_kernel (launched
// by _classify_blocks). Contract: bit-identical `band` and `visible` to the
// plain version, otslam_tpu_torch/kernels/tsdf_block.py::_active_blocks,
// which mirrors otslam_tpu/kernels/tsdf_block.py::_active_blocks. Its mip
// table and global bounds come from the mip pass (depth_mips.cu).
//
// What bounds it on the card: the writes of 2 bytes per (frame, block)
// (4.2 MB at 64 frames x 32768 blocks) and the mip table's reads, so
// bytes, a few microseconds; the ~60 operations a pair (three of them IEEE
// divisions) come close behind. Design: one thread per block and
// kFrames frames, so the block centre and its integer decomposition are
// computed once for all of them; the frames' extrinsics and global bounds
// staged in shared memory; a pair outside the frustum reads no table row
// (both outputs are false whatever the row holds), one inside reads one
// 8-byte (min, max) pair of its level; torch.bool outputs written
// directly, each warp storing 32 neighbouring bytes a frame. The TPU
// kernel's one-hot MXU select and bf16 planes exist only because element
// gathers are slow on a TPU.
//
// Rounding: built with -fmad=false, and every constant arrives already
// rounded to f32 the way the JAX graph forms it (see classify_constants), so
// each product, sum and quotient rounds exactly as the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 8;        // frames a thread (grid.y = ceil(N / 8))
constexpr float kTile = 16.0f;    // level-0 mip tile edge (MIP_TILE)

__global__ void __launch_bounds__(kThreads)
classify_kernel(const float* __restrict__ table,    // (N, th*tw, 8)
                const float* __restrict__ gbounds,  // (N, 2) gmin, gmax
                const float* __restrict__ ext,      // (N, 4, 4) world->camera
                bool* __restrict__ band,            // (N, nb)
                bool* __restrict__ visible,         // (N, nb)
                int n_frames, int nb, int gby, int gbz, int th, int tw,
                int width, int height, float ox, float oy, float oz,
                float vs, float half, float r, float r_half, float slack_num,
                float fx, float fy, float cx, float cy, float trunc) {
  __shared__ float s_ext[kFrames * 12];
  __shared__ float s_gb[kFrames * 2];
  const int f0 = blockIdx.y * kFrames;
  const int nf = min(kFrames, n_frames - f0);
  // rows 0-2 of each 4 x 4 extrinsic, its first 12 floats
  for (int i = threadIdx.x; i < nf * 12; i += kThreads)
    s_ext[i] = ext[(size_t)(f0 + i / 12) * 16 + i % 12];
  for (int i = threadIdx.x; i < nf * 2; i += kThreads)
    s_gb[i] = gbounds[(size_t)f0 * 2 + i];
  __syncthreads();

  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= nb) return;
  const int ix = b / (gby * gbz);
  const int iy = (b / gbz) % gby;
  const int iz = b % gbz;
  // origin + (i * 8) * vs + half, left to right
  const float bx = (ox + ((float)ix * 8.0f) * vs) + half;
  const float by = (oy + ((float)iy * 8.0f) * vs) + half;
  const float bz = (oz + ((float)iz * 8.0f) * vs) + half;

  for (int k = 0; k < nf; ++k) {
    const int f = f0 + k;
    const float* e = s_ext + 12 * k;
    const float px = ((e[0] * bx + e[1] * by) + e[2] * bz) + e[3];
    const float py = ((e[4] * bx + e[5] * by) + e[6] * bz) + e[7];
    const float pz = ((e[8] * bx + e[9] * by) + e[10] * bz) + e[11];

    const bool in_front = pz > r_half;
    const float zsafe = pz > 1e-6f ? pz : 1e-6f;
    const float u = (fx * px) / zsafe + cx;
    const float v = (fy * py) / zsafe + cy;
    const float slack = slack_num / zsafe + 1.0f;
    const bool in_frustum = in_front && (u + slack >= 0.0f) &&
                            (u - slack < (float)width) &&
                            (v + slack >= 0.0f) && (v - slack < (float)height);

    bool vis = false, bnd = false;
    if (in_frustum) {
      float bmin, bmax;
      if (slack > 4.0f * kTile) {          // too big: the global bounds
        bmin = s_gb[2 * k];
        bmax = s_gb[2 * k + 1];
      } else {
        // truncate toward zero, then clip (the pre-clamp keeps the cast
        // defined); u * 2^-4 rounds exactly as the plain version's u / 16,
        // both being the correctly rounded value of the same real number
        int tu0 = (int)fminf(fmaxf(u * 0.0625f, -1.0f), (float)tw);
        int tv0 = (int)fminf(fmaxf(v * 0.0625f, -1.0f), (float)th);
        tu0 = min(max(tu0, 0), tw - 1);
        tv0 = min(max(tv0, 0), th - 1);
        const int level = slack > 2.0f * kTile ? 2 : (slack > kTile ? 1 : 0);
        const float2 m = __ldg(reinterpret_cast<const float2*>(
            table + ((size_t)f * th * tw + (size_t)tv0 * tw + tu0) * 8) +
            level);
        bmin = m.x;
        bmax = m.y;
      }
      const bool has_depth = bmax > 0.0f;
      vis = has_depth && (pz - r <= bmax + trunc);
      bnd = vis && (pz + r >= bmin - trunc);
    }
    const size_t o = (size_t)f * nb + b;
    band[o] = bnd;
    visible[o] = vis;
  }
}

}  // namespace

extern "C" int otslam_classify(const void* table, const void* gbounds,
                               const void* ext, void* band, void* visible,
                               int n_frames, int nb, int gby, int gbz, int th,
                               int tw, int width, int height, float ox,
                               float oy, float oz, float vs, float half,
                               float r, float r_half, float slack_num,
                               float fx, float fy, float cx, float cy,
                               float trunc, void* stream) {
  const dim3 grid((nb + kThreads - 1) / kThreads,
                  (n_frames + kFrames - 1) / kFrames);
  classify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const float*)gbounds, (const float*)ext,
      (bool*)band, (bool*)visible, n_frames, nb, gby, gbz, th, tw, width,
      height, ox, oy, oz, vs, half, r, r_half, slack_num, fx, fy, cx, cy,
      trunc);
  return (int)cudaGetLastError();
}
