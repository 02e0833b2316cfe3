// Kernel K2: per-(frame, block) classification for block-sparse TSDF fusion.
//
// Replaces otslam_tpu/kernels/tsdf_pallas.py::_make_classify_kernel (launched
// by _classify_blocks). Contract: bit-identical `band` and `visible` to the
// plain version, otslam_tpu_torch/kernels/tsdf_block.py::_active_blocks,
// which mirrors otslam_tpu/kernels/tsdf_block.py::_active_blocks.
//
// What bounds it on the card: writes of 2 bytes per (frame, block) and one
// 32-byte mip-table row read per pair; at 64 frames x 32768 blocks that is
// ~4 MB written and ~67 MB of (mostly L2-resident) table rows — memory- and
// latency-bound, microseconds of work. Design: one thread per pair (blocks
// on x, frames on y) and a direct load of the packed (th*tw, 8) mip row; the
// TPU kernel's one-hot MXU select and bf16 planes exist only because element
// gathers are slow on a TPU.
//
// Rounding: built with -fmad=false, and every constant arrives already
// rounded to f32 the way the JAX graph forms it (see classify_constants), so
// each product, sum and quotient rounds exactly as the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTile = 16.0f;   // level-0 mip tile edge (MIP_TILE)

__global__ void __launch_bounds__(kThreads)
classify_kernel(const float* __restrict__ table,    // (N, th*tw, 8)
                const float* __restrict__ gbounds,  // (N, 2) gmin, gmax
                const float* __restrict__ ext,      // (N, 12) rows of E[:3]
                uint8_t* __restrict__ band,         // (N, nb)
                uint8_t* __restrict__ visible,      // (N, nb)
                int nb, int gby, int gbz, int th, int tw, int width,
                int height, float ox, float oy, float oz, float vs,
                float half, float r, float r_half, float slack_num, float fx,
                float fy, float cx, float cy, float trunc) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  const int f = blockIdx.y;
  if (b >= nb) return;

  const int ix = b / (gby * gbz);
  const int iy = (b / gbz) % gby;
  const int iz = b % gbz;
  // origin + (i * 8) * vs + half, left to right
  const float bx = (ox + ((float)ix * 8.0f) * vs) + half;
  const float by = (oy + ((float)iy * 8.0f) * vs) + half;
  const float bz = (oz + ((float)iz * 8.0f) * vs) + half;

  const float* e = ext + (size_t)f * 12;
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

  // truncate toward zero, then clip (the pre-clamp keeps the cast defined)
  int tu0 = (int)fminf(fmaxf(u / kTile, -1.0f), (float)tw);
  int tv0 = (int)fminf(fmaxf(v / kTile, -1.0f), (float)th);
  tu0 = min(max(tu0, 0), tw - 1);
  tv0 = min(max(tv0, 0), th - 1);
  const float* row = table + ((size_t)f * th * tw + (size_t)tv0 * tw + tu0) * 8;

  const bool l1 = slack > kTile;
  const bool l2 = slack > 2.0f * kTile;
  const bool too_big = slack > 4.0f * kTile;
  float bmin = l2 ? row[4] : (l1 ? row[2] : row[0]);
  float bmax = l2 ? row[5] : (l1 ? row[3] : row[1]);
  if (too_big) {
    bmin = gbounds[2 * f];
    bmax = gbounds[2 * f + 1];
  }

  const bool has_depth = bmax > 0.0f;
  const bool vis = in_frustum && has_depth && (pz - r <= bmax + trunc);
  const bool bnd = vis && (pz + r >= bmin - trunc);
  const size_t o = (size_t)f * nb + b;
  band[o] = bnd ? 1 : 0;
  visible[o] = vis ? 1 : 0;
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
  const dim3 grid((nb + kThreads - 1) / kThreads, n_frames);
  classify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const float*)gbounds, (const float*)ext,
      (uint8_t*)band, (uint8_t*)visible, nb, gby, gbz, th, tw, width, height,
      ox, oy, oz, vs, half, r, r_half, slack_num, fx, fy, cx, cy, trunc);
  return (int)cudaGetLastError();
}
