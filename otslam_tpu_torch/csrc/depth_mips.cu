// K2's depth-mip pass: the dilated min/max depth pyramid that block
// classification reads, packed one 8-float row a level-0 tile.
//
// Replaces the XLA graph otslam_tpu/kernels/tsdf_block.py::_depth_mips
// (and depth_mip_planes' global bounds), which feeds the Pallas classify
// kernel. Contract: the (N, th*tw, 8) table
// [dmin0, dmax0, dmin1, dmax1, dmin2, dmax2, 0, 0] and the per-frame
// (gmin, gmax) = (min of column 4, max of column 5) equal, bit for bit, the
// plain version otslam_tpu_torch/kernels/tsdf_cuda.py::depth_mips_torch
// (tsdf_block._depth_mips and two reductions).
//
// What bounds it on the card: reading the frames once (1.2 MB a VGA
// frame, 78.6 MB at 64 frames; the table is 38 KB a frame), so bytes.
// Design, two launches:
//   1. mips_tile_kernel, one CTA per (tile row, frame): its threads stream
//      the tile row's 16 pixel rows as 4-pixel quads (a float4 where the
//      rows are 16-byte aligned) and reduce each 16-pixel tile over the 4
//      lanes that hold its quads; it writes the raw level-0 (min, max).
//      Many CTAs a frame, so one frame also spreads over the card.
//   2. mips_finish_kernel, one CTA per frame on the small th x tw grid in
//      shared memory: the 3x3 dilation, the 2x and 4x coarsening from the
//      dilated level 0, their own 3x3 dilations, the bf16 rounding, the
//      table rows and the global bounds.
//
// Exactness: min and max are exact in any order, and every padded cell of
// the plain version (the zero-depth pixels past H and W, MIP_BIG / 0 past
// the tile grid in the dilations and the coarsening) takes part in the
// same reductions here, so the result does not depend on the order. An
// inf depth is valid (d > 0) and MIP_BIG does not absorb it: reductions
// start from +-inf. The only rounding is bf16_conservative.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;            // level-0 tile edge in pixels (MIP_TILE)
constexpr float kBig = 1.0e30f;      // MIP_BIG: the min of a tile without depth
constexpr int kTileThreads = 256;    // most threads of a tile-row CTA
constexpr int kFinishThreads = 512;
constexpr int kMaxShared = 232448;   // shared memory a block may opt in to

// one pixel's share of its tile's (min, max): invalid depth (<= 0, NaN)
// counts as MIP_BIG for the min and 0 for the max, as the plain version's
// torch.where
__device__ __forceinline__ void take(float d, float& mn, float& mx) {
  const bool valid = d > 0.0f;
  mn = fminf(mn, valid ? d : kBig);
  mx = fmaxf(mx, valid ? d : 0.0f);
}

template <bool kVec>
__global__ void __launch_bounds__(kTileThreads)
mips_tile_kernel(const float* __restrict__ depth,  // (N, H, W)
                 float2* __restrict__ raw,          // (N, th*tw) level 0
                 int H, int W, int th, int tw) {
  const int ty = blockIdx.x;
  const int f = blockIdx.y;
  const float* frame = depth + (size_t)f * H * W;
  const int quads = tw * (kTile / 4);
  // the trip count is the same for every thread, so whole warps reach the
  // shuffles below
  for (int q0 = 0; q0 < quads; q0 += blockDim.x) {
    const int q = q0 + threadIdx.x;
    const int x = 4 * q;
    float mn = INFINITY, mx = -INFINITY;
    if (q < quads) {
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const int y = ty * kTile + r;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // rows past H: no depth
        if (y < H) {
          const float* row = frame + (size_t)y * W;
          if (kVec && x < W) {                    // W % 4 == 0: whole quads
            const float4 p = __ldg(reinterpret_cast<const float4*>(row + x));
            v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
          } else if (!kVec) {
#pragma unroll
            for (int k = 0; k < 4; ++k) v[k] = x + k < W ? __ldg(row + x + k)
                                                         : 0.0f;
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) take(v[k], mn, mx);
      }
    }
    // a tile's 4 quads sit on 4 neighbouring lanes (blockDim and q0 are
    // multiples of 32, so q % 4 == lane % 4)
#pragma unroll
    for (int s = 1; s < 4; s <<= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, s));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
    }
    if (q < quads && (q & 3) == 0)
      raw[((size_t)f * th + ty) * tw + q / 4] = make_float2(mn, mx);
  }
}

// _bf16_conservative: pad = |v| * 2^-8 (exact), v -+ pad rounded once to
// f32, then rounded to nearest even into bf16 and widened back; a value
// that is not finite passes to the bf16 rounding unpadded
__device__ __forceinline__ float bf16_conservative(float v, bool is_max) {
  float w = v;
  if (isfinite(v)) {
    const float pad = __fmul_rn(fabsf(v), 0.00390625f);
    w = is_max ? __fadd_rn(v, pad) : __fsub_rn(v, pad);
  }
  return __bfloat162float(__float2bfloat16_rn(w));
}

// 3x3 (min, max) dilation of cell (y, x) of an h x w grid; cells past the
// edge count as (MIP_BIG, 0), the plain version's constant pad
__device__ __forceinline__ float2 dilate3(const float2* g, int h, int w,
                                          int y, int x) {
  float mn = INFINITY, mx = -INFINITY;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int yy = y + dy, xx = x + dx;
      if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
        const float2 p = g[yy * w + xx];
        mn = fminf(mn, p.x);
        mx = fmaxf(mx, p.y);
      } else {
        mn = fminf(mn, kBig);
        mx = fmaxf(mx, 0.0f);
      }
    }
  }
  return make_float2(mn, mx);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

__global__ void __launch_bounds__(kFinishThreads)
mips_finish_kernel(const float2* __restrict__ raw,   // (N, th*tw)
                   float* __restrict__ table,        // (N, th*tw, 8)
                   float* __restrict__ gbounds,      // (N, 2)
                   int th, int tw) {
  extern __shared__ float2 smem[];
  __shared__ float warp_bounds[2][kFinishThreads / 32];
  const int f = blockIdx.x;
  const int cells = th * tw;
  const int h1 = (th + 1) / 2, w1 = (tw + 1) / 2;   // level 1: 2x coarser
  const int h2 = (th + 3) / 4, w2 = (tw + 3) / 4;   // level 2: 4x coarser
  const int c1 = h1 * w1, c2 = h2 * w2;
  float2* dil0 = smem;          // level 0, dilated, not rounded
  float2* lv1 = dil0 + cells;   // level 1, then level 2: coarsened
  float2* lv2 = lv1 + c1;
  float2* out1 = lv2 + c2;      // levels 1 and 2 dilated and rounded
  float2* out2 = out1 + c1;
  const float2* r0 = raw + (size_t)f * cells;

  for (int i = threadIdx.x; i < cells; i += blockDim.x)
    dil0[i] = dilate3(r0, th, tw, i / tw, i % tw);
  __syncthreads();

  // _coarsen: each f x f block of the dilated level 0, padded past the
  // grid with (MIP_BIG, 0)
  for (int i = threadIdx.x; i < c1 + c2; i += blockDim.x) {
    const bool one = i < c1;
    const int j = one ? i : i - c1;
    const int fct = one ? 2 : 4;
    const int lw = one ? w1 : w2;
    const int y0 = (j / lw) * fct, x0 = (j % lw) * fct;
    float mn = INFINITY, mx = -INFINITY;
    for (int a = 0; a < fct; ++a) {
      for (int b = 0; b < fct; ++b) {
        const int y = y0 + a, x = x0 + b;
        if (y < th && x < tw) {
          const float2 p = dil0[y * tw + x];
          mn = fminf(mn, p.x);
          mx = fmaxf(mx, p.y);
        } else {
          mn = fminf(mn, kBig);
          mx = fmaxf(mx, 0.0f);
        }
      }
    }
    (one ? lv1 : lv2)[j] = make_float2(mn, mx);
  }
  __syncthreads();

  // each coarse level dilated at its own resolution, then rounded; the
  // global bounds are those of the rounded level 2 (every coarse cell
  // covers at least one level-0 tile, so the table's columns 4 and 5 hold
  // exactly these values)
  float gmin = INFINITY, gmax = -INFINITY;
  for (int i = threadIdx.x; i < c1 + c2; i += blockDim.x) {
    const bool one = i < c1;
    const int j = one ? i : i - c1;
    const int lh = one ? h1 : h2, lw = one ? w1 : w2;
    const float2 d = dilate3(one ? lv1 : lv2, lh, lw, j / lw, j % lw);
    const float2 o = make_float2(bf16_conservative(d.x, false),
                                 bf16_conservative(d.y, true));
    (one ? out1 : out2)[j] = o;
    if (!one) {
      gmin = fminf(gmin, o.x);
      gmax = fmaxf(gmax, o.y);
    }
  }
  gmin = warp_min(gmin);
  gmax = warp_max(gmax);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_bounds[0][warp] = gmin;
    warp_bounds[1][warp] = gmax;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x / 32;
    gmin = warp_min(lane < nw ? warp_bounds[0][lane] : INFINITY);
    gmax = warp_max(lane < nw ? warp_bounds[1][lane] : -INFINITY);
    if (lane == 0) {
      gbounds[2 * f] = gmin;
      gbounds[2 * f + 1] = gmax;
    }
  }

  // the table rows: 32 bytes a tile, two float4 stores
  float4* rows = reinterpret_cast<float4*>(table) + (size_t)f * cells * 2;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int y = i / tw, x = i % tw;
    const float2 a = dil0[i];
    const float2 b = out1[(y / 2) * w1 + x / 2];
    const float2 c = out2[(y / 4) * w2 + x / 4];
    rows[2 * i] = make_float4(bf16_conservative(a.x, false),
                              bf16_conservative(a.y, true), b.x, b.y);
    rows[2 * i + 1] = make_float4(c.x, c.y, 0.0f, 0.0f);
  }
}

}  // namespace

// shared memory of the finishing kernel for a th x tw tile grid
// (tsdf_cuda.mips_shared_bytes computes the same)
static long long finish_shared_bytes(int th, int tw) {
  const long long c1 = (long long)((th + 1) / 2) * ((tw + 1) / 2);
  const long long c2 = (long long)((th + 3) / 4) * ((tw + 3) / 4);
  return ((long long)th * tw + 2 * c1 + 2 * c2) * (long long)sizeof(float2);
}

extern "C" int otslam_depth_mips(const void* depth, void* raw, void* table,
                                 void* gbounds, int n_frames, int H, int W,
                                 int th, int tw, void* stream) {
  const long long shared = finish_shared_bytes(th, tw);
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int quads = tw * (kTile / 4);
  int threads = (quads + 31) / 32 * 32;
  if (threads > kTileThreads) threads = kTileThreads;
  const dim3 grid(th, n_frames);
  const bool vec = W % 4 == 0 && (uintptr_t)depth % 16 == 0;
  if (vec)
    mips_tile_kernel<true><<<grid, threads, 0, s>>>(
        (const float*)depth, (float2*)raw, H, W, th, tw);
  else
    mips_tile_kernel<false><<<grid, threads, 0, s>>>(
        (const float*)depth, (float2*)raw, H, W, th, tw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(mips_finish_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  mips_finish_kernel<<<n_frames, kFinishThreads, (size_t)shared, s>>>(
      (const float2*)raw, (float*)table, (float*)gbounds, th, tw);
  return (int)cudaGetLastError();
}
