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
// (256 rows) scans only chunks [c0[b], c1[b]), the chunks whose
// sort-coordinate span meets the tile's span +- radius (computed on the
// device by nn.py::window_ranges). Its plain version is
// nn.py::nn_min_windowed_torch: the same minimum over that range, (3e38, 0)
// when the range holds no valid destination. The range is exact per tile
// (no fixed window width, no fit flag and no fall-back to the full kernel),
// so the result is exact for every source point whose nearest neighbour
// lies within the radius, and >= the true distance for every other. K3 is
// the same scan with the range [0, m) for every tile.
//
// What bounds them on the card: instruction throughput, not memory. Every
// (source, destination) pair costs 8 f32 operations (3 differences, 3
// squares, 2 sums) and the running minimum; the bytes are a few MB. With
// -fmad=false (the card check is bit-identity with the plain versions,
// which round once per operation) K4's scan issues about 11 lane
// instructions a pair (a compare and two selects after the 8) and K3's
// about 9.3 (its group minimum below), not counting shared-memory loads and
// loop overhead. At 132 SMs x 128 lanes x 1.98 GHz, K3's 100k x 50k pairs
// then take >= ~1.4 ms, against a bound of 0.6 ms from the published f32
// rate (which counts an FMA as two operations). At the paths' own shapes
// the source alone is too small to fill the card: the localizer's 1440
// points are 6 tiles, a pair-ICP frame's 19200 are 75.
//
// Design:
// - one block per 256-row source tile, each thread holding kRows = 2 source
//   points in registers, so one shared-memory read of a destination serves
//   2 pairs. (With 4, a 64-thread block, the eval's 391 blocks leave 4-6
//   warps on an SM, too few for its 4 schedulers: 3.0 ms against 2.3 ms at
//   100k x 50k on an H100 80GB HBM3, chip_smoke.py phase 3.)
// - K3 takes the least d2 of each group of 4 destinations with fminf and
//   looks for its index only when it beats the running minimum, ~9.3
//   instructions a pair instead of ~11 (scan_tile's kGroupMin);
// - the mask is folded into the staging: a masked destination is staged as
//   +inf coordinates, whose d^2 (inf) never passes `d2 < bd` with bd
//   starting at 3e38, so the inner loop has no validity test and reads dst
//   (m, 3) and the bool mask as they are;
// - double-buffered staging: the global loads of stage k+1 are started into
//   registers before stage k is scanned and land in the other shared buffer
//   after it, one barrier a stage. (cp.async and TMA cannot apply the mask
//   fold in flight; with them it would take a second pass over shared
//   memory and a second barrier a stage.)
// - when the tiles alone give fewer than 2 blocks an SM, the host splits
//   each tile's range over S blocks (gridDim.y; nn.py::split_count), enough
//   for ~8 blocks an SM: many short blocks also even out tiles whose K4
//   ranges differ (pair ICP: 0.067 ms at S = 15 against 0.093-0.116 ms at
//   S = 4, H100 80GB HBM3, chip_smoke.py phase 5). Each block writes
//   the 64-bit key (bits(d2) << 32) | index of its rows into an (S, n)
//   scratch, and nn_merge_kernel takes the least key of each row: d2 >= +0,
//   so its bits order as the floats do, and the least key is the least d2
//   and, among equal d2, the least index — the lowest-index rule whatever
//   the order in which the blocks ran. With S = 1 the scan writes the
//   result itself.
// - the index is written as int64, the wrapper's dtype.
//
// Not used: tensor cores. wgmma needs the |a|^2 + |b|^2 - 2ab form, which
// loses a near neighbour to cancellation: at |p| ~ 3 m, |p|^2 ~ 9 m^2 and
// an f32 ulp is ~1e-6 m^2, against (4 mm)^2 = 1.6e-5 m^2 (the TPU kernel
// needed a 3-way bf16 operand split for this). FMA contraction would cut
// the arithmetic from 8 to 6 instructions a pair but round otherwise than
// the plain version. Strict `<` over ascending indices keeps the lowest
// index on ties within a block.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;                  // source rows a block, nn.SRC_TILE
constexpr int kRows = 2;                    // source rows a thread
constexpr int kGroup = 4;                   // destinations a min-reduction
constexpr int kThreads = kTile / kRows;
constexpr int kStage = 512;                 // destination rows a stage
constexpr int kPer = kStage / kThreads;     // rows each thread stages
constexpr int kWinChunk = 1024;             // K4's window chunk (nn.DST_CHUNK)
constexpr float kBig = 3.0e38f;             // nn.BIG
static_assert(kGroup == 4 && kStage % kGroup == 0, "the scan's groups");

// ((dx*dx + dy*dy) + dz*dz), one rounding per operation (-fmad=false)
__device__ __forceinline__ float dist2(float x, float y, float z,
                                       float4 q) {
  const float dx = x - q.x;
  const float dy = y - q.y;
  const float dz = z - q.z;
  return (dx * dx + dy * dy) + dz * dz;
}

// Scans destinations [lo, hi) for this block's source tile and writes its
// result: (d2, index) when the launch has one split, else the 64-bit keys
// into parts[blockIdx.y]. Every thread of the block calls it with the same
// lo and hi. kGroupMin takes the least of each group of 4 destinations with
// fminf and finds its index only when it beats the running minimum: ~9.3
// instead of ~11 instructions a pair when improvements are rare, as in an
// unordered destination (K3). Over K4's sorted destination a source's
// minimum improves group after group as the scan nears it, and the
// per-pair compare-and-select form is faster there.
template <bool kGroupMin>
__device__ __forceinline__ void scan_tile(
    const float* __restrict__ src, const float* __restrict__ dst,
    const unsigned char* __restrict__ mask, int n, int lo, int hi,
    float* __restrict__ best_d, long long* __restrict__ best_i,
    unsigned long long* __restrict__ parts) {
  __shared__ float4 stage[2][kStage];
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kTile + t;
  float sx[kRows], sy[kRows], sz[kRows], bd[kRows];
  int bi[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = row0 + r * kThreads;
    const bool in = i < n;
    sx[r] = in ? src[3 * (size_t)i] : 0.0f;
    sy[r] = in ? src[3 * (size_t)i + 1] : 0.0f;
    sz[r] = in ? src[3 * (size_t)i + 2] : 0.0f;
    bd[r] = kBig;
    bi[r] = 0;
  }

  // this thread's share of a stage, in flight in registers
  float px[kPer], py[kPer], pz[kPer];
  unsigned char pm[kPer];
  auto fetch = [&](int base) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int j = base + t + p * kThreads;
      if (j < hi) {
        px[p] = dst[3 * (size_t)j];
        py[p] = dst[3 * (size_t)j + 1];
        pz[p] = dst[3 * (size_t)j + 2];
        pm[p] = mask[j];
      }
    }
  };
  // rows past hi are staged as +inf too, so a scan may read whole groups
  auto put = [&](float4* buf, int base) {
    const float inf = __int_as_float(0x7f800000);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      buf[t + p * kThreads] =
          base + t + p * kThreads < hi && pm[p]
              ? make_float4(px[p], py[p], pz[p], 0.0f)
              : make_float4(inf, inf, inf, 0.0f);
    }
  };

  int cur = 0;
  if (lo < hi) {
    fetch(lo);
    put(stage[0], lo);
  }
  __syncthreads();
  for (int base = lo; base < hi; base += kStage) {
    const int next = base + kStage;
    if (next < hi) fetch(next);
    const float4* q = stage[cur];
    const int cnt = min(kStage, hi - base);
    if constexpr (kGroupMin) {
      // groups of kGroup destinations: the group's least d2 by fminf (which
      // returns one of its operands), and only when it beats bd the first
      // destination of the group that has it
#pragma unroll 2
      for (int j = 0; j < cnt; j += kGroup) {
        float4 g[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) g[k] = q[j + k];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float d[kGroup];
#pragma unroll
          for (int k = 0; k < kGroup; ++k)
            d[k] = dist2(sx[r], sy[r], sz[r], g[k]);
          const float least = fminf(fminf(d[0], d[1]), fminf(d[2], d[3]));
          if (least < bd[r]) {
            bd[r] = least;
            bi[r] = base + j + (d[0] == least   ? 0
                                : d[1] == least ? 1
                                : d[2] == least ? 2
                                                : 3);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const float4 g = q[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float d2 = dist2(sx[r], sy[r], sz[r], g);
          if (d2 < bd[r]) {
            bd[r] = d2;
            bi[r] = base + j;
          }
        }
      }
    }
    if (next < hi) put(stage[cur ^ 1], next);
    __syncthreads();
    cur ^= 1;
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = row0 + r * kThreads;
    if (i >= n) continue;
    if (gridDim.y == 1) {
      best_d[i] = bd[r];
      best_i[i] = bi[r];
    } else {
      parts[(size_t)blockIdx.y * n + i] =
          ((unsigned long long)__float_as_uint(bd[r]) << 32) |
          (unsigned int)bi[r];
    }
  }
}

// [lo, hi) of split blockIdx.y of gridDim.y over the range [r0, r1)
__device__ __forceinline__ void split_range(int r0, int r1, int& lo,
                                            int& hi) {
  const int len = max(r1 - r0, 0);
  const int per = (len + (int)gridDim.y - 1) / (int)gridDim.y;
  lo = r0 + min((int)blockIdx.y * per, len);
  hi = r0 + min((int)(blockIdx.y + 1) * per, len);
}

__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ src,            // (n, 3)
          const float* __restrict__ dst,            // (m, 3)
          const unsigned char* __restrict__ mask,   // (m,) bool
          int n, int m, float* __restrict__ best_d,
          long long* __restrict__ best_i,
          unsigned long long* __restrict__ parts) { // (S, n) when S > 1
  int lo, hi;
  split_range(0, m, lo, hi);
  scan_tile<true>(src, dst, mask, n, lo, hi, best_d, best_i, parts);
}

__global__ void __launch_bounds__(kThreads)
nn_window_kernel(const float* __restrict__ src,           // (n, 3)
                 const float* __restrict__ dst,           // (mp, 3)
                 const unsigned char* __restrict__ mask,  // (mp,) bool
                 const int* __restrict__ c0,              // (ceil(n / 256),)
                 const int* __restrict__ c1,
                 int n, int mp, float* __restrict__ best_d,
                 long long* __restrict__ best_i,
                 unsigned long long* __restrict__ parts) {
  // the range is the tile's own: every thread reads the same two words
  int lo, hi;
  split_range(max(c0[blockIdx.x], 0) * kWinChunk,
              min(c1[blockIdx.x] * kWinChunk, mp), lo, hi);
  scan_tile<false>(src, dst, mask, n, lo, hi, best_d, best_i, parts);
}

// The least of each row's S keys, unpacked to (d2, index).
__global__ void nn_merge_kernel(const unsigned long long* __restrict__ parts,
                                int splits, int n, float* __restrict__ best_d,
                                long long* __restrict__ best_i) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned long long key = parts[i];
  for (int s = 1; s < splits; ++s) {
    const unsigned long long k = parts[(size_t)s * n + i];
    key = k < key ? k : key;
  }
  best_d[i] = __uint_as_float((unsigned int)(key >> 32));
  best_i[i] = (long long)(key & 0xffffffffull);
}

int merge(const void* parts, int splits, int n, void* best_d, void* best_i,
          cudaStream_t stream) {
  const int err = (int)cudaGetLastError();
  if (err != 0 || splits <= 1) return err;
  nn_merge_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      (const unsigned long long*)parts, splits, n, (float*)best_d,
      (long long*)best_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int otslam_nn(const void* src, const void* dst, const void* mask,
                         int n, int m, int splits, void* best_d,
                         void* best_i, void* parts, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const dim3 grid((n + kTile - 1) / kTile, splits);
  nn_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)dst, (const unsigned char*)mask, n, m,
      (float*)best_d, (long long*)best_i, (unsigned long long*)parts);
  return merge(parts, splits, n, best_d, best_i, (cudaStream_t)stream);
}

extern "C" int otslam_nn_window(const void* src, const void* dst,
                                const void* mask, const void* c0,
                                const void* c1, int n, int mp, int splits,
                                void* best_d, void* best_i, void* parts,
                                void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const dim3 grid((n + kTile - 1) / kTile, splits);
  nn_window_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)dst, (const unsigned char*)mask,
      (const int*)c0, (const int*)c1, n, mp, (float*)best_d,
      (long long*)best_i, (unsigned long long*)parts);
  return merge(parts, splits, n, best_d, best_i, (cudaStream_t)stream);
}
