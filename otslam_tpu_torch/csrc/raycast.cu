// Kernel K5: occupancy-grid ray casting (the virtual scan).
//
// Replaces otslam_tpu/kernels/raycast.py::_make_ray_kernel (launched by
// _raycast_pallas_keys at raycast.py:258, behind raycast_grid_fast:
// VirtualScanner.scan and every perception tick of perception_ticks).
// Contract: raycast.py::raycast_grid (virtual_scan_node.cpp:258-287), whose
// plain PyTorch version is otslam_tpu_torch/kernels/raycast.py::
// ray_keys_torch. For beam i = k * B + b (pose k, beam b) and step
// s < S = ceil(range_max / res):
//
//   d = (s + 1) * res,  x = px_k + d * cos_i,  y = py_k + d * sin_i
//   gx = (int)((x - ox) / res),  gy = (int)((y - oy) / res)   (truncating)
//   oob = gx, gy outside the grid;  occ = !oob && grid[gy, gx] == 100
//
// and the outputs are the first step that is oob or occupied (first_stop)
// and the first occupied step (first_occ), S where there is none. The
// wrapper passes cos/sin of (yaw_k + angle_b) from torch, so kernel and
// plain version see the same transcendental values; built with -fmad=false
// and the same operation order (two IEEE divisions a sample, no reciprocal
// multiply), the keys are bit-identical.
//
// What bounds it on the card (NVIDIA H100 80GB HBM3 at 700 W; measured
// with chip_smoke.py, numbers in PERF.md). A sample is ~43 lane instructions
// (two IEEE divisions of ~10, two truncating casts) ending in a byte load
// from an int8 grid of 43 KB (cardboard room) to ~95 KB (full room) that
// stays in L1/L2, and a ray walks up to S = 200 of them (94 on average on
// the cardboard map) until its first stop. The bytes are the grid once
// plus 16 B a beam, the f32 operations ~12 a sample: a bound of ~1.6 us at
// 64 poses x 1440 beams, an instruction floor of ~11 us.
// - the mission's 8 poses x 1440 beams: the chain. With one thread a ray
//   they were 11 520 threads, 90 blocks of 128 on 132 SMs, each warp
//   waiting out up to 200 dependent steps of its longest beam: 0.050 ms.
// - 64 poses (transit batches): issue. 92 160 rays fill the card, and a
//   chunk round costs ~105 warp instructions in the SASS, about half of
//   them the round's bookkeeping (ballots, lowest set bits, exit tests).
//
// Design: a ray is a group of L consecutive lanes of one warp (L = 8, 16
// or 32: raycast.py::lanes_for takes the fewest that fill the card, so 32
// at the mission's 8 poses and 8 at 64), which evaluates L consecutive
// steps at once; every step is a pure function of its index s, so each
// lane computes exactly what the serial loop computed ((float)s is kept
// as a float counter, exact below 2^24). Two __ballot_sync give the
// group's out-of-bounds and occupied steps of the chunk (the rest of its
// steps are in the grid); the lowest set bit of (oob | occ) is first_stop
// (once), the lowest of occ first_occ. A 200-step chain becomes
// ceil(200 / L) chunk rounds.
//
// Early exit, per chunk: an occupied step ends the ray. An oob step ends
// it once the ray has been inside: gx and gy are monotone in s (every
// operation above is monotone and rounds monotonically), so the in-grid
// steps form one interval, and a ray that has been inside at some step so
// far and is out at the chunk's last step has left for good (a ray that
// enters mid-chunk has oob steps before its in-grid ones, and walks on). A
// ray that starts outside (a pose off the map) keeps walking for
// first_occ, as the plain version's min over all steps. The loop runs
// while any group of the warp is live, so every ballot sees the full warp.
//
// This replaces the TPU kernel's transposed lane-shifted bf16 grid planes,
// one-hot MXU row select, VPU column reduce, 32-beam group windows with
// scalar-prefetched starts and the fit flag, which exist only because a TPU
// element gather is slow: any beam count and step count are taken.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;

template <int L>
__global__ void __launch_bounds__(kMaxThreads)
raycast_kernel(const int8_t* __restrict__ grid, int H, int W,
               const float* __restrict__ cos_a,   // (K*B,)
               const float* __restrict__ sin_a,   // (K*B,)
               const float* __restrict__ pose_xy, // (K, 2)
               int B, int KB, int S, float res, float ox, float oy,
               int32_t* __restrict__ first_stop,  // (K*B,)
               int32_t* __restrict__ first_occ) { // (K*B,)
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = t / L;                        // the ray
  const int j = t % L;                        // its lane: step base + j
  const int shift = (threadIdx.x & 31) & ~(L - 1);
  const unsigned group = L == 32 ? kFull : (1u << L) - 1u;
  const bool live = i < KB;
  float px = 0.0f, py = 0.0f, c = 0.0f, sn = 0.0f;
  if (live) {
    const int k = i / B;
    px = __ldg(pose_xy + 2 * k);
    py = __ldg(pose_xy + 2 * k + 1);
    c = __ldg(cos_a + i);
    sn = __ldg(sin_a + i);
  }
  int fs = S, fo = S;
  bool done = !live, was_in = false;
  // (float)(base + j), kept exact by adding the integer L (S < 2^24)
  float sf = (float)j;
  for (int base = 0; base < S; base += L, sf += (float)L) {
    if (__all_sync(kFull, done)) break;
    const int n = min(L, S - base);           // the chunk's steps
    bool oob = false, occ = false;
    if (!done && j < n) {
      const float d = (sf + 1.0f) * res;
      const float x = px + d * c;
      const float y = py + d * sn;
      const int gx = (int)((x - ox) / res);
      const int gy = (int)((y - oy) / res);
      oob = gx < 0 || gx >= W || gy < 0 || gy >= H;
      occ = !oob && __ldg(grid + (long)gy * W + gx) == 100;
    }
    const unsigned oob_bits = (__ballot_sync(kFull, oob) >> shift) & group;
    const unsigned occ_bits = (__ballot_sync(kFull, occ) >> shift) & group;
    if (!done) {
      const unsigned steps = n == 32 ? kFull : (1u << n) - 1u;
      const unsigned stop = oob_bits | occ_bits;
      if (fs == S && stop) fs = base + __ffs(stop) - 1;
      if (occ_bits) {
        fo = base + __ffs(occ_bits) - 1;
        done = true;
      }
      // inside at some step so far, and out at the chunk's last: gone
      was_in = was_in || oob_bits != steps;
      if (was_in && ((oob_bits >> (n - 1)) & 1u)) done = true;
    }
  }
  if (live && j == 0) {
    first_stop[i] = fs;
    first_occ[i] = fo;
  }
}

}  // namespace

// The launch shape comes from the wrapper (raycast.py::ray_launch): `lanes`
// lanes a ray, `threads` a block (a multiple of 32, at most 512), `blocks`
// covering K*B*lanes threads. A shape it does not take is refused with
// cudaErrorInvalidValue before anything runs.
extern "C" int otslam_raycast(const void* grid, int H, int W,
                              const void* cos_a, const void* sin_a,
                              const void* pose_xy, int B, int KB, int S,
                              float res, float ox, float oy, int lanes,
                              int blocks, int threads, void* first_stop,
                              void* first_occ, void* stream) {
  if (KB <= 0) return (int)cudaGetLastError();
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0 ||
      (long)blocks * threads < (long)KB * lanes)
    return (int)cudaErrorInvalidValue;
  decltype(&raycast_kernel<8>) kernel;
  switch (lanes) {
    case 8: kernel = &raycast_kernel<8>; break;
    case 16: kernel = &raycast_kernel<16>; break;
    case 32: kernel = &raycast_kernel<32>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)grid, H, W, (const float*)cos_a, (const float*)sin_a,
      (const float*)pose_xy, B, KB, S, res, ox, oy, (int32_t*)first_stop,
      (int32_t*)first_occ);
  return (int)cudaGetLastError();
}
