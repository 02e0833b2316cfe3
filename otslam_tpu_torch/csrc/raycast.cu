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
// and the same operation order, the keys are bit-identical.
//
// Early exit: an occupied step ends the ray. An oob step sets first_stop
// and ends the ray once the ray has been inside the grid: gx and gy are
// monotone in s (every operation above is monotone and rounds
// monotonically), so the in-grid steps form one interval and a ray that
// has left never re-enters. A ray that starts outside (a pose off the map)
// keeps walking for first_occ, as the plain version's min over all steps.
//
// What bounds it on the card: operations. About 12 f32 operations a sample
// (the step distance, two products and sums, two differences and
// divisions, two casts and the bounds tests), one byte load from an int8
// grid of 43 KB (cardboard room) to ~95 KB (full room) that stays in L2 and
// L1; the bytes moved are the grid once plus 16 B a beam. Design: one
// thread per (pose, beam), 128 a block, with the grid read directly
// through the read-only cache (__ldg). This replaces the TPU kernel's
// transposed lane-shifted bf16 grid planes, one-hot MXU row select, VPU
// column reduce, 32-beam group windows with scalar-prefetched starts and
// the fit flag, which exist only because a TPU element gather is slow:
// any beam count and step count are taken.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
raycast_kernel(const int8_t* __restrict__ grid, int H, int W,
               const float* __restrict__ cos_a,   // (K*B,)
               const float* __restrict__ sin_a,   // (K*B,)
               const float* __restrict__ pose_xy, // (K, 2)
               int B, int KB, int S, float res, float ox, float oy,
               int32_t* __restrict__ first_stop,  // (K*B,)
               int32_t* __restrict__ first_occ) { // (K*B,)
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= KB) return;
  const int k = i / B;
  const float px = __ldg(pose_xy + 2 * k);
  const float py = __ldg(pose_xy + 2 * k + 1);
  const float c = __ldg(cos_a + i);
  const float sn = __ldg(sin_a + i);
  int fs = S, fo = S;
  bool was_in = false;
  for (int s = 0; s < S; ++s) {
    const float d = ((float)s + 1.0f) * res;
    const float x = px + d * c;
    const float y = py + d * sn;
    const int gx = (int)((x - ox) / res);
    const int gy = (int)((y - oy) / res);
    if (gx < 0 || gx >= W || gy < 0 || gy >= H) {
      if (fs == S) fs = s;
      if (was_in) break;
      continue;
    }
    was_in = true;
    if (__ldg(grid + (long)gy * W + gx) == 100) {
      if (fs == S) fs = s;
      fo = s;
      break;
    }
  }
  first_stop[i] = fs;
  first_occ[i] = fo;
}

}  // namespace

extern "C" int otslam_raycast(const void* grid, int H, int W,
                              const void* cos_a, const void* sin_a,
                              const void* pose_xy, int B, int KB, int S,
                              float res, float ox, float oy,
                              void* first_stop, void* first_occ,
                              void* stream) {
  if (KB > 0) {
    const int blocks = (KB + kThreads - 1) / kThreads;
    raycast_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)grid, H, W, (const float*)cos_a, (const float*)sin_a,
        (const float*)pose_xy, B, KB, S, res, ox, oy, (int32_t*)first_stop,
        (int32_t*)first_occ);
  }
  return (int)cudaGetLastError();
}
