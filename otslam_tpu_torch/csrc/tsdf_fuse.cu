// Kernel K1: block-sparse TSDF fusion of a frame batch.
//
// Replaces otslam_tpu/kernels/tsdf_pallas.py::_make_kernel (launched by
// _update_active_blocks, driven by _integrate_core_impl /
// integrate_frames_pallas). Contract: the exact XLA path it stands in for,
// otslam_tpu/kernels/tsdf_block.py::integrate_frames_sparse with its
// _sample_frame, i.e. the plain version
// otslam_tpu_torch/kernels/tsdf_cuda.py::fuse_blocks_torch, bit for bit.
//
// Work list (CSR, built in torch): ids[a] is the a-th listed block,
// frames[ptr[a] .. ptr[a+1]) the frames in which it is active, ascending.
// One thread block per listed block; each voxel's tsdf/weight/colour is
// loaded once, the block's frames are walked in order with the running
// weighted mean in registers, and each value is written once, in place.
// Frames are independent per block, so the order of blocks does not matter
// and no two thread blocks touch the same row.
//
// What bounds it on the card (NVIDIA H100 80GB HBM3 at 700 W; every claim
// below measured with chip_smoke.py, numbers in PERF.md):
// - the reconstruction's 64-frame batch (6588 blocks, 186 737 (block,
//   frame) pairs, 95.6 M voxel samples): the instruction stream. A pair is
//   ~184 issued instructions in the SASS (six IEEE divisions of ~10 each:
//   two in the projection, four in the running means; the rounding, the
//   casts, the colour unpacking), so ~0.53 ms at one warp instruction a
//   cycle on each of the 528 schedulers, against 0.09 ms for the bytes
//   (rows once, frames once). Memory-side changes moved nothing there: one
//   8-byte (depth, colour) word a pixel instead of the two 4-byte planes,
//   the extrinsics in shared memory, and launches over frame windows whose
//   frames fit L2 (slower: the rows went through memory once a window) all
//   stayed at 0.84-1.2 ms.
//   What helps is latency hiding: 2 voxels a thread (256-thread blocks, 64
//   registers) keeps two samples and the next frame's gathers in flight.
// - frame-to-model tracking's one frame (<= 2048 blocks, max_active): the
//   bytes, 42 MB of rows read and written (0.013 ms at the memory's peak),
//   behind a short chain of dependent loads (ids -> rows, ptr -> frames ->
//   extrinsic -> gather); PR 1's one voxel a thread ran it in ~0.022 ms,
//   this design in ~0.024 ms.
//
// Design:
// - V = 2 voxels a thread, 256 threads a block (1 and 4 were slower at 64
//   frames and no faster at one, PERF.md): their row loads, samples and
//   gathers are independent and in flight together;
// - the block's frame ids and extrinsic rows are staged in shared memory,
//   kStage frames at a time, and read as float4 once a frame for all V
//   voxels, instead of 12 scalar global loads a thread a frame;
// - software pipelining: frame k+1's projection and gather are issued
//   before frame k's running-mean update, which they do not depend on;
// - the depth and packed-colour planes read as they come: a (depth,
//   colour) word a pixel, built in a pass before each launch, tied at 64
//   frames and gained ~3 % at one frame, too little for its pass and code
//   (PERF.md); a voxel that projects outside the image loads nothing (its
//   sample is unused: valid is false and w_obs = 0);
// - the bounds test on the rounded float pixel (0 <= rint(.) < size), the
//   same set as a clamp-to-[-1, size]-then-cast test, with the cast
//   only for the load's address.
//
// The direct f32 depth and the full-resolution packed RGB replace the TPU
// kernel's bf16 hi/lo one-hot matmuls, lane-shifted planes and half-res
// colour pyramid, which exist only because a TPU element gather is slow; a
// direct load has no coverage limit, so there is no near-field fallback.
//
// Rounding: -fmad=false and the op order of _sample_frame; the projection's
// two divisions and the four means' are IEEE divisions (no reciprocal
// multiply); division by the truncation distance is a multiply by its f32
// reciprocal (as XLA and PyTorch's CUDA scalar division do); rintf rounds
// half to even like jnp.round / torch.round (roundf would round half away).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVoxels = 512;  // 8^3 voxels a block
constexpr int V = 2;          // voxels a thread
constexpr int T = kVoxels / V;  // threads a block
constexpr int kStage = 32;    // frames whose extrinsic rows are staged at once

__global__ void __launch_bounds__(T)
fuse_kernel(float* __restrict__ tsdf,          // (NB+1, 512)
            float* __restrict__ weight,        // (NB+1, 512)
            float* __restrict__ color,         // (NB+1, 1536) channel-major
            const int* __restrict__ ids,       // (A,)
            const int* __restrict__ ptr,       // (A+1,)
            const int* __restrict__ frames,    // (nnz,)
            const float* __restrict__ depths,  // (N, H, W) meters, 0 invalid
            const int* __restrict__ cpacked,   // (N, H, W) 0x00BBGGRR
            const float4* __restrict__ ext,    // (N, 3) float4: E[:3] rows
            int height, int width, int gby, int gbz, float ox, float oy,
            float oz, float vs, float fx, float fy, float cx, float cy,
            float trunc, float inv_trunc) {
  __shared__ float4 s_ext[kStage * 3];
  __shared__ int s_frame[kStage];
  const int a = blockIdx.x;
  const int b = ids[a];

  // rows first: they depend on the block id alone; voxel l = v * T + thread
  // (x-major, l = lx * 64 + ly * 8 + lz: a warp's 32 voxels are a
  // 1 x 4 x 8 line, its row loads coalesced)
  int l[V];
  float t[V], w[V], c0[V], c1[V], c2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    l[v] = v * T + threadIdx.x;
    const size_t row = (size_t)b * kVoxels + l[v];
    const size_t crow = (size_t)b * 3 * kVoxels + l[v];
    t[v] = tsdf[row];
    w[v] = weight[row];
    c0[v] = color[crow];
    c1[v] = color[crow + kVoxels];
    c2[v] = color[crow + 2 * kVoxels];
  }
  const int k_begin = ptr[a];
  const int k_end = ptr[a + 1];
  const int ix = b / (gby * gbz);
  const int iy = (b / gbz) % gby;
  const int iz = b % gbz;
  // origin + ((i * 8 + l) + 0.5) * vs
  float wx[V], wy[V], wz[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    wx[v] = ox + ((float)(ix * 8 + (l[v] >> 6)) + 0.5f) * vs;
    wy[v] = oy + ((float)(iy * 8 + ((l[v] >> 3) & 7)) + 0.5f) * vs;
    wz[v] = oz + ((float)(iz * 8 + (l[v] & 7)) + 0.5f) * vs;
  }

  const size_t plane = (size_t)height * width;
  const float fw = (float)width, fh = (float)height;
  // the sample of one frame (a staged slot) for every voxel of the thread:
  // camera z, in-image flag, and the pixel's (depth bits, packed colour),
  // zero outside the image
  float pz[V];
  bool inb[V];
  int2 word[V];
  auto project = [&](int slot, float* z, bool* in, int2* wd) {
    const float4 e0 = s_ext[3 * slot];
    const float4 e1 = s_ext[3 * slot + 1];
    const float4 e2 = s_ext[3 * slot + 2];
    const size_t f0 = (size_t)s_frame[slot] * plane;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float px = ((e0.x * wx[v] + e0.y * wy[v]) + e0.z * wz[v]) + e0.w;
      const float py = ((e1.x * wx[v] + e1.y * wy[v]) + e1.z * wz[v]) + e1.w;
      const float qz = ((e2.x * wx[v] + e2.y * wy[v]) + e2.z * wz[v]) + e2.w;
      const bool in_front = qz > 0.0f;
      const float zsafe = in_front ? qz : 1.0f;
      // half-to-even; in the image iff 0 <= rint < size
      const float ru = rintf((fx * px) / zsafe + cx);
      const float rv = rintf((fy * py) / zsafe + cy);
      const bool ok = in_front && ru >= 0.0f && ru < fw && rv >= 0.0f &&
                      rv < fh;
      z[v] = qz;
      in[v] = ok;
      const size_t at = f0 + (size_t)((int)rv * width + (int)ru);
      wd[v] = ok ? make_int2(__float_as_int(__ldg(depths + at)),
                             __ldg(cpacked + at))
                 : make_int2(0, 0);
    }
  };

  for (int k0 = k_begin; k0 < k_end; k0 += kStage) {
    const int nf = min(kStage, k_end - k0);
    __syncthreads();                           // the last stage is consumed
    for (int q = threadIdx.x; q < 3 * nf; q += T)
      s_ext[q] = __ldg(ext + 3 * frames[k0 + q / 3] + q % 3);
    for (int q = threadIdx.x; q < nf; q += T) s_frame[q] = frames[k0 + q];
    __syncthreads();
    project(0, pz, inb, word);
    for (int s = 0; s < nf; ++s) {
      float cz[V];
      bool cin[V];
      int2 cwd[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        cz[v] = pz[v];
        cin[v] = inb[v];
        cwd[v] = word[v];
      }
      if (s + 1 < nf) project(s + 1, pz, inb, word);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float d = __int_as_float(cwd[v].x);
        const int packed = cwd[v].y;
        const float sdf = d - cz[v];
        const bool valid = cin[v] && d > 0.0f && sdf >= -trunc;
        const float t_obs = valid ? fminf(sdf * inv_trunc, 1.0f) : 0.0f;
        const float w_obs = valid ? 1.0f : 0.0f;
        const float r = (float)(packed & 0xFF) * w_obs;
        const float g = (float)((packed >> 8) & 0xFF) * w_obs;
        const float bl = (float)((packed >> 16) & 0xFF) * w_obs;

        const float w_new = w[v] + w_obs;
        const float denom = fmaxf(w_new, 1.0f);
        t[v] = (t[v] * w[v] + t_obs * w_obs) / denom;
        c0[v] = (c0[v] * w[v] + r) / denom;
        c1[v] = (c1[v] * w[v] + g) / denom;
        c2[v] = (c2[v] * w[v] + bl) / denom;
        w[v] = w_new;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const size_t row = (size_t)b * kVoxels + l[v];
    const size_t crow = (size_t)b * 3 * kVoxels + l[v];
    tsdf[row] = t[v];
    weight[row] = w[v];
    color[crow] = c0[v];
    color[crow + kVoxels] = c1[v];
    color[crow + 2 * kVoxels] = c2[v];
  }
}

}  // namespace

// One block of 256 threads a listed block (tsdf_cuda.py::fuse_launch).
// `ext` must be 16-byte aligned (fresh torch allocations are).
extern "C" int otslam_fuse(void* tsdf, void* weight, void* color,
                           const void* ids, const void* ptr,
                           const void* frames, int n_ids, const void* depths,
                           const void* cpacked, const void* ext, int height, int width, int gby,
                           int gbz, float ox, float oy, float oz, float vs,
                           float fx, float fy, float cx, float cy,
                           float trunc, float inv_trunc, void* stream) {
  if (n_ids <= 0) return (int)cudaGetLastError();
  fuse_kernel<<<n_ids, T, 0, (cudaStream_t)stream>>>(
      (float*)tsdf, (float*)weight, (float*)color, (const int*)ids,
      (const int*)ptr, (const int*)frames, (const float*)depths,
      (const int*)cpacked, (const float4*)ext, height, width, gby, gbz, ox, oy, oz, vs, fx, fy,
      cx, cy, trunc, inv_trunc);
  return (int)cudaGetLastError();
}
