// Kernel K1: block-sparse TSDF fusion of a frame batch.
//
// Replaces otslam_tpu/kernels/tsdf_pallas.py::_make_kernel (launched by
// _update_active_blocks, driven by _integrate_core_impl /
// integrate_frames_pallas). Contract: the exact XLA path it stands in for,
// otslam_tpu/kernels/tsdf_block.py::integrate_frames_sparse with its
// _sample_frame, i.e. the plain version
// otslam_tpu_torch/kernels/tsdf_cuda.py::fuse_blocks_torch.
//
// Work list (CSR, built in torch): ids[a] is the a-th listed block,
// frames[ptr[a] .. ptr[a+1]) the frames in which it is active, ascending.
// One thread block of 512 threads per listed block, one voxel per thread.
// Each thread loads its tsdf/weight/colour once, walks the block's frames in
// order with the running weighted mean in registers, and writes each value
// once, in place. Frames are independent per block, so the order of blocks
// does not matter and no two thread blocks touch the same row.
//
// What bounds it on the card: per (block, frame) pair one depth and one
// packed-colour load per voxel from the frame images (VGA frames are 1.2 MB
// each and mostly L2-resident) — a gather, latency-bound; plus 5 floats read
// and written per voxel once per launch. Design: the direct f32 depth load
// and the full-resolution packed RGB word replace the TPU kernel's bf16
// hi/lo one-hot matmuls, lane-shifted planes and half-res colour pyramid,
// which exist only because a TPU element gather is slow; a direct load has no
// coverage limit, so there is no near-field fallback either.
//
// Rounding: -fmad=false and the op order of _sample_frame; division by the
// truncation distance is a multiply by its f32 reciprocal (as XLA and
// PyTorch's CUDA scalar division do); rintf rounds half to even like
// jnp.round / torch.round (roundf would round half away).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVoxels = 512;  // 8^3 voxels per block, one thread each

__global__ void __launch_bounds__(kVoxels)
fuse_kernel(float* __restrict__ tsdf,          // (NB+1, 512)
            float* __restrict__ weight,        // (NB+1, 512)
            float* __restrict__ color,         // (NB+1, 1536) channel-major
            const int* __restrict__ ids,       // (A,)
            const int* __restrict__ ptr,       // (A+1,)
            const int* __restrict__ frames,    // (nnz,)
            const float* __restrict__ depths,  // (N, H, W) meters, 0 invalid
            const int* __restrict__ cpacked,   // (N, H, W) 0x00BBGGRR
            const float* __restrict__ ext,     // (N, 12) rows of E[:3]
            int height, int width, int gby, int gbz, float ox, float oy,
            float oz, float vs, float fx, float fy, float cx, float cy,
            float trunc, float inv_trunc) {
  const int a = blockIdx.x;
  const int l = threadIdx.x;
  const int b = ids[a];
  const int ix = b / (gby * gbz);
  const int iy = (b / gbz) % gby;
  const int iz = b % gbz;
  const int lx = l >> 6;
  const int ly = (l >> 3) & 7;
  const int lz = l & 7;
  // origin + ((i * 8 + l) + 0.5) * vs
  const float wx = ox + ((float)(ix * 8 + lx) + 0.5f) * vs;
  const float wy = oy + ((float)(iy * 8 + ly) + 0.5f) * vs;
  const float wz = oz + ((float)(iz * 8 + lz) + 0.5f) * vs;

  const size_t row = (size_t)b * kVoxels + l;
  const size_t crow = (size_t)b * 3 * kVoxels + l;
  float t = tsdf[row];
  float w = weight[row];
  float c0 = color[crow];
  float c1 = color[crow + kVoxels];
  float c2 = color[crow + 2 * kVoxels];

  const size_t plane = (size_t)height * width;
  const int k_end = ptr[a + 1];
  for (int k = ptr[a]; k < k_end; ++k) {
    const int f = frames[k];
    const float* e = ext + (size_t)f * 12;
    const float px = ((e[0] * wx + e[1] * wy) + e[2] * wz) + e[3];
    const float py = ((e[4] * wx + e[5] * wy) + e[6] * wz) + e[7];
    const float pz = ((e[8] * wx + e[9] * wy) + e[10] * wz) + e[11];
    const bool in_front = pz > 0.0f;
    const float zsafe = in_front ? pz : 1.0f;
    // half-to-even, clamped to [-1, size] before the cast
    const int u = (int)fminf(fmaxf(rintf((fx * px) / zsafe + cx), -1.0f),
                             (float)width);
    const int v = (int)fminf(fmaxf(rintf((fy * py) / zsafe + cy), -1.0f),
                             (float)height);
    const bool inb = in_front && u >= 0 && u < width && v >= 0 && v < height;
    const size_t pix = (size_t)f * plane +
                       (size_t)min(max(v, 0), height - 1) * width +
                       min(max(u, 0), width - 1);
    const float d = depths[pix];
    const int packed = cpacked[pix];

    const float sdf = d - pz;
    const bool valid = inb && d > 0.0f && sdf >= -trunc;
    const float t_obs = valid ? fminf(sdf * inv_trunc, 1.0f) : 0.0f;
    const float w_obs = valid ? 1.0f : 0.0f;
    const float r = (float)(packed & 0xFF) * w_obs;
    const float g = (float)((packed >> 8) & 0xFF) * w_obs;
    const float bl = (float)((packed >> 16) & 0xFF) * w_obs;

    const float w_new = w + w_obs;
    const float denom = fmaxf(w_new, 1.0f);
    t = (t * w + t_obs * w_obs) / denom;
    c0 = (c0 * w + r) / denom;
    c1 = (c1 * w + g) / denom;
    c2 = (c2 * w + bl) / denom;
    w = w_new;
  }
  tsdf[row] = t;
  weight[row] = w;
  color[crow] = c0;
  color[crow + kVoxels] = c1;
  color[crow + 2 * kVoxels] = c2;
}

}  // namespace

extern "C" int otslam_fuse(void* tsdf, void* weight, void* color,
                           const void* ids, const void* ptr,
                           const void* frames, int n_ids, const void* depths,
                           const void* cpacked, const void* ext, int height,
                           int width, int gby, int gbz, float ox, float oy,
                           float oz, float vs, float fx, float fy, float cx,
                           float cy, float trunc, float inv_trunc,
                           void* stream) {
  if (n_ids > 0) {
    fuse_kernel<<<n_ids, kVoxels, 0, (cudaStream_t)stream>>>(
        (float*)tsdf, (float*)weight, (float*)color, (const int*)ids,
        (const int*)ptr, (const int*)frames, (const float*)depths,
        (const int*)cpacked, (const float*)ext, height, width, gby, gbz, ox,
        oy, oz, vs, fx, fy, cx, cy, trunc, inv_trunc);
  }
  return (int)cudaGetLastError();
}
