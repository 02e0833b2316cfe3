// The colour pack before fusion: (N, H, W, 3) f32 colour in [0, 255] ->
// (N, H, W) int32 0x00BBGGRR, the colour plane that K1 (tsdf_fuse.cu)
// samples.
//
// Replaces the port's plain otslam_tpu_torch/kernels/tsdf_block.py::
// pack_rgb (the JAX package folds the same uint32 pack into its fusion
// graph). Contract: each channel clamped to [0, 255] and truncated toward
// zero, bit-identical to the plain version for every colour that is not
// NaN. A NaN channel packs as 0 here (fmaxf drops the NaN); the plain
// version's float -> int cast of a NaN has no defined value.
//
// What bounds it on the card: bytes, 12 read and 4 written a pixel (314 MB
// at 64 VGA frames). Design: a thread packs 4 pixels, three float4 loads
// and one int4 store where both tensors are 16-byte aligned (every group
// then starts on a 48-byte boundary); scalar loads at the ragged end and
// for unaligned operands.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int channel(float c) {
  return (int)fminf(fmaxf(c, 0.0f), 255.0f);   // clamp, then truncate
}

__device__ __forceinline__ int pack(float r, float g, float b) {
  return channel(r) | (channel(g) << 8) | (channel(b) << 16);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pack_rgb_kernel(const float* __restrict__ rgb, int* __restrict__ out,
                long long n_pixels) {
  const long long p0 = 4 * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (p0 >= n_pixels) return;
  if (kVec && p0 + 4 <= n_pixels) {
    const float4* src = reinterpret_cast<const float4*>(rgb + 3 * p0);
    const float4 a = __ldcs(src), b = __ldcs(src + 1), c = __ldcs(src + 2);
    __stcs(reinterpret_cast<int4*>(out + p0),
           make_int4(pack(a.x, a.y, a.z), pack(a.w, b.x, b.y),
                     pack(b.z, b.w, c.x), pack(c.y, c.z, c.w)));
    return;
  }
  for (long long p = p0; p < p0 + 4 && p < n_pixels; ++p)
    out[p] = pack(rgb[3 * p], rgb[3 * p + 1], rgb[3 * p + 2]);
}

}  // namespace

extern "C" int otslam_pack_rgb(const void* rgb, void* out, long long n_pixels,
                               void* stream) {
  const long long groups = (n_pixels + 3) / 4;
  const long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (uintptr_t)rgb % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (vec)
    pack_rgb_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)rgb, (int*)out, n_pixels);
  else
    pack_rgb_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)rgb, (int*)out, n_pixels);
  return (int)cudaGetLastError();
}
