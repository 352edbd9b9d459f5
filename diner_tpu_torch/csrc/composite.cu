// Per-ray alpha compositing of the field's outputs (sm_90a).
//
// Replaces the TPU kernel composite_pallas / _composite_kernel of
// diner_tpu/renderer/pallas_composite.py, and computes what
// diner_tpu/renderer/composite.py:composite_outputs computes, per ray of K
// samples:
//   delta_k = z_{k+1} - z_k, and far - z_K for the last sample;
//   alpha_k = 1 - exp(-delta_k * relu(sigma_k));
//   T_k     = prod_{j<k} (1 - alpha_j + 1e-10), the exclusive transmittance;
//   w_k     = alpha_k * T_k;
//   rgb = sum_k w_k rgb_k (+ 1 - sum_k w_k on a white background),
//   depth = sum_k w_k z_k, acc = sum_k w_k.
//
// Design. The TPU kernel splits the field output into (B, K) channel planes
// (a (B, K, 3) block would lane-pad 3 -> 128 in VMEM), packs its outputs
// into (B, 8) rows, pads the ray axis by repeating the last ray, and builds
// the exclusive product as a Hillis-Steele prefix because Mosaic has no
// cumprod. None of that is needed here. One warp owns one ray: lane k holds
// sample k of a 32-wide tile, read straight from the field's own (B*K, 4)
// layout, so K = 32 is one tile. The exclusive product is a shuffle scan
// within the tile, a carry takes it from tile to tile, and the four sums
// are warp reductions. Lane 0 writes the ray's rgb, depth and acc.
//
// Bound on the H100 (3.35 TB/s HBM): the kernel is memory-bound. At the
// preset's chunk (B = 4,096 rays, K = 32) it must read z (0.52 MB), the
// field output (2.1 MB f32) and far (16 KB) and write 82 KB: 2.8 MB, about
// 0.8 us, which is below the launch latency. Its arithmetic (one expf and
// some 25 flops per sample) is far below the f32 rate.
//
// The field output is float32: the port's ResnetFC casts its result to
// float32, as the JAX package's does, so no other type is instantiated.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 rays per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
composite_kernel(const float* __restrict__ rays, const float* __restrict__ z,
                 const float* __restrict__ field, float* __restrict__ rgb,
                 float* __restrict__ depth, float* __restrict__ acc,
                 long long n_rays, int K, int white_bkgd) {
  const long long ray =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (ray >= n_rays) return;  // the whole warp leaves together

  const float far = rays[ray * 8 + 7];
  const float* zr = z + ray * K;
  const float* fr = field + ray * K * 4;
  float carry = 1.f;  // transmittance in front of the current tile
  float sr = 0.f, sg = 0.f, sb = 0.f, sd = 0.f, sw = 0.f;
  for (int k0 = 0; k0 < K; k0 += kWarp) {
    const int k = k0 + lane;
    const bool on = k < K;
    const float zk = on ? zr[k] : 0.f;
    // the next sample's z from the neighbouring lane; the tile's last lane
    // and the ray's last sample read it themselves
    float zn = __shfl_down_sync(kFull, zk, 1);
    if (on && (lane == kWarp - 1 || k + 1 >= K))
      zn = (k + 1 < K) ? zr[k + 1] : far;
    float r = 0.f, g = 0.f, b = 0.f, alpha = 0.f;
    if (on) {
      r = fr[4 * k];
      g = fr[4 * k + 1];
      b = fr[4 * k + 2];
      const float sigma = fmaxf(fr[4 * k + 3], 0.f);
      alpha = 1.f - expf(-(zn - zk) * sigma);
    }
    // inclusive product scan of (1 - alpha + 1e-10) over the tile
    float incl = on ? (1.f - alpha) + 1e-10f : 1.f;
    for (int off = 1; off < kWarp; off <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl *= v;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.f;
    const float w = alpha * (carry * excl);
    sr += w * r;
    sg += w * g;
    sb += w * b;
    sd += w * zk;
    sw += w;
    carry *= __shfl_sync(kFull, incl, kWarp - 1);
  }
  sr = warp_sum(sr);
  sg = warp_sum(sg);
  sb = warp_sum(sb);
  sd = warp_sum(sd);
  sw = warp_sum(sw);
  if (lane == 0) {
    const float bg = white_bkgd ? 1.f - sw : 0.f;
    rgb[ray * 3] = sr + bg;
    rgb[ray * 3 + 1] = sg + bg;
    rgb[ray * 3 + 2] = sb + bg;
    depth[ray] = sd;
    acc[ray] = sw;
  }
}

}  // namespace

// rays (N, 8) f32 [origin 3 | dir 3 | near | far]; z (N, K) f32 ascending;
// field (N * K, 4) f32 [rgb | sigma]; rgb (N, 3), depth (N), acc (N) f32.
// Returns the cudaGetLastError() code of the launch.
extern "C" int composite_rays_launch(const void* rays, const void* z,
                                     const void* field, void* rgb, void* depth,
                                     void* acc, long long n_rays, int K,
                                     int white_bkgd, void* stream) {
  if (n_rays == 0) return 0;
  const long long rays_per_block = kThreads / kWarp;
  const long long blocks = (n_rays + rays_per_block - 1) / rays_per_block;
  composite_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays), static_cast<const float*>(z),
      static_cast<const float*>(field), static_cast<float*>(rgb),
      static_cast<float*>(depth), static_cast<float*>(acc), n_rays, K,
      white_bkgd);
  return static_cast<int>(cudaGetLastError());
}
