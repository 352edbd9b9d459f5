// Gradient of the per-ray alpha compositing (K4) with respect to the
// field's outputs (sm_90a).
//
// The TPU kernel composite_pallas (diner_tpu/renderer/pallas_composite.py)
// has no backward: the JAX trainer differentiates the XLA compositing of
// diner_tpu/renderer/composite.py:composite_outputs with jax.grad. This
// kernel computes that gradient for the port's forward kernel
// (csrc/composite.cu), so that training composites only through kernels.
// Per ray of K samples, with the forward's
//   delta_k = z_{k+1} - z_k (far - z_K for the last), e_k = exp(-delta_k
//   relu(sigma_k)), alpha_k = 1 - e_k, t_k = (1 - alpha_k) + 1e-10,
//   T_k = prod_{j<k} t_j, w_k = alpha_k T_k,
// and the upstream gradients g_rgb (3), g_depth and g_acc of the ray:
//   v_k     = g_rgb . rgb_k + g_depth z_k + g_acc (- sum g_rgb on a white
//             background: rgb gains 1 - sum_k w_k), i.e. dL/dw_k;
//   S_k     = alpha_{k+1} v_{k+1} + t_{k+1} S_{k+1}, S_K = 0, the suffix
//             recurrence that carries dL/dT through the later samples
//             without a division by t;
//   g_rgb_k = w_k g_rgb;  g_alpha_k = T_k (v_k - S_k);
//   g_sigma_k = g_alpha_k delta_k e_k where sigma_k > 0, half of
//             g_alpha_k delta_k where sigma_k == 0 (jnp.maximum and
//             torch.maximum split a tie's gradient evenly), else 0.
// z and the rays get no gradient: the sampler runs under no_grad.
//
// Bound on the H100 (3.35 TB/s HBM): bytes. At the training shape (SB 4,
// B 4,096 rays, K 40) the function must read z (2.6 MB), the field rows
// (10.5 MB), far and the upstream gradients (0.4 MB), and write g_field
// (10.5 MB): 24 MB, about 7 us. Its arithmetic (one expf and some 40
// operations a sample) is far below the f32 rate.
//
// Design, simple first: a warp per ray, a sample per lane, in 32-sample
// tiles.
//   - pass 1 walks the tiles forward: each lane loads its z, the next z
//     (far for the last sample) and its (r, g, b, sigma) row, computes
//     alpha, v and dalpha/dsigma, and the warp runs a 5-step shuffle
//     product scan of t for T (a carry takes T from tile to tile). The lane
//     stores (T, alpha, v, dalpha/dsigma) into its own g_field row: the
//     output doubles as scratch, so any K needs no other memory;
//   - pass 2 walks the tiles backward: each lane reads its scratch row back
//     (the same thread wrote it), and the warp runs a 5-step reverse scan
//     of the affine maps s -> alpha_j v_j + t_j s (shfl_down), which gives
//     every lane S_k at once; a carry takes S from tile to tile. The lane
//     then overwrites its row with (w g_rgb, g_sigma).
// Lanes past K take alpha 0: their map is the identity, since (1 - 0) +
// 1e-10 rounds to 1, and they store nothing. Every load and store is a
// lane's own 4- or 16-byte element, neighbouring lanes on neighbouring
// addresses. The ray index is uniform in a warp, so a warp past the last
// ray returns whole and every shuffle has all 32 lanes. Block size and grid
// come from kernels/composite.py:backward_geometry.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;

__global__ void composite_bwd_kernel(
    const float* __restrict__ rays, const float* __restrict__ z,
    const float4* __restrict__ field, const float* __restrict__ g_rgb,
    const float* __restrict__ g_depth, const float* __restrict__ g_acc,
    float4* __restrict__ g_field, long long n_rays, int K, int white_bkgd) {
  const int lane = threadIdx.x % kWarp;
  const long long ray =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) +
      threadIdx.x / kWarp;
  if (ray >= n_rays) return;
  const float* zr = z + ray * K;
  const float4* fr = field + ray * K;
  float4* gr = g_field + ray * K;
  const float far = rays[ray * 8 + 7];
  const float g0 = g_rgb[ray * 3], g1 = g_rgb[ray * 3 + 1],
              g2 = g_rgb[ray * 3 + 2];
  const float gd = g_depth[ray], ga = g_acc[ray];
  const float bg = white_bkgd ? g0 + g1 + g2 : 0.f;

  // pass 1: T, alpha, v and dalpha/dsigma of every sample, into g_field
  float carry = 1.f;  // transmittance in front of the current tile
  for (int k0 = 0; k0 < K; k0 += kWarp) {
    const int k = k0 + lane;
    float alpha = 0.f, v = 0.f, dads = 0.f;
    if (k < K) {
      const float4 f = fr[k];
      const float zk = zr[k];
      const float delta = (k + 1 < K ? zr[k + 1] : far) - zk;
      const float e = expf(-delta * fmaxf(f.w, 0.f));
      alpha = 1.f - e;
      v = g0 * f.x + g1 * f.y + g2 * f.z + gd * zk + ga - bg;
      dads = f.w > 0.f ? delta * e : f.w == 0.f ? 0.5f * delta : 0.f;
    }
    const float t = (1.f - alpha) + 1e-10f;
    float incl = t;  // inclusive product scan of t over the tile
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const float up = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl *= up;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.f;
    if (k < K) gr[k] = make_float4(carry * excl, alpha, v, dads);
    carry *= __shfl_sync(kFull, incl, kWarp - 1);
  }

  // pass 2: S by a reverse scan of the affine maps, then the gradient
  float s_carry = 0.f;  // S at the last sample of the current tile
  for (int k0 = (K - 1) / kWarp * kWarp; k0 >= 0; k0 -= kWarp) {
    const int k = k0 + lane;
    const float4 sc = k < K ? gr[k] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float T = sc.x, alpha = sc.y, v = sc.z, dads = sc.w;
    // lane j's map f_j(s) = alpha_j v_j + t_j s; after the scan (a, b) is
    // f_j o f_{j+1} o ... o f_31
    float a = alpha * v, b = (1.f - alpha) + 1e-10f;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const float a2 = __shfl_down_sync(kFull, a, off);
      const float b2 = __shfl_down_sync(kFull, b, off);
      if (lane + off < kWarp) {
        a += b * a2;
        b *= b2;
      }
    }
    float ae = __shfl_down_sync(kFull, a, 1);  // f_{j+1} o ... o f_31
    float be = __shfl_down_sync(kFull, b, 1);
    if (lane == kWarp - 1) ae = 0.f, be = 1.f;
    const float S = ae + be * s_carry;
    const float w = alpha * T;
    if (k < K)
      gr[k] = make_float4(w * g0, w * g1, w * g2, T * (v - S) * dads);
    s_carry = __shfl_sync(kFull, a, 0) + __shfl_sync(kFull, b, 0) * s_carry;
  }
}

}  // namespace

// rays (N, 8) f32 [origin 3 | dir 3 | near | far]; z (N, K) f32 ascending;
// field (N * K, 4) f32 [rgb | sigma]; g_rgb (N, 3), g_depth (N), g_acc (N)
// f32, the upstream gradients of K4's outputs; g_field (N * K, 4) f32 out;
// field and g_field 16-byte aligned; N >= 1, K >= 1; `blocks` of `threads`
// threads (a multiple of 32) hold a ray per warp. Returns the
// cudaGetLastError() code of the launch.
extern "C" int composite_rays_backward_launch(
    const void* rays, const void* z, const void* field, const void* g_rgb,
    const void* g_depth, const void* g_acc, void* g_field, long long n_rays,
    int K, int white_bkgd, long long blocks, int threads, void* stream) {
  composite_bwd_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays), static_cast<const float*>(z),
      static_cast<const float4*>(field), static_cast<const float*>(g_rgb),
      static_cast<const float*>(g_depth), static_cast<const float*>(g_acc),
      static_cast<float4*>(g_field), n_rays, K, white_bkgd);
  return static_cast<int>(cudaGetLastError());
}
