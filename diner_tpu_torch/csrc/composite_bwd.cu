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
// operations a sample) is far below the f32 rate. What is left is the time
// from a ray's first load to its last store: the loads in flight and the
// chain of dependent steps after them.
//
// Design: a ray's samples live in registers, and every global access is a
// coalesced 16-byte (field, g_field) or 4-byte (z) access. A group of
// kGroup = 8 lanes owns a ray, four rays a warp. Lane l owns the samples l,
// l + 8, l + 16, ...: P = ceil(K / 8) rows of 8 consecutive samples, one a
// lane (P a template parameter, at most kMaxPerLane = 8), so K = 40 is five
// rows and a row of the warp's four rays is four whole 128-byte lines of
// the field:
//   - loads: a lane reads its P z and its P (r, g, b, sigma) rows, all
//     issued before any is used, each byte once, with the streaming hint
//     (ld.global.cs); the next sample's z comes from the next lane by
//     shuffle (lane 0 hands the next row's first z to the row's last
//     lane);
//   - T: a 3-step shuffle product scan of t in each row, the P rows side by
//     side, then the rows chained by their totals (P multiplies);
//   - S: a 3-step reverse scan of the affine maps s -> alpha v + t s in each
//     row (two shuffles a step), the rows side by side, then the rows
//     chained backward: S at a row's last sample is the next row's composed
//     map applied to S at that row's last sample;
//   - stores: each sample's (w g_rgb, g_sigma) with one 16-byte streaming
//     store (st.global.cs), the row's lanes on neighbouring addresses.
//     g_field is written once and never read.
// The chain of dependent steps is one row's scan plus P chaining steps,
// with P rows' worth of independent shuffles in flight.
//
// Measured on the H100 (PERF.md), at the training shape, alone:
// 0.0142-0.0144 ms against 0.0163-0.0165 for the kernel it replaced in the
// same call (bound 0.0072 ms), and 9.9-10.0 us a launch in a training step
// against 11.9. An instantiation without the tile loop for K <= 64 read
// 0.0138-0.0139 ms in that call: 0.4 us less of a 1.19 s step is not worth a
// second code path, so every K runs this one. The replaced kernel (a warp a
// ray, a sample a lane, 5-step scans over 32-lane tiles) stored (T, alpha,
// v, dalpha/dsigma) into g_field and read them back: 21 MB of extra traffic
// at the training shape. Three other designs were slower than it or than
// this one: P consecutive samples a lane (a lane-serial product and
// composition of maps, one group scan) at 4, 8 and 16 lanes a ray, since a
// warp's 16-byte accesses then lie P x 16 bytes apart and each instruction
// touches 32 half-used sectors; the same layout with a block's rows staged
// through shared memory; and a persistent grid fed by TMA bulk copies
// (cp.async.bulk on an mbarrier, double-buffered), on either layout: with
// every ray's loads issued at once the card has the whole grid's loads in
// flight in one wave, and a persistent grid has fewer warps to hide its
// shared-memory round trip.
//
// K > kGroup * kMaxPerLane runs in tiles of kGroup * kMaxPerLane samples:
// the forward walk carries T from tile to tile and keeps every tile but the
// last as (T, alpha, v, dalpha/dsigma) in dynamic shared memory, laid out
// so that neighbouring threads touch neighbouring 16 bytes; the backward
// walk carries S from tile to tile, and the last lane reads the next
// tile's first z. A thread reads back only what it wrote, so no barrier is
// needed. kernels/composite.py:backward_geometry sizes the block and its
// shared memory, and refuses K past its BACKWARD_MAX_K.
// Samples past K take alpha 0: their map is the identity, since (1 - 0) +
// 1e-10 rounds to 1, and they store nothing. Groups past the last ray
// recompute the last ray and store nothing, so that every lane takes part
// in every shuffle.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 8;        // lanes per ray
constexpr int kMaxPerLane = 8;   // rows (a sample each) a lane holds
constexpr int kMaxThreads = 128;
static_assert(32 % kGroup == 0, "a warp holds whole groups");

template <int P>
__global__ void __launch_bounds__(kMaxThreads) composite_bwd_kernel(
    const float* __restrict__ rays, const float* __restrict__ z,
    const float4* __restrict__ field, const float* __restrict__ g_rgb,
    const float* __restrict__ g_depth, const float* __restrict__ g_acc,
    float4* __restrict__ g_field, long long n_rays, int K, int white_bkgd) {
  // the earlier tiles' (T, alpha, v, dalpha/dsigma): [tile][row][thread]
  extern __shared__ float4 held[];
  constexpr int kTile = kGroup * P;
  const int lane = threadIdx.x % kGroup;
  const int next_lane = (lane + 1) % kGroup;
  const long long ray =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kGroup) +
      threadIdx.x / kGroup;
  const long long r = ray < n_rays ? ray : n_rays - 1;
  const float* zr = z + r * K;
  const float4* fr = field + r * K;
  float4* gr = g_field + r * K;
  const float far = rays[r * 8 + 7];
  const float g0 = g_rgb[r * 3], g1 = g_rgb[r * 3 + 1],
              g2 = g_rgb[r * 3 + 2];
  const float gd = g_depth[r], ga = g_acc[r];
  const float bg = white_bkgd ? g0 + g1 + g2 : 0.f;
  const int n_tiles = (K + kTile - 1) / kTile;

  float T[P], alpha[P], v[P], dads[P];
  float carry = 1.f;  // transmittance in front of the current row
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * kTile + lane;  // this lane's sample of row 0
    float zs[P];
    float4 f[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int k = k0 + j * kGroup;
      zs[j] = k < K ? __ldcs(zr + k) : 0.f;
      f[j] = k < K ? __ldcs(fr + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // the next tile's first z, for the last sample of the tile
    const int k_last = k0 + (P - 1) * kGroup;
    const float z_after = lane == kGroup - 1 && k_last + 1 < K
                              ? __ldcs(zr + k_last + 1)
                              : 0.f;
    float incl[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int k = k0 + j * kGroup;
      // the next sample's z comes from the next lane; lane 0 hands the
      // next row's first z to the row's last lane
      const float give = lane == 0 && j + 1 < P ? zs[j + 1] : zs[j];
      float zn = __shfl_sync(kFull, give, next_lane, kGroup);
      if (j == P - 1 && lane == kGroup - 1) zn = z_after;
      const bool in = k < K;
      const float delta = (k + 1 < K ? zn : far) - zs[j];
      const float s = f[j].w;
      const float e = expf(-delta * fmaxf(s, 0.f));
      alpha[j] = in ? 1.f - e : 0.f;
      v[j] = in ? g0 * f[j].x + g1 * f[j].y + g2 * f[j].z + gd * zs[j] + ga
                      - bg
                : 0.f;
      dads[j] = !in ? 0.f : s > 0.f ? delta * e : s == 0.f ? 0.5f * delta
                                                            : 0.f;
      incl[j] = (1.f - alpha[j]) + 1e-10f;
    }
    // inclusive product scans of t, one a row, the rows side by side
#pragma unroll
    for (int off = 1; off < kGroup; off <<= 1) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float up = __shfl_up_sync(kFull, incl[j], off, kGroup);
        if (lane >= off) incl[j] *= up;
      }
    }
    // the rows chained by their totals
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float excl = __shfl_up_sync(kFull, incl[j], 1, kGroup);
      T[j] = carry * (lane == 0 ? 1.f : excl);
      carry *= __shfl_sync(kFull, incl[j], kGroup - 1, kGroup);
    }
    if (i + 1 < n_tiles) {
#pragma unroll
      for (int j = 0; j < P; ++j)
        held[(i * P + j) * blockDim.x + threadIdx.x] =
            make_float4(T[j], alpha[j], v[j], dads[j]);
    }
  }

  float s_carry = 0.f;  // S at the last sample of the current row
  for (int i = n_tiles - 1; i >= 0; --i) {
    if (i + 1 < n_tiles) {  // the last tile is in registers
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float4 h = held[(i * P + j) * blockDim.x + threadIdx.x];
        T[j] = h.x, alpha[j] = h.y, v[j] = h.z, dads[j] = h.w;
      }
    }
    // reverse scans of the maps s -> alpha v + t s, one a row: (a, b)
    // becomes f_lane o f_{lane+1} o ... o f_last of the row
    float a[P], b[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      a[j] = alpha[j] * v[j];
      b[j] = (1.f - alpha[j]) + 1e-10f;
    }
#pragma unroll
    for (int off = 1; off < kGroup; off <<= 1) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float a2 = __shfl_down_sync(kFull, a[j], off, kGroup);
        const float b2 = __shfl_down_sync(kFull, b[j], off, kGroup);
        if (lane + off < kGroup) {
          a[j] += b[j] * a2;
          b[j] *= b2;
        }
      }
    }
    // the rows chained backward: S of a sample is the row's later maps
    // applied to S at the row's last sample
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
      float ae = __shfl_down_sync(kFull, a[j], 1, kGroup);
      float be = __shfl_down_sync(kFull, b[j], 1, kGroup);
      if (lane == kGroup - 1) ae = 0.f, be = 1.f;
      const float S = ae + be * s_carry;
      const int k = i * kTile + j * kGroup + lane;
      if (ray < n_rays && k < K) {
        const float w = alpha[j] * T[j];
        __stcs(gr + k, make_float4(w * g0, w * g1, w * g2,
                                   T[j] * (v[j] - S) * dads[j]));
      }
      s_carry = __shfl_sync(kFull, a[j], 0, kGroup) +
                __shfl_sync(kFull, b[j], 0, kGroup) * s_carry;
    }
  }
}

template <int P>
int launch(const void* rays, const void* z, const void* field,
           const void* g_rgb, const void* g_depth, const void* g_acc,
           void* g_field, long long n_rays, int K, int white_bkgd,
           long long blocks, int threads, int shared_bytes,
           cudaStream_t stream) {
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd_kernel<P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  composite_bwd_kernel<P><<<static_cast<unsigned>(blocks), threads,
                            shared_bytes, stream>>>(
      static_cast<const float*>(rays), static_cast<const float*>(z),
      static_cast<const float4*>(field), static_cast<const float*>(g_rgb),
      static_cast<const float*>(g_depth), static_cast<const float*>(g_acc),
      static_cast<float4*>(g_field), n_rays, K, white_bkgd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rays (N, 8) f32 [origin 3 | dir 3 | near | far]; z (N, K) f32 ascending;
// field (N * K, 4) f32 [rgb | sigma]; g_rgb (N, 3), g_depth (N), g_acc (N)
// f32, the upstream gradients of K4's outputs; g_field (N * K, 4) f32 out;
// field and g_field 16-byte aligned; N >= 1, K >= 1; `blocks` of `threads`
// threads (a multiple of 32, at most 128) hold threads / kGroup rays each,
// with `shared_bytes` of dynamic shared memory for the tiles before the
// last (kernels/composite.py:backward_geometry gives all three). Returns
// the cudaGetLastError() code of the launch.
extern "C" int composite_rays_backward_launch(
    const void* rays, const void* z, const void* field, const void* g_rgb,
    const void* g_depth, const void* g_acc, void* g_field, long long n_rays,
    int K, int white_bkgd, long long blocks, int threads, int shared_bytes,
    void* stream) {
  const int per_lane = (K + kGroup - 1) / kGroup;
  const auto s = static_cast<cudaStream_t>(stream);
#define DINER_BWD_CASE(P)                                                \
  case P:                                                                \
    return launch<P>(rays, z, field, g_rgb, g_depth, g_acc, g_field,     \
                     n_rays, K, white_bkgd, blocks, threads,             \
                     shared_bytes, s);
  switch (per_lane < kMaxPerLane ? per_lane : kMaxPerLane) {
    DINER_BWD_CASE(1)
    DINER_BWD_CASE(2)
    DINER_BWD_CASE(3)
    DINER_BWD_CASE(4)
    DINER_BWD_CASE(5)
    DINER_BWD_CASE(6)
    DINER_BWD_CASE(7)
    default:
      return launch<kMaxPerLane>(rays, z, field, g_rgb, g_depth, g_acc,
                                 g_field, n_rays, K, white_bkgd, blocks,
                                 threads, shared_bytes, s);
  }
#undef DINER_BWD_CASE
}
