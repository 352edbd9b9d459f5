// Fused chord arithmetic + anchor selection + gated erf-bin likelihood
// (sm_90a).
//
// Replaces the TPU kernel likelihood_from_chord / _chord_kernel of
// diner_tpu/sampler/pallas_likelihood.py. For each ray r, view v and depth
// candidate z (a distance along the ray, the same for every view) it takes
// the per-(view, ray) chord scalars [w0, w1, P0, P1, inv_dd, dd_ok,
// chord_ok, hs] and computes, in this order,
//   zc    = w0 + z * w1                         the candidate's cam depth
//   front = chord_ok > 0 and zc > 1e-9
//   t     = (P0 + z * P1) * inv_dd / (|zc| > 1e-9 ? zc : 1)
//   s     = dd_ok > 0 ? t : 0.5
//   a     = clip(int(clip(s, 0, 1) * A), 0, A - 1)   the nearest anchor
// then K1's gated mass under anchor a's [depth d, std, cos]:
//   p = 0.5 * |erf((zc + hs - d) / (sqrt2 std))
//              - erf((zc - hs - d) / (sqrt2 std))|
// where front, cos <= 0, |d - zc| < ddm and std != 0, else 0.
//
// Bound on the H100. The bytes: z (16.4 MB), the scalars (0.5 MB) and the
// anchor tables (50.3 MB) in, p (65.5 MB) out, 132.8 MB or about 40 us at
// 3.35 TB/s for the preset's chunk (SB 1, NV 4, NR 4,096, NC 1,000, A 256).
// But the work per (view, candidate) is not FMAs: three IEEE divisions
// (reciprocal, Newton steps and a slow-path check each), two erff, the gates
// and the selection came to 157 SASS instructions in the loop body of the
// one-candidate-per-thread design, about 70 M warp instructions a chunk,
// which the card issues in about as long as that design took. It was bound
// by instruction issue, not by bytes. The design below issues about half as
// many instructions per (view, candidate) and comes to within about 1.6x of
// the bytes bound (PERF.md).
//
// Design.
// - Per-anchor precompute while staging. Each block stages, per view, a
//   table of (d, r) pairs with r = 1 / (sqrt2 std) where cos <= 0 and
//   std != 0, else 0, read from vals with 16-byte loads where A % 4 == 0.
//   The erf arguments become (zc +- hs - d) * r: two of the three divisions
//   per (view, candidate) move into the table (A per view instead of NC),
//   and r == 0 is the cos and std gate. A std so small that r overflows
//   keeps r at +-FLT_MAX, so a zero argument stays 0 (0 * inf is NaN); a NaN
//   std gives a NaN r and a NaN p, as in the plain version. The products
//   move p by a few 1e-8 at most (erf' <= 1.13).
// - The chord arithmetic decides the anchor id, so it is rounded exactly as
//   the plain PyTorch version rounds it, one operation at a time: the _rn
//   intrinsics keep nvcc from contracting w0 + z * w1 and P0 + z * P1 into
//   FMAs, and the one division that decides the id stays. The ids are equal
//   to the plain version's bit for bit.
// - Both erff are skipped where the gate is off (not in front, r == 0, or
//   |d - zc| >= ddm); p is still written, as 0.
// - Four candidates per thread: z is read as one float4, and p (and ids) are
//   written as one float4 (int4) per view, where NC % 4 == 0 and z is
//   16-byte aligned; otherwise as four scalars with a bound check.
// - One block per ray (the first design's grid), with as many threads as
//   the ray's candidate quads need, up to 256; the table of every view
//   (NV x (8 + 2A) floats, 8.3 KB at the preset) takes dynamic shared
//   memory, above 48 KB by opting in, so NV = 4 takes A up to 7,260.
// The design it replaces: one candidate per thread, a (d, std, cos) table,
// three divisions and two erff for every (view, candidate).
//
// `ids`, when not null, receives each (view, candidate)'s anchor id as
// (SB, NV, NR, NC) int32: a check of the selection against the plain
// version, never used on the render path.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScalars = 8;
constexpr int kMaxThreads = 256;
constexpr float kSqrt2 = 1.41421356237309504880f;

// The staged (d, r) of one anchor.
__device__ __forceinline__ float2 anchor_entry(float d, float std, float cs) {
  float r = 0.f;
  if (cs <= 0.f && std != 0.f) {
    r = __fdiv_rn(1.f, __fmul_rn(std, kSqrt2));
    if (isinf(r)) r = copysignf(FLT_MAX, r);
  }
  return make_float2(d, r);
}

template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
chord_kernel(const float* __restrict__ z, const float* __restrict__ scal,
             const float* __restrict__ vals, float* __restrict__ p,
             int* __restrict__ ids, int NV, int NR, int NC, int A, float ddm,
             bool vals_vec) {
  extern __shared__ float4 smem[];
  float* s_scal = reinterpret_cast<float*>(smem);        // NV x 8
  float2* s_tab = reinterpret_cast<float2*>(smem + 2 * NV);  // NV x A (d, r)
  const int ray = blockIdx.x;  // sb * NR + r
  const int sb = ray / NR;
  // row of (sb, v, r) in the (SB, NV, NR, ...) arrays is row0 + v * NR
  const int row0 = sb * NV * NR + (ray - sb * NR);

  for (int i = threadIdx.x; i < NV * kScalars; i += blockDim.x) {
    s_scal[i] = scal[static_cast<size_t>(row0 + (i >> 3) * NR) * kScalars +
                     (i & 7)];
  }
  if (vals_vec) {
    const int A4 = A >> 2;
    for (int i = threadIdx.x; i < NV * A4; i += blockDim.x) {
      const int v = i / A4;
      const int j = i - v * A4;
      const float4* src = reinterpret_cast<const float4*>(
          vals + static_cast<size_t>(row0 + v * NR) * 3 * A) + j;
      const float4 d = __ldg(src), s = __ldg(src + A4), c = __ldg(src + 2 * A4);
      const float2 e0 = anchor_entry(d.x, s.x, c.x);
      const float2 e1 = anchor_entry(d.y, s.y, c.y);
      const float2 e2 = anchor_entry(d.z, s.z, c.z);
      const float2 e3 = anchor_entry(d.w, s.w, c.w);
      float4* dst = reinterpret_cast<float4*>(s_tab + v * A) + 2 * j;
      dst[0] = make_float4(e0.x, e0.y, e1.x, e1.y);
      dst[1] = make_float4(e2.x, e2.y, e3.x, e3.y);
    }
  } else {
    for (int i = threadIdx.x; i < NV * A; i += blockDim.x) {
      const int v = i / A;
      const float* src =
          vals + static_cast<size_t>(row0 + v * NR) * 3 * A + (i - v * A);
      s_tab[i] = anchor_entry(__ldg(src), __ldg(src + A), __ldg(src + 2 * A));
    }
  }
  __syncthreads();

  const float* zr = z + static_cast<size_t>(ray) * NC;
  const int quads = (NC + 3) >> 2;
  const float fA = static_cast<float>(A);
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    const int t0 = q << 2;
    float zt[4];
    if (kVec) {
      const float4 z4 = __ldg(reinterpret_cast<const float4*>(zr) + q);
      zt[0] = z4.x; zt[1] = z4.y; zt[2] = z4.z; zt[3] = z4.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) zt[k] = t0 + k < NC ? __ldg(zr + t0 + k) : 0.f;
    }
    for (int v = 0; v < NV; ++v) {
      const float4 c0 = reinterpret_cast<const float4*>(s_scal)[2 * v];
      const float4 c1 = reinterpret_cast<const float4*>(s_scal)[2 * v + 1];
      // c0 = (w0, w1, P0, P1), c1 = (inv_dd, dd_ok, chord_ok, hs)
      const float2* tab = s_tab + v * A;
      float pk[4];
      int ak[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float zc = __fadd_rn(c0.x, __fmul_rn(zt[k], c0.y));
        const float zc_safe = fabsf(zc) > 1e-9f ? zc : 1.f;
        const float tt = __fdiv_rn(
            __fmul_rn(__fadd_rn(c0.z, __fmul_rn(zt[k], c0.w)), c1.x), zc_safe);
        const float s = c1.y > 0.f ? tt : 0.5f;
        // fminf/fmaxf send a NaN s to 0, where the plain version's int cast
        // and clamp also land
        const float sa = __fmul_rn(fminf(fmaxf(s, 0.f), 1.f), fA);
        const int a = min(max(static_cast<int>(sa), 0), A - 1);
        const float2 e = tab[a];
        float pv = 0.f;
        if (c1.z > 0.f && zc > 1e-9f && e.y != 0.f &&
            fabsf(__fsub_rn(e.x, zc)) < ddm) {
          const float hi =
              erff(__fmul_rn(__fsub_rn(__fadd_rn(zc, c1.w), e.x), e.y));
          const float lo =
              erff(__fmul_rn(__fsub_rn(__fsub_rn(zc, c1.w), e.x), e.y));
          pv = 0.5f * fabsf(hi - lo);
        }
        pk[k] = pv;
        ak[k] = a;
      }
      const size_t o = static_cast<size_t>(row0 + v * NR) * NC + t0;
      if (kVec) {
        *reinterpret_cast<float4*>(p + o) =
            make_float4(pk[0], pk[1], pk[2], pk[3]);
        if (ids != nullptr)
          *reinterpret_cast<int4*>(ids + o) =
              make_int4(ak[0], ak[1], ak[2], ak[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (t0 + k < NC) {
            p[o + k] = pk[k];
            if (ids != nullptr) ids[o + k] = ak[k];
          }
        }
      }
    }
  }
}

template <bool kVec>
int launch(const float* z, const float* scal, const float* vals, float* p,
           int* ids, int SB, int NV, int NR, int NC, int A, float ddm,
           int threads, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chord_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vals_vec =
      A % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  chord_kernel<kVec><<<SB * NR, threads, smem, stream>>>(
      z, scal, vals, p, ids, NV, NR, NC, A, ddm, vals_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z (SB, NR, NC) f32; scal (SB, NV, NR, 8) f32; vals (SB, NV, NR, 3, A) f32;
// p (SB, NV, NR, NC) f32; ids (SB, NV, NR, NC) int32 or null. `threads` and
// `smem` (dynamic shared memory bytes) come from the wrapper's
// launch_geometry. Returns the cudaGetLastError() code of the launch.
extern "C" int likelihood_from_chord_launch(const void* z, const void* scal,
                                            const void* vals, void* p,
                                            void* ids, int SB, int NV, int NR,
                                            int NC, int A, float ddm,
                                            int threads, int smem,
                                            void* stream) {
  if (SB == 0 || NV == 0 || NR == 0 || NC == 0) return 0;
  const auto* zf = static_cast<const float*>(z);
  const bool vec = NC % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ids) % 16 == 0;
  auto* fn = vec ? &launch<true> : &launch<false>;
  return fn(zf, static_cast<const float*>(scal),
            static_cast<const float*>(vals), static_cast<float*>(p),
            static_cast<int*>(ids), SB, NV, NR, NC, A, ddm, threads, smem,
            static_cast<cudaStream_t>(stream));
}
