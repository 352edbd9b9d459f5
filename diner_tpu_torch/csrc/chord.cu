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
// Design. The TPU kernel splits the anchor table into three bf16 chunks,
// lays it out as (9 lo_w, A / lo_w) and selects with a two-level one-hot on
// the MXU, because TPU Pallas cannot gather; and it uses the A&S erf
// polynomial. None of that is needed here. One block per ray stages the
// ray's NV anchor tables (NV x 3 x A f32, 12 KB at NV = 4, A = 256) and chord
// scalars in shared memory; its threads stride over the NC candidates,
// read z once for all NV views, and select by an indexed shared-memory read,
// which is exact by construction. erff is the semantics of the JAX
// package's XLA path, as in K1.
//
// Rounding. The chord arithmetic decides the anchor id, so it is rounded
// exactly as the plain PyTorch version rounds it, one operation at a time:
// the _rn intrinsics keep nvcc from contracting w0 + z * w1 and
// P0 + z * P1 into FMAs, which would flip ids at anchor boundaries.
//
// Bound on the H100 (3.35 TB/s HBM): the kernel is memory-bound. At the
// preset's chunk (SB = 1, NV = 4, NR = 4,096, NC = 1,000, A = 256) it must
// read z (16.4 MB), the scalars (0.5 MB) and the anchor tables (50.3 MB) and
// write p (65.5 MB): 132.8 MB, about 40 us. Its some 66 operations per
// (view, candidate) take about 16 us at the f32 rate.
//
// `ids`, when not null, receives each (view, candidate)'s anchor id as
// (SB, NV, NR, NC) int32: a check of the selection against the plain
// version, never used on the render path.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScalars = 8;
constexpr float kSqrt2 = 1.41421356237309504880f;

__global__ void __launch_bounds__(kThreads)
chord_kernel(const float* __restrict__ z, const float* __restrict__ scal,
             const float* __restrict__ vals, float* __restrict__ p,
             int* __restrict__ ids, int NV, int NR, int NC, int A, float ddm) {
  extern __shared__ float smem[];  // [NV x 8 scalars | NV x 3 x A table]
  float* s_scal = smem;
  float* s_vals = smem + NV * kScalars;
  const long long ray = blockIdx.x;  // sb * NR + r
  const long long sb = ray / NR;
  const long long r = ray % NR;

  for (int i = threadIdx.x; i < NV * kScalars; i += blockDim.x) {
    const int v = i / kScalars;
    s_scal[i] = scal[((sb * NV + v) * NR + r) * kScalars + i % kScalars];
  }
  for (int i = threadIdx.x; i < NV * 3 * A; i += blockDim.x) {
    const int v = i / (3 * A);
    s_vals[i] = vals[((sb * NV + v) * NR + r) * 3 * A + i % (3 * A)];
  }
  __syncthreads();

  const float* zr = z + ray * NC;
  for (int t = threadIdx.x; t < NC; t += blockDim.x) {
    const float zt = zr[t];
    for (int v = 0; v < NV; ++v) {
      const float* sc = s_scal + v * kScalars;
      const float zc = __fadd_rn(sc[0], __fmul_rn(zt, sc[1]));
      const bool front = (sc[6] > 0.f) && (zc > 1e-9f);
      const float zc_safe = fabsf(zc) > 1e-9f ? zc : 1.f;
      const float tt = __fdiv_rn(
          __fmul_rn(__fadd_rn(sc[2], __fmul_rn(zt, sc[3])), sc[4]), zc_safe);
      const float s = sc[5] > 0.f ? tt : 0.5f;
      // fminf/fmaxf send a NaN s to 0, where the plain version's int cast
      // and clamp also land
      const float sa = __fmul_rn(fminf(fmaxf(s, 0.f), 1.f),
                                 static_cast<float>(A));
      const int a = min(max(static_cast<int>(sa), 0), A - 1);
      const float* tab = s_vals + v * 3 * A;
      const float d = tab[a];
      const float std = tab[A + a];
      const float cs = tab[2 * A + a];
      const float hs = sc[7];
      const bool valid = front && (cs <= 0.f) &&
                         (fabsf(__fsub_rn(d, zc)) < ddm) && (std != 0.f);
      const float sstd = __fmul_rn(std == 0.f ? 1.f : std, kSqrt2);
      const float hi =
          erff(__fdiv_rn(__fsub_rn(__fadd_rn(zc, hs), d), sstd));
      const float lo =
          erff(__fdiv_rn(__fsub_rn(__fsub_rn(zc, hs), d), sstd));
      const long long o = ((sb * NV + v) * NR + r) * NC + t;
      p[o] = valid ? 0.5f * fabsf(hi - lo) : 0.f;
      if (ids != nullptr) ids[o] = a;
    }
  }
}

}  // namespace

// z (SB, NR, NC) f32; scal (SB, NV, NR, 8) f32; vals (SB, NV, NR, 3, A) f32;
// p (SB, NV, NR, NC) f32; ids (SB, NV, NR, NC) int32 or null. Returns the
// cudaGetLastError() code of the launch.
extern "C" int likelihood_from_chord_launch(const void* z, const void* scal,
                                            const void* vals, void* p,
                                            void* ids, int SB, int NV, int NR,
                                            int NC, int A, float ddm,
                                            void* stream) {
  if (SB == 0 || NV == 0 || NR == 0 || NC == 0) return 0;
  const size_t smem =
      (static_cast<size_t>(NV) * kScalars + 3 * static_cast<size_t>(NV) * A) *
      sizeof(float);
  chord_kernel<<<SB * NR, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(scal),
      static_cast<const float*>(vals), static_cast<float*>(p),
      static_cast<int*>(ids), NV, NR, NC, A, ddm);
  return static_cast<int>(cudaGetLastError());
}
