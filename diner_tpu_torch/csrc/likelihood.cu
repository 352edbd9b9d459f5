// Fused anchor remap + gated erf-bin surface likelihood (sm_90a).
//
// Replaces the TPU kernel likelihood_from_anchors / _likelihood_kernel of
// diner_tpu/sampler/pallas_likelihood.py. For each depth candidate t of a
// (ray, view) group g it takes its anchor's [depth, std, cos] and returns
//   p = 0.5 * |erf((z + hs - d) / (sqrt2 std)) - erf((z - hs - d) / (sqrt2 std))|
// where cos <= 0, |d - z| < ddm and std != 0, else 0.
//
// Design. The TPU kernel builds an (A, NC) one-hot and contracts it on the
// MXU with a 3-way bf16 split, because TPU Pallas cannot gather, and uses the
// A&S 7.1.26 erf polynomial because erf does not lower there. Neither is
// needed here: one block per group stages vals[g] (3 x A f32, 3 KB at A=256)
// in shared memory, and its threads stride over the NC candidates with
// coalesced reads of a and z_cam, an indexed shared-memory read (an exact f32
// selection) and the gates and erff in registers. Only p is written.
//
// Bound on the H100 (3.35 TB/s HBM): the kernel is memory-bound. At the
// preset's chunk (G = 16,384 groups, NC = 1000, A = 256) it must move
// a + z_cam + p = 3 * G * NC * 4 B = 197 MB plus vals = G * 3 * A * 4 B =
// 50 MB, about 74 us; its arithmetic (two erff per candidate) is a few
// percent of the f32 rate. The design reads every input byte once.
//
// `sel`, when not null, receives the selected [depth, std, cos] per
// candidate as (G, 3, NC): a check of the selection against the plain
// PyTorch version, never used on the render path.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kSqrt2 = 1.41421356237309504880f;

__global__ void __launch_bounds__(kThreads)
likelihood_kernel(const int* __restrict__ a, const float* __restrict__ vals,
                  const float* __restrict__ z_cam,
                  const float* __restrict__ half_step,
                  float* __restrict__ out, float* __restrict__ sel, int NC,
                  int A, float ddm) {
  extern __shared__ float s_vals[];  // [depth(A) | std(A) | cos(A)]
  const long long g = blockIdx.x;
  const float* v = vals + g * 3 * A;
  for (int i = threadIdx.x; i < 3 * A; i += blockDim.x) s_vals[i] = v[i];
  __syncthreads();

  const float hs = half_step[g];
  const long long row = g * NC;
  for (int t = threadIdx.x; t < NC; t += blockDim.x) {
    // ids come clipped to [0, A) from the caller; clamp anyway so that no
    // input can read outside shared memory
    const int ai = min(max(a[row + t], 0), A - 1);
    const float d = s_vals[ai];
    const float std = s_vals[A + ai];
    const float cs = s_vals[2 * A + ai];
    const float z = z_cam[row + t];
    const bool valid = (cs <= 0.f) && (fabsf(d - z) < ddm) && (std != 0.f);
    const float sstd = (std == 0.f ? 1.f : std) * kSqrt2;
    const float hi = erff((z + hs - d) / sstd);
    const float lo = erff((z - hs - d) / sstd);
    out[row + t] = valid ? 0.5f * fabsf(hi - lo) : 0.f;
    if (sel != nullptr) {
      float* s = sel + g * 3 * NC;
      s[t] = d;
      s[NC + t] = std;
      s[2 * NC + t] = cs;
    }
  }
}

}  // namespace

// a (G, NC) int32; vals (G, 3, A) f32; z_cam (G, NC) f32; half_step (G, 1)
// f32; out (G, NC) f32; sel (G, 3, NC) f32 or null. Returns the
// cudaGetLastError() code of the launch.
extern "C" int likelihood_from_anchors_launch(
    const void* a, const void* vals, const void* z_cam, const void* half_step,
    void* out, void* sel, int G, int NC, int A, float ddm, void* stream) {
  if (G == 0 || NC == 0) return 0;
  const size_t smem = 3 * static_cast<size_t>(A) * sizeof(float);
  likelihood_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const float*>(vals),
      static_cast<const float*>(z_cam), static_cast<const float*>(half_step),
      static_cast<float*>(out), static_cast<float*>(sel), NC, A, ddm);
  return static_cast<int>(cudaGetLastError());
}
