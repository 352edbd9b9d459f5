// Exact f32 anchor remap: out[g, c, t] = vals[g, c, a[g, t]] (sm_90a).
//
// Replaces the TPU kernel remap_anchors_pallas(exact=True) / _remap_kernel of
// diner_tpu/sampler/pallas_remap.py, which the field uses to read each
// sample's MVS depth from the sampler's anchor table (C = 1).
//
// Design. The TPU kernel contracts an (A, NS) one-hot on the MXU at HIGHEST
// precision because TPU Pallas cannot gather. Here one thread per output
// element does a direct indexed load: a bit-exact f32 copy. Consecutive
// threads take consecutive t, so the reads of a and the writes of out are
// coalesced; the reads of vals hit the group's A values, which the
// neighbouring threads of the same group share through L1/L2.
//
// Bound on the H100 (3.35 TB/s HBM): bytes. At the preset's chunk
// (G = 16,384, C = 1, NS = 32, A = 256) it must move a + out =
// G * NS * 8 B = 4.2 MB plus vals = G * A * 4 B = 16.8 MB, 21 MB or about
// 6 us. No arithmetic beyond addressing. A gather reads only the 32-byte
// sectors of vals that its ids touch, and on the render path they are
// scattered over most of each row. Designs that take out the 64-bit index
// arithmetic or change the access pattern (a thread per quad of samples,
// four outputs per thread, a warp per row staged with cp.async or held in
// registers) were measured against this one on the card and none was faster
// in isolation or in the render (PERF.md), so this design stays.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
remap_kernel(const int* __restrict__ a, const float* __restrict__ vals,
             float* __restrict__ out, long long total, int C, int NS, int K) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= total) return;
  const int t = static_cast<int>(i % NS);
  const long long gc = i / NS;  // g * C + c
  const long long g = gc / C;
  // ids come clipped to [0, K) from the caller; clamp so that no input can
  // read outside the group's row
  const int ai = min(max(a[g * NS + t], 0), K - 1);
  out[i] = vals[gc * K + ai];
}

}  // namespace

// a (G, NS) int32; vals (G, C, K) f32; out (G, C, NS) f32. `blocks` of 256
// threads come from the wrapper's launch_geometry. Returns the
// cudaGetLastError() code of the launch.
extern "C" int remap_anchors_launch(const void* a, const void* vals, void* out,
                                    int G, int C, int NS, int K,
                                    long long blocks, void* stream) {
  const long long total = static_cast<long long>(G) * C * NS;
  if (total == 0) return 0;
  remap_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const float*>(vals),
      static_cast<float*>(out), total, C, NS, K);
  return static_cast<int>(cudaGetLastError());
}
