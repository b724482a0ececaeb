// Greedy non-overlap acceptance of detection candidates.
//
// Replaces the Pallas kernel fdc_tpu/ops/detect.py _greedy_accept_kernel
// (greedy_accept_batch).
//
// What it computes: for each spectrum block b, walk its K candidate
// intervals [cs, ce) in strength order and accept candidate j iff it has
// a paired falling edge and overlaps no candidate accepted before it,
// with the reference's overlap test s_j < e_i && e_j >= s_i
// (reference: lib/SegmentDetection_impl.cc:195-244). Bit-exact with the
// unrolled jnp form (fdc_tpu/ops/detect.py greedy_accept_batch fallback).
//
// What bounds it on the H100: nothing in the data — the flagship's input
// is [512, 32] int32 twice plus [512, 32] bytes (~140 KB); the walk is a
// K-step dependency chain per block, so the kernel is latency bound.
//
// What the design does about it: one thread per block walks its chain
// serially (K^2 / 2 compares at most, K = 32 on the flagship), and the
// 512 blocks' chains run side by side in one launch instead of the ~2
// launches per candidate of an unrolled vectorized form.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void greedy_accept_kernel(const int* __restrict__ cs,
                                     const int* __restrict__ ce,
                                     const uint8_t* __restrict__ has_pair,
                                     uint8_t* __restrict__ out, int nb,
                                     int k) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const size_t base = static_cast<size_t>(b) * k;
  const int* s = cs + base;
  const int* e = ce + base;
  const uint8_t* hp = has_pair + base;
  uint8_t* acc = out + base;
  for (int j = 0; j < k; ++j) {
    bool accept = hp[j] != 0;
    if (accept) {
      const int sj = s[j];
      const int ej = e[j];
      for (int i = 0; i < j; ++i) {
        if (acc[i] && sj < e[i] && ej >= s[i]) {
          accept = false;
          break;
        }
      }
    }
    acc[j] = accept ? 1 : 0;
  }
}

}  // namespace

// cs, ce: int32 [nb, k]; has_pair, out: uint8 (bool) [nb, k]
extern "C" int fdc_greedy_accept(const void* cs, const void* ce,
                                 const void* has_pair, void* out, int nb,
                                 int k, void* stream) {
  const int threads = 128;
  greedy_accept_kernel<<<(nb + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cs), static_cast<const int*>(ce),
      static_cast<const uint8_t*>(has_pair), static_cast<uint8_t*>(out), nb,
      k);
  return static_cast<int>(cudaGetLastError());
}
