// Static-bucket extraction with a matrix per channel (kernel E).
//
// Replaces the Pallas kernel fdc_tpu/ops/extract_pallas.py _kernel
// (fused_extract_static), which the JAX package runs for a static bucket
// whose channels have different windows: the throughput + burst buckets
// that share an FFT width, and buckets of channels with different
// bandwidths that round to one width.
//
// What it computes, for C static bin slices of width l starting at
// starts[c] in the [R, N] complex64 spectrum, each with its own folded
// window * gain * trim * IDFT matrix M_c [2l, 2k]:
//
//   out[c, r, :] = interleave(spec[r, s_c : s_c + l]) @ M_c           [2k]
//
// read and written in the float-pair layouts of kernel A (rows of M_c
// interleaved (re, im), output columns interleaved).
//
// What bounds it on the H100: fp32 FFMA. The reference example's width-512
// bucket (C = 5, R = 513 rows of spec_ext, 2l = 1024, 2k = 768) is 4.0
// GFLOP over 34 MB (gathered slices 10.5 MB, matrices 15.7 MB, output
// 7.9 MB): 60 us at 67 TFLOP/s against 10 us at 3.35 TB/s. The TPU
// kernel's VMEM gate (fits_vmem) and its XLA fallback do not apply: the
// matrices stream through shared memory tile by tile.
//
// What the design does about it: kernel A's pipelined GEMM
// (gather_gemm.cuh: an 8 x 8 micro-tile a thread, a 3-stage cp.async
// ring gathering the slices straight from the spectrum) with one group a
// channel: grid z walks channel x k split, a row tile never straddles
// two channels (their matrices differ), and the B loader reads channel
// c's matrix. The trap is the channels' last rows: R = 513 = 4 * 128 + 1,
// so a fifth 128-row tile a channel would cost a whole tile's FFMAs for
// one row (40 of w512's 200 CTAs). Instead the fourth tile also computes
// the one or two rows past it (gather_gemm's XR tail: a thread each, 16
// products a stage). The tile width and the k splits come from the
// wrapper (ops/extract_fused.py static_plan); split partial sums are
// added in split order by gather_gemm.cuh's sum_splits, as kernel A's.

#include <cuda_runtime.h>

#include "gather_gemm.cuh"

namespace {

using fdc_gather::Args;
using fdc_gather::launch;

constexpr int TAIL = 2;  // rows a channel's last tile may add

int run_tile(const Args& a, int bm, int bn, int groups, cudaStream_t st) {
  if (bm != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (bn == 96) return launch<128, 96, false, 0, TAIL>(a, groups, st);
  if (bn == 128) return launch<128, 128, false, 0, TAIL>(a, groups, st);
  if (bn == 64) return launch<128, 64, false, 0, TAIL>(a, groups, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// spec: complex64 [rows, n]; starts: int32 [c] (device); mats: float32
// [c, k2, nout] (rows interleaved re/im); out: float32 [c, rows, nout].
// Each channel's rows run on (bm, bn) tiles, the last taking the `tail`
// rows (0 ... 2, rows % bm) past the whole tiles, in `splits` k ranges of
// k_chunk floats; with splits > 1 the partial sums go to part [splits, c
// * rows, nout].
extern "C" int fdc_extract_static(
    const void* spec, int rows, int n, const void* starts, int c,
    const void* mats, int k2, int nout, void* out, int bm, int bn,
    int splits, int k_chunk, int tail, void* part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(spec), rows, n,
         static_cast<const int*>(starts), static_cast<const float*>(mats),
         nout, static_cast<size_t>(k2) * nout, c * rows, nout, rows, tail,
         0, k2, k_chunk, splits,
         static_cast<float*>(splits > 1 ? part : out)};
  int rc = run_tile(a, bm, bn, c, st);
  if (rc != 0 || splits < 2) return rc;
  const int len = c * rows * nout;
  fdc_gather::sum_splits<<<(len + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), splits, len, static_cast<float*>(out),
      nullptr, 0, 0, 0, 0, nullptr);
  return static_cast<int>(cudaGetLastError());
}
