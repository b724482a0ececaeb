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
// What the design does about it: the register-tiled GEMM of
// tile_gemm.cuh — grid z walks the channels,
// each channel's A-tile loader gathers rows at its static start straight
// from the spectrum and its B tiles come from its own matrix, so the
// gathered [C, R, 2l] operand never exists in device memory. The ragged
// last row tile (513 = 8 * 64 + 1) is masked. wgmma/TMA pipelines are
// later work.

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

// spec: complex64 [rows, n]; starts: int32 [c] (device); mats: float32
// [c, k2, nout] (rows interleaved re/im); out: float32 [c, rows, nout].
extern "C" int fdc_extract_static(
    const void* spec, int rows, int n, const void* starts, int c,
    const void* mats, int k2, int nout, void* out, void* stream) {
  using namespace fdc_gemm;
  dim3 grid((rows + BM - 1) / BM, (nout + BN - 1) / BN, c);
  tile_gemm<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(spec), rows, n,
      static_cast<const int*>(starts), static_cast<const float*>(mats), k2,
      nout, rows, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
