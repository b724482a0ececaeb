// Shared-matrix bucket extraction with optional power measures.
//
// Replaces the Pallas kernels fdc_tpu/ops/extract_pallas.py
// _kernel_shared_measured and _kernel_shared (fused_extract_shared),
// including _kernel_shared's fold_phase_r branch (extract_pallas.py:142-172).
//
// What it computes, for C static bin slices of width l starting at
// starts[c] in the [R, N] complex64 spectrum:
//
//   out[c, r, :] = interleave(spec[r, s_c : s_c + l]) @ M        [2k]
//   powers[r, :] = |spec[r, :]|^2 @ masks                        [Cm]
//
// where interleave() is the slice's raw float pairs (re0, im0, re1, ...),
// so a row of the gathered operand is 2l CONTIGUOUS floats of the spectrum
// and M is the folded window * gain * trim * IDFT matrix with its rows in
// the same (re, im) interleaved order (output columns interleaved too).
// The planar re/im split of the TPU kernel was a workaround for the TPU
// boundary; reading the interleaved complex64 spectrum directly needs no
// planar copy.
//
// What bounds it on the H100: the flagship throughput bucket is a
// [C*R, 2l] x [2l, 2k] = [32768, 128] x [128, 96] product (0.8 GFLOP fp32)
// over ~13 MB of gathered spectrum and 12.6 MB of output; the measures are
// a [512, 4096] x [4096, 128] product (0.54 GFLOP). Both sit near the
// fp32 FFMA ridge (no TF32: it would cost ~40 dB of output SNR), so the
// kernel is a plain register-tiled fp32 FFMA GEMM whose A-tile loader
// gathers rows at the static starts straight from device memory — the
// gathered [C, R, 2l] operand never exists in device memory.
//
// What the design does about it (the GEMM is tile_gemm.cuh, shared with
// extract_static.cu): 64x64 output tiles, BK=16 k-steps staged
// in shared memory, a 4x4 micro-tile per thread (256 threads). The
// measures' long contraction (N = 4096) over few output tiles is split
// along k into partial sums that a second pass adds in a fixed order
// (deterministic, no atomics), which fills the SMs. The mask matrix and
// the burst bucket's 256 x 192 matrix never need to fit in shared memory
// whole: they stream through it tile by tile. wgmma/TMA pipelines are
// later work.
//
// The phase fold (fold_r = R in {2, 4}; 0 or 1 = none): the overlap-save
// phase compensation of a throughput bucket whose row 0 has a global
// block index that is a multiple of R. Every factor is a quarter turn, so
// the GEMM's store epilogue applies it as a pair swap between neighbouring
// lanes (__shfl_xor_sync) and a sign (tile_gemm.cuh, FOLD_R): no extra
// pass over the [C, R, 2k] output and no cos/sin round-off. It adds a few
// register operations per output float to a kernel bound by its FFMAs.

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

using fdc_gemm::BK;
using fdc_gemm::BM;
using fdc_gemm::BN;
using fdc_gemm::NT;
using fdc_gemm::tile_gemm;

// powers = sum over the k-split partials, in split order
__global__ void sum_splits(const float* __restrict__ part, int splits,
                           int len, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += part[static_cast<size_t>(z) * len + i];
  out[i] = s;
}

}  // namespace

// spec: complex64 [rows, n]; starts: int32 [c] (device); mat: float32
// [k2, nout] (rows interleaved re/im); out: float32 [c, rows, nout].
// masks (nullable): float32 [n, cm]; partial: float32 [splits, rows, cm]
// scratch; powers: float32 [rows, cm]. fold_r: the quarter-turn phase
// fold's R (0 or 1: none; 2 or 4; anything else is refused).
extern "C" int fdc_extract_shared(
    const void* spec, int rows, int n, const void* starts, int c,
    const void* mat, int k2, int nout, void* out,
    const void* masks, int cm, void* partial, int splits, void* powers,
    int fold_r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(spec);
  const int* s = static_cast<const int*>(starts);
  const float* b = static_cast<const float*>(mat);
  float* o = static_cast<float*>(out);
  const int m = c * rows;
  dim3 grid((m + BM - 1) / BM, (nout + BN - 1) / BN, 1);
  switch (fold_r) {
    case 0:
    case 1:
      tile_gemm<0><<<grid, NT, 0, st>>>(sp, rows, n, s, b, k2, nout, m, k2,
                                         o);
      break;
    case 2:
      tile_gemm<0, 2><<<grid, NT, 0, st>>>(sp, rows, n, s, b, k2, nout, m,
                                            k2, o);
      break;
    case 4:
      tile_gemm<0, 4><<<grid, NT, 0, st>>>(sp, rows, n, s, b, k2, nout, m,
                                            k2, o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (masks != nullptr) {
    const int chunk = ((n + splits - 1) / splits + BK - 1) / BK * BK;
    dim3 g2((rows + BM - 1) / BM, (cm + BN - 1) / BN, splits);
    tile_gemm<1><<<g2, NT, 0, st>>>(
        sp, rows, n, nullptr, static_cast<const float*>(masks), n, cm,
        rows, chunk, static_cast<float*>(partial));
    const int len = rows * cm;
    sum_splits<<<(len + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(partial), splits, len,
        static_cast<float*>(powers));
  }
  return static_cast<int>(cudaGetLastError());
}
