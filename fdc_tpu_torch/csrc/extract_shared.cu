// Shared-matrix bucket extraction with optional power measures (kernel A).
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
// What bounds it on the H100: fp32 FFMA (no TF32: it would cost ~40 dB
// of output SNR). The example's bucket with its measures is [512, 2048] x
// [2048, 1536] plus [512, 1938] x [1938, 54]: the measures need only the
// 54 mask columns in use of 128 and the 1938 bins they cover. That is
// 3.33 GFLOP, 49.7 us at 67 TFLOP/s, over 26 MB, 8 us at 3.35 TB/s. The
// flagship's is [32768, 128] x [128, 96] plus 34 measure columns over 412
// bins (0.82 GFLOP, 12.2 us). An FFMA GEMM reaches that rate only if
// shared-memory loads, copies and barriers hide behind its FFMAs and its
// grid fills the 132 SMs evenly.
//
// What the design does about it: gather_gemm.cuh, an 8 x 8 micro-tile a
// thread and a 3-stage cp.async ring, its A loader gathering the slices
// (or squaring the spectrum, for the measures) straight from device
// memory. ops/extract_fused.py picks the tile and any k split per call
// from the shapes (gemm_plan): tiles of 128 rows by 96, 128 or 64 columns
// (nout padded by at most an eighth where one of them allows), split
// along k into the most ranges whose grid still runs in one wave (two
// CTAs an SM). The measures run on the same body over only the mask
// columns and the k range the caller names (mask_extent, computed where
// the masks are built; the rest of the mask matrix is zero padding:
// exact zeros), split along k. Split partial sums are added in split
// order by one more launch, sum_splits, for the extraction and the
// measures together (no atomics); it writes the measures' unused columns
// as zeros. The phase fold (fold_r = R in {2, 4}; 0 or 1 = none) is the
// GEMM's store epilogue: a select and a negation inside the thread.

#include <cuda_runtime.h>

#include "gather_gemm.cuh"

namespace {

using fdc_gather::Args;
using fdc_gather::launch;
using fdc_gather::sum_splits;

template <int FOLD_R>
int run_tile(const Args& a, int bm, int bn, cudaStream_t st) {
  if (bm != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (bn == 96) return launch<128, 96, false, FOLD_R>(a, 1, st);
  if (bn == 128) return launch<128, 128, false, FOLD_R>(a, 1, st);
  if (bn == 64) return launch<128, 64, false, FOLD_R>(a, 1, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// spec: complex64 [rows, n]; starts: int32 [c] (device); mat: float32
// [k2, nout] (rows interleaved re/im); out: float32 [c, rows, nout].
// The extraction runs on (bm, bn) tiles in `splits` k ranges of k_chunk
// floats; with splits > 1 its partial sums go to part [splits, c * rows,
// nout]. fold_r: the quarter-turn phase fold's R (0 or 1: none; 2 or 4;
// anything else is refused).
// masks (nullable): float32 [n, cm]; the measures use its columns
// [0, cu) and rows [k_lo, k_hi) (k_lo a multiple of 16), on 64 x 64
// tiles in m_splits k ranges of m_chunk bins, partial sums in m_part
// [m_splits, rows, cu]; powers: float32 [rows, cm].
extern "C" int fdc_extract_shared(
    const void* spec, int rows, int n, const void* starts, int c,
    const void* mat, int k2, int nout, void* out, int bm, int bn, int splits,
    int k_chunk, void* part, int fold_r, const void* masks, int cm, int cu,
    int k_lo, int k_hi, int m_splits, int m_chunk, void* m_part,
    void* powers, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(spec);
  Args a{sp, rows, n, static_cast<const int*>(starts),
         static_cast<const float*>(mat), nout, 0, c * rows, nout, c * rows,
         0, 0, k2, k_chunk, splits,
         static_cast<float*>(splits > 1 ? part : out)};
  int rc;
  switch (fold_r) {
    case 0:
    case 1:
      rc = run_tile<0>(a, bm, bn, st);
      break;
    case 2:
      rc = run_tile<2>(a, bm, bn, st);
      break;
    case 4:
      rc = run_tile<4>(a, bm, bn, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  if (masks != nullptr && cu > 0) {
    Args mp{sp, rows, n, nullptr, static_cast<const float*>(masks), cm, 0,
            rows, cu, rows, 0, k_lo, k_hi, m_chunk, m_splits,
            static_cast<float*>(m_part)};
    rc = launch<64, 64, true, 0>(mp, 1, st);
    if (rc != 0) return rc;
  }
  const int ext_len = splits > 1 ? c * rows * nout : 0;
  const int m_len = masks != nullptr ? rows * cm : 0;
  const int len = ext_len > m_len ? ext_len : m_len;
  if (len > 0) {
    dim3 grid((len + 255) / 256, m_len > 0 ? 2 : 1);
    sum_splits<<<grid, 256, 0, st>>>(
        static_cast<const float*>(part), splits, ext_len,
        static_cast<float*>(out), static_cast<const float*>(m_part),
        masks != nullptr && cu > 0 ? m_splits : 0, rows, cu, cm,
        static_cast<float*>(masks != nullptr ? powers : nullptr));
  }
  return static_cast<int>(cudaGetLastError());
}
