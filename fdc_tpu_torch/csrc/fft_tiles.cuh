// Shared-memory tile device functions of the FFT's tile probes (kernel P,
// fft_probes.cu).
//
// A CTA stages its operand slices in shared memory with 16-byte cp.async
// copies (stage_rows; one wait_all and one barrier for all of them) and
// then multiplies from shared memory only (dot_row: k a compile-time
// constant, fully unrolled). Every product is plain fp32 FFMA (no TF32).
//
//   stage_rows  dst[r * LD + c] = row(r)[c], r < ROWS, c < W     (async)
//   dot_row     acc[j] += sum_k A(k) * B[k * LDB + j], j < 4     A @ B
//
// A thread owns one row and four adjacent columns (a float4) of an
// output slice; the lanes of a quarter warp (the 8 lanes that one
// 16-byte shared load serves together) take adjacent column groups of
// as few rows as the slice width allows, so their B reads are adjacent
// float4 of one row (or one float4, broadcast) and their A reads one
// row (broadcast), adjacent words of one row (A transposed) or rows a
// pad apart: no bank conflicts (tests/test_torch_probe_schedule.py
// holds the banks).

#pragma once

#include <cuda_runtime.h>

namespace fdc_fft {

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// every cp.async of this thread landed; the caller's barrier then makes
// all threads' copies visible to the CTA
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// ROWS rows of W floats (W a multiple of 4, each row 16-byte aligned in
// device memory) into dst, row stride LD; row(r) is the source of row r.
// NT threads share the copies, 16 bytes each.
template <int ROWS, int W, int LD, int NT, typename RowFn>
__device__ __forceinline__ void stage_rows(float* dst, const RowFn& row) {
  static_assert(W % 4 == 0 && LD % 4 == 0, "16-byte rows");
  constexpr int kChunks = W / 4;
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * kChunks; e += NT) {
    const int r = e / kChunks, c = 4 * (e % kChunks);  // powers of two
    cp_async16(dst + r * LD + c, row(r) + c);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// acc += sum_k a(k) * B[k][0..3], k = 0 .. K-1 in order; b points at the
// thread's four columns of row 0, LDB the row stride. a4(k) gives
// A(k .. k+3) as a float4 (k a multiple of 4).
template <int K, int LDB, typename A4Fn>
__device__ __forceinline__ void dot_row(float4& acc, const A4Fn& a4,
                                        const float* b) {
#pragma unroll
  for (int k = 0; k < K; k += 4) {
    const float4 a = a4(k);
    fma4(acc, a.x, ld4(b + (k + 0) * LDB));
    fma4(acc, a.y, ld4(b + (k + 1) * LDB));
    fma4(acc, a.z, ld4(b + (k + 2) * LDB));
    fma4(acc, a.w, ld4(b + (k + 3) * LDB));
  }
}

}  // namespace fdc_fft
