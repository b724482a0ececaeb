// Register-tiled fp32 GEMM whose A-tile loader gathers spectrum rows in
// place: the body of kernel E (extract_static.cu).
//
// out[z] = A_z @ B_z for each channel z = blockIdx.z, with A gathered from
// the complex64 spectrum read as raw float pairs, so no gathered operand
// ever exists in device memory:
//
//   A_z[r, kk] = spec_f[(r * N + starts[z]) * 2 + kk]; B_z = B + z * K *
//   Nout (the channel's own matrix); out += z * M * Nout
//
// 64x64 output tiles, BK=16 k-steps staged in shared memory, a 4x4
// micro-tile per thread (256 threads); rows past M and columns past Nout
// are masked. fp32 FFMA throughout (no TF32: ~40 dB of output SNR). Each
// output sums its k terms in order, one fmaf each, as kernel A's
// gather_gemm.cuh does without a k split.

#pragma once

#include <cuda_runtime.h>

namespace fdc_gemm {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;

__global__ void __launch_bounds__(NT) tile_gemm(
    const float* __restrict__ spec, int R, int N,
    const int* __restrict__ starts,
    const float* __restrict__ B, int K, int Nout, int M,
    float* __restrict__ out) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kbeg = 0;
  const int kend = K;
  B += static_cast<size_t>(blockIdx.z) * K * Nout;

  // the 4 A rows this thread stages (rows ty + 16 i of the tile)
  const float* arow[4];
  bool aok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = m0 + ty + 16 * i;
    aok[i] = g < M;
    arow[i] = spec +
              (static_cast<size_t>(aok[i] ? g : 0) * N + starts[blockIdx.z]) *
                  2;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    const int kk = k0 + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.0f;
      if (aok[i] && kk < kend) v = arow[i][kk];
      As[tx][ty + 16 * i] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * NT;
      const int row = idx / BN;
      const int col = idx % BN;
      const int kb = k0 + row;
      const int n = n0 + col;
      Bs[row][col] =
          (kb < kend && n < Nout) ? B[static_cast<size_t>(kb) * Nout + n]
                                  : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* o = out + static_cast<size_t>(blockIdx.z) * M * Nout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = m0 + ty + 16 * i;
    if (g >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Nout) o[static_cast<size_t>(g) * Nout + n] = acc[i][j];
    }
  }
}

}  // namespace fdc_gemm
