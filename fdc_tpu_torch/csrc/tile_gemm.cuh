// Register-tiled fp32 GEMM whose A-tile loader gathers spectrum rows in
// place, shared by the bucket-extraction kernels (extract_shared.cu,
// extract_static.cu).
//
// out = A @ B with A gathered from the complex64 spectrum read as raw
// float pairs, so no gathered operand ever exists in device memory:
//
//   MODE 0: A[g, kk] = spec_f[(r * N + starts[c]) * 2 + kk], g = c * R + r
//           (C slices stacked along M, one B for all); blockIdx.z = k split
//   MODE 1: A[r, kk] = |spec[r, kk]|^2; blockIdx.z = k split, each split
//           writing its partial sums at out + z * M * Nout
//   MODE 2: A[r, kk] = spec_f[(r * N + starts[z]) * 2 + kk] with channel
//           z = blockIdx.z; B += z * K * Nout (its own matrix), out +=
//           z * M * Nout
//
// 64x64 output tiles, BK=16 k-steps staged in shared memory, a 4x4
// micro-tile per thread (256 threads); rows past M and columns past Nout
// are masked. fp32 FFMA throughout (no TF32: ~40 dB of output SNR).

#pragma once

#include <cuda_runtime.h>

namespace fdc_gemm {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;

template <int MODE>
__global__ void __launch_bounds__(NT) tile_gemm(
    const float* __restrict__ spec, int R, int N,
    const int* __restrict__ starts,
    const float* __restrict__ B, int K, int Nout, int M, int k_chunk,
    float* __restrict__ out) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kbeg = MODE == 2 ? 0 : blockIdx.z * k_chunk;
  const int kend = MODE == 2 ? K : min(K, kbeg + k_chunk);
  if (MODE == 2) B += static_cast<size_t>(blockIdx.z) * K * Nout;

  // the 4 A rows this thread stages (rows ty + 16 i of the tile)
  const float* arow[4];
  bool aok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = m0 + ty + 16 * i;
    aok[i] = g < M;
    if (MODE == 0) {
      const int c = aok[i] ? g / R : 0;
      const int r = aok[i] ? g - c * R : 0;
      arow[i] = spec + (static_cast<size_t>(r) * N + starts[c]) * 2;
    } else if (MODE == 1) {
      arow[i] = spec + static_cast<size_t>(aok[i] ? g : 0) * N * 2;
    } else {
      arow[i] = spec +
                (static_cast<size_t>(aok[i] ? g : 0) * N + starts[blockIdx.z]) *
                    2;
    }
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
      if (aok[i] && kk < kend) {
        if (MODE == 1) {
          const float2 z = reinterpret_cast<const float2*>(arow[i])[kk];
          v = z.x * z.x + z.y * z.y;
        } else {
          v = arow[i][kk];
        }
      }
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
