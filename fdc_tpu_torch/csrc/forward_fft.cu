// The four-step forward FFT (kernel F): the front end of every path.
//
// Replaces the Pallas kernels of the fused four-step forward FFT,
// kernel_w1 / kernel_w2 of tools/pallas_fft_proto.py (call :130) and
// kernel of tools/pallas_fft_proto2.py (call :133). All three compute
// fdc_tpu.ops.fft.forward_spectrum_mxu, the JAX package's forward FFT on
// every configuration (use_mxu_fft, on by default); W1 stops before the
// transposed store, W2 and proto2 emit the spectrum itself, as F does.
//
// What it computes, per block of N = m1 * m2 complex64 samples (m1 =
// 2^ceil(log2 N / 2)), z[n1, n2] = x[n1 * m2 + n2]:
//
//   Y[k1, n2]  = sum_n1 W_m1^(k1 n1) z[n1, n2]                stage 1
//   Y'[k1, n2] = Y[k1, n2] * T[k1, n2],  T = W_N^(k1 n2)       twiddle
//   O[k1, k2]  = 1/N sum_n2 (-1)^n2 Y'[k1, n2] W_m2^(k2 n2)   stage 2
//   spec[k1 + m1 k2] = O[k1, k2]                              the store
//
// The (-1)^n2 signs are the output fftshift (k + N/2 rotates k2 by m2/2;
// m2 is even) and 1/N the reference's scale, as in the JAX package's E2.
// The DFT roots come from the same float32 tables the plain version
// multiplies by (ops/fft.py _four_step_tables): W1[a, b] is the root of
// index (a b) mod m1, read from W1's row 1; E2's row 1 is -W_m2^k / N, so
// its roots times -N are exact, and a sign or a power-of-two scale
// commutes with every rounding: the kernel differs from the plain
// version by the order of its sums only.
//
// What bounds it on the H100: at B = 512 blocks of N = 4096 the function
// moves 33.5 MB (16.8 MB in, 16.8 MB out), 10.0 us at 3.35 TB/s, and an
// FFT's 5 N log2 N operations are 0.13 GFLOP, 2 us at 67 TFLOP/s fp32:
// bound by bytes, 10.0 us. The DFT-as-product form this kernel computes
// carries 8 N (m1 + m2) = 2.15 GFLOP instead, 32 us of FFMA: this design
// cannot come within 3x of the bound, and radix butterflies (below) are
// what would close that gap.
//
// What the design does about it: one CTA per block. The block's N values
// sit in shared memory as planar re / im, rows padded by one float
// against bank conflicts (33 KB at N = 4096). Stage 1 is tile_dotT (the
// m2 column DFTs of length m1) against the m1 roots in shared memory,
// the twiddle is applied to the register tile, which goes back to shared
// memory transposed; stage 2 is tile_dotT again (row DFTs) with the shift
// signs, and the result is staged through shared memory transposed so
// that the global writes coalesce. Every thread owns a T x T register
// tile (T = 2 up to N = 1024, else 4), so all N outputs of a stage are
// held in registers across the barrier and one buffer serves all
// stages. fp32 FFMA only. N from 256 (16 x 16) to 16384 (128 x 128).
// Later work: radix butterflies in the 64-point stages, the framing fused
// into the load, and a store straight into spec_ext[1:].

#include <cuda_runtime.h>

#include "fft_tiles.cuh"

namespace {

using fdc_fft::cplx;
using fdc_fft::CplxTile;
using fdc_fft::TileMap;

template <int M1, int M2>
struct Shape {
  // one buffer for z [M1][M2 + 1], Y'^T [M2][M1 + 1] and O^T [M2][M1 + 1]
  static constexpr int kPlane =
      M1 * (M2 + 1) > M2 * (M1 + 1) ? M1 * (M2 + 1) : M2 * (M1 + 1);
  static constexpr int kFloats = 2 * kPlane + 2 * (M1 + M2);
};

template <int M1, int M2, int T>
__global__ void __launch_bounds__((M1 / T) * (M2 / T))
    forward_fft(const float2* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ tr, const float* __restrict__ ti,
                const float* __restrict__ e2, float2* __restrict__ out) {
  constexpr int N = M1 * M2;
  constexpr int NT = (M1 / T) * (M2 / T);
  using S = Shape<M1, M2>;
  extern __shared__ float smem[];
  float* re = smem;
  float* im = re + S::kPlane;
  float* r1re = im + S::kPlane;
  float* r1im = r1re + M1;
  float* r2re = r1im + M1;
  float* r2im = r2re + M2;
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * N;

  // the roots: W1's row 1, and E2's row 1 times -N (exact)
  for (int j = tid; j < M1; j += NT) {
    r1re[j] = w1[2 * M1 + j];
    r1im[j] = w1[(M1 + 1) * 2 * M1 + j];
  }
  for (int j = tid; j < M2; j += NT) {
    r2re[j] = -static_cast<float>(N) * e2[2 * M2 + j];
    r2im[j] = -static_cast<float>(N) * e2[2 * M2 + M2 + j];
  }
  const CplxTile z{re, im, M2 + 1};
  for (int i = tid; i < N; i += NT) {
    const float2 v = x[base + i];
    z.set(i / M2, i % M2, {v.x, v.y});
  }
  __syncthreads();

  // stage 1 as Y^T = z^T @ W1 (W1 is symmetric): rows n2, columns k1
  cplx acc[T][T];
  {
    const TileMap<T, T> m(tid, M2, M1);
    fdc_fft::zero(acc);
    fdc_fft::tile_dotT(
        acc, z,
        [&](int t, int k1) {
          const int j = (t * k1) & (M1 - 1);
          return cplx{r1re[j], r1im[j]};
        },
        M1, m);
    fdc_fft::twiddle(
        acc,
        [&](int n2, int k1) {
          return cplx{tr[k1 * M2 + n2], ti[k1 * M2 + n2]};
        },
        m);
    __syncthreads();
    fdc_fft::store<false>(acc, CplxTile{re, im, M1 + 1}, m);  // Y'^T
  }
  __syncthreads();

  // stage 2 as O = Y'^T^T @ E2: rows k1, columns k2
  {
    const CplxTile y{re, im, M1 + 1};
    const TileMap<T, T> m(tid, M1, M2);
    fdc_fft::zero(acc);
    fdc_fft::tile_dotT(
        acc, y,
        [&](int t, int k2) {
          const int j = (t * k2) & (M2 - 1);
          return (t & 1) ? cplx{-r2re[j], -r2im[j]} : cplx{r2re[j], r2im[j]};
        },
        M2, m);
    constexpr float kScale = 1.0f / N;
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int j = 0; j < T; ++j) {
        acc[i][j].re *= kScale;
        acc[i][j].im *= kScale;
      }
    __syncthreads();
    fdc_fft::store<true>(acc, CplxTile{re, im, M1 + 1}, m);  // O^T
  }
  __syncthreads();

  // spec[k1 + m1 k2] = O^T[k2][k1]: consecutive threads, consecutive k
  const CplxTile o{re, im, M1 + 1};
  for (int i = tid; i < N; i += NT) {
    const cplx v = o.get(i / M1, i % M1);
    out[base + i] = make_float2(v.re, v.im);
  }
}

template <int M1, int M2, int T>
int launch(const void* x, int batch, const void* w1, const void* tr,
           const void* ti, const void* e2, void* out, cudaStream_t st) {
  constexpr int NT = (M1 / T) * (M2 / T);
  constexpr size_t bytes = Shape<M1, M2>::kFloats * sizeof(float);
  auto* kern = forward_fft<M1, M2, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<batch, NT, bytes, st>>>(
      static_cast<const float2*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(tr), static_cast<const float*>(ti),
      static_cast<const float*>(e2), static_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: complex64 [batch, n]; w1 float32 [2 m1, 2 m1]; tr, ti float32
// [m1, m2]; e2 float32 [2 m2, 2 m2] (ops/fft.py _four_step_matrices);
// out: complex64 [batch, n]. n a power of two in [256, 16384].
extern "C" int fdc_forward_fft(const void* x, int batch, int n,
                               const void* w1, const void* tr, const void* ti,
                               const void* e2, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 256:
      return launch<16, 16, 2>(x, batch, w1, tr, ti, e2, out, st);
    case 512:
      return launch<32, 16, 2>(x, batch, w1, tr, ti, e2, out, st);
    case 1024:
      return launch<32, 32, 2>(x, batch, w1, tr, ti, e2, out, st);
    case 2048:
      return launch<64, 32, 4>(x, batch, w1, tr, ti, e2, out, st);
    case 4096:
      return launch<64, 64, 4>(x, batch, w1, tr, ti, e2, out, st);
    case 8192:
      return launch<128, 64, 4>(x, batch, w1, tr, ti, e2, out, st);
    case 16384:
      return launch<128, 128, 4>(x, batch, w1, tr, ti, e2, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
