// Kernel F's two-pass form: the forward FFT of blocks above 16384 points.
//
// The same function as kernel F (forward_fft.cu), which replaces the
// fused four-step forward FFT of tools/pallas_fft_proto.py (kernel_w1 /
// kernel_w2, call :130) and tools/pallas_fft_proto2.py (kernel, call
// :133), i.e. fdc_tpu.ops.fft.forward_spectrum_mxu: per block of N
// complex64 samples, the DFT, fftshifted (DC at bin N/2) and scaled by
// 1/N. Kernel F keeps a whole block in shared memory, so it stops at
// N = 16384; above that a block is split as the four-step form splits it
// (ops/fft.py _four_step_matrices): N = m1 m2, m1 = 2^ceil(log2 N / 2),
// n = n1 m2 + n2, k = k1 + m1 k2, and
//
//   X[k1 + m1 k2] = sum_n2 W_m2^(n2 k2) W_N^(n2 k1) sum_n1 x[n1 m2 + n2] W_m1^(n1 k1).
//
// Pass 1 (cols_pass): a CTA takes one block and a tile of TC adjacent
// columns n2, runs the m1-point FFTs over n1 in shared memory, multiplies
// by W_N^(k1 n2) (k1 n2 < N: no modulo) and writes Y[k1, n2] to a scratch
// block in the input's [m1, m2] layout. Pass 2 (rows_pass): a CTA takes
// TC adjacent rows k1 of Y (TC m2 contiguous values), runs the m2-point
// FFTs over n2 and writes out[(k1 + m1 k2 + N/2) mod N] / N
// = out[k1 + m1 ((k2 + m2/2) mod m2)] / N: the shift is a multiple of m1,
// so the TC rows of a tile write runs of TC adjacent values.
//
// Both passes run one Stockham body (column_passes): TC transforms of M
// points in shared memory, value i of transform g at buf[i P + g] with a
// pitch P = TC + 1 (one pad, so a thread walking i of one transform hits
// another bank each step), thread tid = (g, t) = (tid % TC, tid / TC), the
// radices of ops/fft.py's TWO_PASS_PLANS (kernel F's RADIX_PLANS plus 128
// points), the butterflies of radix_fft.cuh, the twiddles from float32
// tables of W_M^k and W_N^k made in float64 and rounded once
// (ops/fft.py _radix_twiddles). Every load and store to device memory
// moves runs of TC adjacent values (TC = 16 up to M = 1024: 128 bytes),
// with g the fastest index of the thread.
//
// What bounds it on the H100: each pass reads and writes the block once,
// 4 x 8 N bytes a block; at [512, 32768] 537 MB, 0.160 ms at 3.35 TB/s
// (the one-pass floor, 8 N in and 8 N out, is 0.080 ms); 5 N log2 N
// operations are 0.019 ms at 67 TFLOP/s fp32: bound by bytes. This design
// is right first: the scratch round trip doubles the bytes, and pass 1's
// 128-byte runs are the shortest that fill a sector line. fp32 FFMA only.
// m1 and m2 from 128 to 16384: N from 32768 to 2^28.

#include <cuda_runtime.h>

#include "radix_fft.cuh"
#include "smem_optin.cuh"

namespace {

using namespace radix;

// transforms a CTA: 16 while 16 M <= 16384, then as many as fit 16384
// values (shared memory stays <= 192 KB, threads <= 1024)
template <int M>
__host__ __device__ constexpr int tile() {
  return M <= 1024 ? 16 : 16384 / M;
}

// the shared pitch of one transform index
template <int TC>
__host__ __device__ constexpr int pitch() {
  return TC > 1 ? TC + 1 : 1;
}

template <int M, int V>
__host__ __device__ constexpr int threads() {
  return tile<M>() * M / V;
}

template <int M>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(M) * pitch<tile<M>()>() * sizeof(float2);
}

// Stockham pass of radix R over stride NS on TC transforms of M points in
// shared memory, then the remaining passes; the result is in natural
// order in buf (the self-sorting form: the last pass writes index j + r L)
template <int M, int V, int TC, int NS, int R, int... REST>
__device__ __forceinline__ void column_passes(float2* buf,
                                              const float2* __restrict__ tw,
                                              int g, int t) {
  constexpr int T = M / V;   // threads a transform
  constexpr int NB = V / R;  // butterflies a thread
  constexpr int L = M / R;   // butterflies, and the stride of their inputs
  constexpr int P = pitch<TC>();
  static_assert(NB * R == V && T * NB == L, "radix plan");
  float2 v[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = t + b * T;
    const int k = j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) v[b][r] = buf[(j + r * L) * P + g];
    if constexpr (NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[b][r] = cmul(v[b][r], __ldg(&tw[r * k * (M / (NS * R))]));
    }
    dft<R>(v[b]);
  }
  __syncthreads();  // every read of this pass is done
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = t + b * T;
    const int d = (j / NS) * NS * R + j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) buf[(d + r * NS) * P + g] = v[b][r];
  }
  __syncthreads();
  if constexpr (sizeof...(REST) > 0)
    column_passes<M, V, TC, NS * R, REST...>(buf, tw, g, t);
}

// pass 1: M = m1-point FFTs over n1 of TC columns, twiddled by W_N^(k1 n2)
template <int M, int V, int... RS>
__global__ void __launch_bounds__(threads<M, V>())
    cols_pass(const float2* __restrict__ x, const float2* __restrict__ tw1,
              const float2* __restrict__ twn, float2* __restrict__ y,
              int m2, int tiles) {
  constexpr int TC = tile<M>();
  constexpr int P = pitch<TC>();
  constexpr int NT = threads<M, V>();
  extern __shared__ float2 buf[];
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x / tiles) * M * m2;
  const int c0 = (blockIdx.x % tiles) * TC;  // first column n2
  // value n1 of column g: x[n1 m2 + c0 + g]
  for (int e = tid; e < TC * M; e += NT) {
    const int g = e % TC, i = e / TC;
    buf[i * P + g] = __ldg(&x[base + static_cast<size_t>(i) * m2 + c0 + g]);
  }
  __syncthreads();
  column_passes<M, V, TC, 1, RS...>(buf, tw1, tid % TC, tid / TC);
  for (int e = tid; e < TC * M; e += NT) {
    const int g = e % TC, k1 = e / TC, n2 = c0 + g;
    y[base + static_cast<size_t>(k1) * m2 + n2] =
        cmul(buf[k1 * P + g], __ldg(&twn[k1 * n2]));
  }
}

// pass 2: M = m2-point FFTs over n2 of TC rows, shifted and scaled
template <int M, int V, int... RS>
__global__ void __launch_bounds__(threads<M, V>())
    rows_pass(const float2* __restrict__ y, const float2* __restrict__ tw2,
              float2* __restrict__ out, int m1, int tiles, float scale) {
  constexpr int TC = tile<M>();
  constexpr int P = pitch<TC>();
  constexpr int NT = threads<M, V>();
  extern __shared__ float2 buf[];
  const int tid = threadIdx.x;
  const size_t n = static_cast<size_t>(m1) * M;
  const size_t base = static_cast<size_t>(blockIdx.x / tiles) * n;
  const int r0 = (blockIdx.x % tiles) * TC;  // first row k1
  // rows r0 .. r0 + TC - 1 are TC M contiguous values
  const float2* src = y + base + static_cast<size_t>(r0) * M;
  for (int e = tid; e < TC * M; e += NT) {
    const int g = e / M, i = e % M;
    buf[i * P + g] = src[e];
  }
  __syncthreads();
  column_passes<M, V, TC, 1, RS...>(buf, tw2, tid % TC, tid / TC);
  float2* dst = out + base;
  for (int e = tid; e < TC * M; e += NT) {
    const int g = e % TC, k2 = e / TC;
    const float2 v = buf[k2 * P + g];
    dst[static_cast<size_t>(r0 + g) +
        static_cast<size_t>(m1) * ((k2 + M / 2) & (M - 1))] =
        make_float2(v.x * scale, v.y * scale);
  }
}

template <int M, int V, int... RS>
int cols(const void* x, int batch, const void* tw1, const void* twn,
         void* y, int m2, cudaStream_t st) {
  auto* kern = cols_pass<M, V, RS...>;
  static bool done[64] = {};
  const cudaError_t err =
      allow_smem(kern, static_cast<int>(smem_bytes<M>()), done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = m2 / tile<M>();
  kern<<<batch * tiles, threads<M, V>(), smem_bytes<M>(), st>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(tw1),
      static_cast<const float2*>(twn), static_cast<float2*>(y), m2, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int M, int V, int... RS>
int rows(const void* y, int batch, const void* tw2, void* out, int m1,
         float scale, cudaStream_t st) {
  auto* kern = rows_pass<M, V, RS...>;
  static bool done[64] = {};
  const cudaError_t err =
      allow_smem(kern, static_cast<int>(smem_bytes<M>()), done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = m1 / tile<M>();
  kern<<<batch * tiles, threads<M, V>(), smem_bytes<M>(), st>>>(
      static_cast<const float2*>(y), static_cast<const float2*>(tw2),
      static_cast<float2*>(out), m1, tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

// the (values a thread, radices) of each M: ops/fft.py's TWO_PASS_PLANS
#define FDC_PLANS(X)                   \
  X(128, 8, 8, 4, 4)                   \
  X(256, 8, 8, 8, 4)                   \
  X(512, 8, 8, 8, 8)                   \
  X(1024, 16, 16, 16, 4)               \
  X(2048, 16, 16, 16, 8)               \
  X(4096, 16, 16, 16, 16)              \
  X(8192, 16, 16, 16, 16, 2)           \
  X(16384, 32, 16, 16, 16, 4)

int launch_cols(int m1, const void* x, int batch, const void* tw1,
                const void* twn, void* y, int m2, cudaStream_t st) {
  switch (m1) {
#define FDC_COLS(M, ...) \
  case M:                \
    return cols<M, __VA_ARGS__>(x, batch, tw1, twn, y, m2, st);
    FDC_PLANS(FDC_COLS)
#undef FDC_COLS
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_rows(int m2, const void* y, int batch, const void* tw2,
                void* out, int m1, float scale, cudaStream_t st) {
  switch (m2) {
#define FDC_ROWS(M, ...) \
  case M:                \
    return rows<M, __VA_ARGS__>(y, batch, tw2, out, m1, scale, st);
    FDC_PLANS(FDC_ROWS)
#undef FDC_ROWS
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: complex64 [batch, n], contiguous; n = m1 m2 a power of two with m1 =
// 2^ceil(log2 n / 2) and m1, m2 in [128, 16384]; tw1, tw2, twn: complex64
// [m1], [m2], [n], W_m^k; scratch: complex64 [batch, n], written by pass 1
// and read by pass 2; out: complex64 rows of n values, row b at
// out + b * n.
extern "C" int fdc_forward_fft_2pass(const void* x, int batch, int m1,
                                     int m2, const void* tw1,
                                     const void* tw2, const void* twn,
                                     void* scratch, void* out,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = launch_cols(m1, x, batch, tw1, twn, scratch, m2, st);
  if (rc != 0) return rc;
  const float scale = 1.0f / (static_cast<float>(m1) * static_cast<float>(m2));
  return launch_rows(m2, scratch, batch, tw2, out, m1, scale, st);
}
