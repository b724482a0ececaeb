// The forward FFT (kernel F): the front end of every path.
//
// Replaces the Pallas kernels of the fused four-step forward FFT,
// kernel_w1 / kernel_w2 of tools/pallas_fft_proto.py (call :130) and
// kernel of tools/pallas_fft_proto2.py (call :133). All three compute
// fdc_tpu.ops.fft.forward_spectrum_mxu, the JAX package's forward FFT on
// every configuration (use_mxu_fft, on by default): per block of N
// complex64 samples, the DFT, fftshifted (DC at bin N/2) and scaled by
// 1/N. The TPU computes it as two dense DFT products because the TPU has
// a matrix unit; the H100 has no such reason, so F computes it as an FFT.
//
// What bounds it on the H100: at B = 512 blocks of N = 4096 the function
// moves 33.5 MB (16.8 MB in, 16.8 MB out), 10.0 us at 3.35 TB/s, and an
// FFT's 5 N log2 N operations are 0.13 GFLOP, 2 us at 67 TFLOP/s fp32:
// bound by bytes. (The two dense DFT products of the TPU's form carry
// 8 N (m1 + m2) = 2.15 GFLOP, 32 us of FFMA: above the bound by their
// arithmetic alone.)
//
// What the design does about it: one CTA per block, N / V threads, each
// holding V values in registers, and one shared buffer of N complex
// values, padded by one value in 16 against bank conflicts (34 KB at N =
// 4096). The Stockham (self-sorting) radix passes of RADIX_PLANS
// (ops/fft.py, the same schedule) exchange data through it: pass p of
// radix R over stride Ns (the product of the earlier radices) takes, for
// butterfly j,
//
//   v[r]  = buf[j + r N / R] * W_N^(r (j % Ns) N / (Ns R))   r < R
//   v     = DFT_R(v)                                 in registers
//   buf[(j / Ns) Ns R + j % Ns + r Ns] = v[r]
//
// with a barrier between a pass's reads and its writes, so one buffer
// serves every pass and there is no bit reversal. The first pass (Ns = 1,
// no twiddles) reads its values straight from device memory, each warp
// 256 contiguous bytes a load, so the block is read once and never staged
// in shared memory. The twiddles come from
// one float32 table of W_N^k, made in float64 and rounded once (ops/fft.py
// _radix_twiddles); the radix butterflies use float32 constants of W_16^k
// (no __sincosf). The last pass writes straight to device memory: output
// o goes to spec[(o + N/2) mod N] (the fftshift as an index remap) times
// 1/N (a power of two): both exact, and each warp writes 256 contiguous
// bytes. The output may be rows of a larger tensor (the channelizer
// passes rows 1..B of its extended spectrum). At N = 4096: 256 threads,
// three radix-16 passes, at least two CTAs an SM, so that one block's
// loads overlap another's butterflies. fp32 FFMA only. N from 256 to
// 16384; 8192 and 16384 take 512 threads a CTA.

#include <cuda_runtime.h>

#include "radix_fft.cuh"
#include "smem_optin.cuh"

namespace {

using namespace radix;

// the padded shared-memory index of value i: one pad in 16
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// Stockham pass of radix R over stride NS > 1 (the first pass is
// first_pass's), then the remaining passes; the last pass stores the
// shifted, scaled spectrum
template <int N, int V, int NS, int R, int... REST>
__device__ __forceinline__ void passes(float2* buf,
                                       const float2* __restrict__ tw,
                                       float2* __restrict__ dst, int tid) {
  constexpr int T = N / V;   // threads
  constexpr int NB = V / R;  // butterflies a thread
  constexpr int L = N / R;   // butterflies, and the stride of their inputs
  static_assert(NB * R == V && T * NB == L && NS > 1, "radix plan");
  float2 v[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = tid + b * T;
    const int k = j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) v[b][r] = buf[pad(j + r * L)];
#pragma unroll
    for (int r = 1; r < R; ++r)
      v[b][r] = cmul(v[b][r], __ldg(&tw[r * k * (N / (NS * R))]));
    dft<R>(v[b]);
  }
  if constexpr (sizeof...(REST) == 0) {
    static_assert(NS * R == N, "radix plan");
    constexpr float kScale = 1.0f / N;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int j = tid + b * T;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int o = j + r * L;  // natural order
        dst[(o + N / 2) & (N - 1)] =
            make_float2(v[b][r].x * kScale, v[b][r].y * kScale);
      }
    }
  } else {
    __syncthreads();  // every read of this pass is done
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int j = tid + b * T;
      const int d = (j / NS) * NS * R + j % NS;
#pragma unroll
      for (int r = 0; r < R; ++r) buf[pad(d + r * NS)] = v[b][r];
    }
    __syncthreads();
    passes<N, V, NS * R, REST...>(buf, tw, dst, tid);
  }
}

// the first pass (stride 1, no twiddles), its values read from the block
// in device memory (no barrier before its writes: nothing has read the
// buffer yet), then the remaining passes
template <int N, int V, int R, int... REST>
__device__ __forceinline__ void first_pass(const float2* __restrict__ src,
                                           float2* buf,
                                           const float2* __restrict__ tw,
                                           float2* __restrict__ dst, int tid) {
  constexpr int T = N / V;
  constexpr int NB = V / R;
  constexpr int L = N / R;
  float2 v[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int r = 0; r < R; ++r) v[b][r] = __ldg(&src[tid + b * T + r * L]);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    dft<R>(v[b]);
    const int j = tid + b * T;
#pragma unroll
    for (int r = 0; r < R; ++r) buf[pad(j * R + r)] = v[b][r];
  }
  __syncthreads();
  passes<N, V, R, REST...>(buf, tw, dst, tid);
}

template <int N, int V, int... RS>
__global__ void __launch_bounds__(N / V, (N / V <= 256 ? 2 : 1))
    radix_fft(const float2* __restrict__ x, const float2* __restrict__ tw,
              float2* __restrict__ out) {
  extern __shared__ float2 buf[];
  const size_t row = static_cast<size_t>(blockIdx.x) * N;
  first_pass<N, V, RS...>(x + row, buf, tw, out + row, threadIdx.x);
}

template <int N, int V, int... RS>
int launch(const void* x, int batch, const void* tw, void* out,
           cudaStream_t st) {
  constexpr size_t bytes = (N + N / 16) * sizeof(float2);
  auto* kern = radix_fft<N, V, RS...>;
  static bool done[64] = {};
  const cudaError_t err = allow_smem(kern, static_cast<int>(bytes), done);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<batch, N / V, bytes, st>>>(static_cast<const float2*>(x),
                                   static_cast<const float2*>(tw),
                                   static_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: complex64 [batch, n], contiguous; tw: complex64 [n], W_n^k; out:
// complex64 rows of n values, row b at out + b * n. n a power of two in
// [256, 16384]. The (values a thread, radices) of each n are
// ops/fft.py's RADIX_PLANS.
extern "C" int fdc_forward_fft(const void* x, int batch, int n,
                               const void* tw, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 256:
      return launch<256, 8, 8, 8, 4>(x, batch, tw, out, st);
    case 512:
      return launch<512, 8, 8, 8, 8>(x, batch, tw, out, st);
    case 1024:
      return launch<1024, 16, 16, 16, 4>(x, batch, tw, out, st);
    case 2048:
      return launch<2048, 16, 16, 16, 8>(x, batch, tw, out, st);
    case 4096:
      return launch<4096, 16, 16, 16, 16>(x, batch, tw, out, st);
    case 8192:
      return launch<8192, 16, 16, 16, 16, 2>(x, batch, tw, out, st);
    case 16384:
      return launch<16384, 32, 16, 16, 16, 4>(x, batch, tw, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
