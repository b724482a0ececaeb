// The four-step FFT's tile probes (kernel P).
//
// Replaces the Pallas lowering probes of the fused four-step FFT:
// m1, m2, m2p, m2f, m3, m4, m5, m6 of tools/pallas_fft_micro.py:39-90
// (call :119) and p1-p6, p4c, p4d of tools/pallas_fft_micro2.py:44-92
// (call :135). Each probe computes one piece of the fused FFT on its own
// shapes (m = 64, tb = 8 blocks):
//
//   m1          x [tb, 4096] reshaped to [tb, 64, 64] and back, times 2
//   m2 m2p m3 m4 m5   each block's [64, 64] view @ f [64, 64]
//   m2f         x [64, 64] @ f [64, 64]
//   m6          each block's [32, 128] view @ f [128, 128]
//   p1          x^T @ f (a transposed contraction)
//   p2          rows 0, 2, .., 62 then 1, 3, .., 63 of x [64, 64]
//   p3          halves: x [32, 128]'s lane halves stacked -> [64, 64]
//   p4          per block of x [tb * 32, 128]: halves, S = X^T @ f,
//               S *= t, X' = g @ S, rows 2p and 2p + 1 side by side
//   p4c         p4 without the twiddle and the second product
//   p4d         p4 on block 0 alone (the other rows stay zero)
//   p5          rows 2p and 2p + 1 of x [64, 64] side by side -> [32, 128]
//   p6          rows p and 32 + p side by side -> [32, 128]
//
// No path of either package runs a probe; chip_smoke.py holds each
// against its plain version (ops/probes.py).
//
// What bounds it. Not the work: the largest probe, p4, is 8.4 MFLOP
// (0.13 us of FFMA at 67 TFLOP/s) and 0.26 MB (0.08 us at 3.35 TB/s). The
// time is latency. The first design spent it in series: one CTA of 256
// threads a block of input (8 CTAs on 132 SMs, 1 for m2f, p1 and p4d),
// and every step of a runtime-bound k loop read the next row of the
// constant matrix from L2 (64 or 128 dependent ~250-cycle trips a
// product), so a product probe took 3-4x torch.matmul.
//
// This design pays one trip to memory and spreads the chain:
// - every operand a CTA reads (its rows of x, its columns of f, g, t) is
//   staged in shared memory at entry by 16-byte cp.async copies, with
//   one wait; the products then read shared memory only, k a
//   compile-time constant, unrolled, B's rows as float4;
// - each output is cut into slices of [16, 32] (products) or a block's
//   [64, 8] columns (the p4 pipelines), one CTA a slice: the m2 class and
//   m6 run 64 CTAs, m2f and p1 8, p4 and p4c 64, p4d 8. A CTA stages only
//   the columns of f it reads (m6: f [128, 32], 16 KB, no opt-in). The
//   p4 pipelines need no exchange between CTAs: the twiddle is
//   elementwise and g is the left operand, so columns J of X' = g @ (S *
//   t) need only columns J of S = X^T @ f, i.e. of f and t; each CTA
//   stages its block's X and all of g (40 KB);
// - the copy probes (m1, p2, p3, p5, p6) are permutations: one float4 a
//   thread from device memory to device memory, indices by shifts and
//   masks, 64 CTAs for m1 and 8 for the others; p4d's CTAs write its
//   zero rows too (no memset launch).
// No tensor cores: the probes are fp32, ROADMAP.md "Numerics" rules out
// TF32, 3xTF32 would need its own parity pass, and the arithmetic is
// not the bound. ops/probes.py's _PROBE table holds each probe's grid;
// tests/test_torch_probe_schedule.py models every slice in numpy (each
// output written once, the staged bytes, the shared-memory banks).

#include <cuda_runtime.h>

#include "fft_tiles.cuh"

namespace {

using fdc_fft::dot_row;
using fdc_fft::ld4;

constexpr int kM = 64, kN = 4096, kTb = 8;
constexpr int kCopyThreads = 128;  // a float4 a thread
constexpr int kPad = 4;  // a row pad: rows 16-byte aligned, 4 banks apart

// the op index: the order of ops/probes.py's _PROBE table
enum Op {
  kM1 = 0, kM2, kM2p, kM2f, kM3, kM5, kM6, kM4,
  kP1, kP2, kP3, kP4, kP4c, kP4d, kP5, kP6, kOps
};

// The copy probes: output float4 e from input float4 src(e) (row widths
// 64 = 16 float4 and 128 = 32 float4).
template <int OP>
__device__ __forceinline__ int copy_src(int e) {
  if constexpr (OP == kP2) {  // out [64, 64] row r: x row 2 (r % 32) + r / 32
    const int r = e >> 4;
    return ((((r & 31) << 1) | (r >> 5)) << 4) | (e & 15);
  }
  if constexpr (OP == kP3) {  // out row r: x [32, 128] row r % 32, half r / 32
    const int r = e >> 4;
    return ((r & 31) << 5) | ((r >> 5) << 4) | (e & 15);
  }
  if constexpr (OP == kP6) {  // out [32, 128] row p: x rows p and 32 + p
    const int p = e >> 5, q = e & 31;
    return ((((q >> 4) << 5) | p) << 4) | (q & 15);
  }
  return e;  // m1, and p5: [64, 64] -> [32, 128] is the same memory
}

template <int OP>
__global__ void __launch_bounds__(kCopyThreads)
    copy_probe(const float4* __restrict__ x, float4* __restrict__ out) {
  const int e = blockIdx.x * kCopyThreads + threadIdx.x;
  float4 v = __ldg(x + copy_src<OP>(e));
  if constexpr (OP == kM1) {
    v.x *= 2.0f;
    v.y *= 2.0f;
    v.z *= 2.0f;
    v.w *= 2.0f;
  }
  out[e] = v;
}

// out [M, K] = A @ f, f [K, K]; A = x [M, K], or x^T for x [K, M] when
// TA. A CTA a [BM, BN] slice of out (blockIdx.x = row slice * (K / BN)
// + column slice), a thread a row and four columns of it.
template <int M, int K, int BM, int BN, bool TA>
__global__ void __launch_bounds__(BM * BN / 4)
    product_probe(const float* __restrict__ x, const float* __restrict__ f,
                  float* __restrict__ out) {
  constexpr int kNt = BM * BN / 4, kGroups = BN / 4;
  constexpr int kLda = TA ? BM : K + kPad;
  __shared__ __align__(16) float as[TA ? K * BM : BM * kLda];
  __shared__ __align__(16) float bs[K * BN];
  const int m0 = blockIdx.x / (K / BN) * BM, n0 = blockIdx.x % (K / BN) * BN;
  if constexpr (TA)  // A's rows m0..: x's columns m0.., K rows of BM floats
    fdc_fft::stage_rows<K, BM, BM, kNt>(
        as, [&](int k) { return x + k * M + m0; });
  else
    fdc_fft::stage_rows<BM, K, kLda, kNt>(
        as, [&](int r) { return x + (m0 + r) * K; });
  fdc_fft::stage_rows<K, BN, BN, kNt>(
      bs, [&](int k) { return f + k * K + n0; });
  fdc_fft::cp_async_wait_all();
  __syncthreads();
  const int r = threadIdx.x / kGroups, c = 4 * (threadIdx.x % kGroups);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (TA)
    dot_row<K, BN>(acc, [&](int k) {
      return make_float4(as[k * BM + r], as[(k + 1) * BM + r],
                         as[(k + 2) * BM + r], as[(k + 3) * BM + r]);
    }, bs + c);
  else
    dot_row<K, BN>(acc, [&](int k) { return ld4(as + r * kLda + k); },
                   bs + c);
  *reinterpret_cast<float4*>(out + (m0 + r) * K + n0 + c) = acc;
}

// p4 (FULL), p4c (not FULL) and p4d (FULL, ZERO_REST): block b of x
// [tb * 32, 128], X = its lane halves stacked [64, 64]; S = X^T @ f, and
// when FULL X' = g @ (S * t); out's block (rows 2p, 2p + 1 side by side:
// the [64, 64] result's own memory). A CTA a block's columns
// J = j0 .. j0 + 7 (blockIdx.x = b * 8 + j0 / 8), a thread a row i and
// four columns. p4d runs block 0's 8 CTAs, which also zero blocks 1..7.
template <bool FULL, bool ZERO_REST>
__global__ void __launch_bounds__(kM * 8 / 4)
    pipeline_probe(const float* __restrict__ x, const float* __restrict__ f,
                   const float* __restrict__ g, const float* __restrict__ t,
                   float* __restrict__ out) {
  constexpr int kBn = 8, kNt = kM * kBn / 4, kGroups = kBn / 4;
  constexpr int kLdg = kM + kPad;
  __shared__ __align__(16) float xs[kM * kM];
  __shared__ __align__(16) float fs[kM * kBn];
  __shared__ __align__(16) float ts[FULL ? kM * kBn : 4];
  __shared__ __align__(16) float gs[FULL ? kM * kLdg : 4];
  __shared__ __align__(16) float ss[FULL ? kM * kBn : 4];
  const int b = blockIdx.x / (kM / kBn), j0 = blockIdx.x % (kM / kBn) * kBn;
  const float* blk = x + b * kN;
  fdc_fft::stage_rows<kM, kM, kM, kNt>(  // X row k: blk row k % 32, half k / 32
      xs, [&](int k) { return blk + (k & 31) * 2 * kM + (k >> 5) * kM; });
  fdc_fft::stage_rows<kM, kBn, kBn, kNt>(
      fs, [&](int k) { return f + k * kM + j0; });
  if constexpr (FULL) {
    fdc_fft::stage_rows<kM, kBn, kBn, kNt>(
        ts, [&](int k) { return t + k * kM + j0; });
    fdc_fft::stage_rows<kM, kM, kLdg, kNt>(
        gs, [&](int r) { return g + r * kM; });
  }
  if constexpr (ZERO_REST) {  // blocks 1..7 of out, a float4 a thread and step
    float4* rest = reinterpret_cast<float4*>(out + kN);
    const int e = blockIdx.x * kNt + threadIdx.x;
#pragma unroll
    for (int step = 0; step < kTb - 1; ++step)
      rest[step * (kN / 4) + e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  fdc_fft::cp_async_wait_all();
  __syncthreads();
  const int i = threadIdx.x / kGroups, c = 4 * (threadIdx.x % kGroups);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  dot_row<kM, kBn>(acc, [&](int k) {  // S(i, J) = sum_k X(k, i) f(k, J)
    return make_float4(xs[k * kM + i], xs[(k + 1) * kM + i],
                       xs[(k + 2) * kM + i], xs[(k + 3) * kM + i]);
  }, fs + c);
  if constexpr (FULL) {
    const float4 tw = ld4(ts + i * kBn + c);
    acc.x *= tw.x;
    acc.y *= tw.y;
    acc.z *= tw.z;
    acc.w *= tw.w;
    *reinterpret_cast<float4*>(ss + i * kBn + c) = acc;
    __syncthreads();
    acc = make_float4(0.f, 0.f, 0.f, 0.f);
    dot_row<kM, kBn>(acc, [&](int k) { return ld4(gs + i * kLdg + k); },
                     ss + c);  // X'(i, J) = sum_k g(i, k) S(k, J)
  }
  *reinterpret_cast<float4*>(out + b * kN + i * kM + j0 + c) = acc;
}

template <int OP>
void copy_launch(const float* x, float* out, int blocks, cudaStream_t s) {
  copy_probe<OP><<<blocks, kCopyThreads, 0, s>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out));
}

template <int M, int K, bool TA>
void product_launch(const float* x, const float* f, float* out, int blocks,
                    cudaStream_t s) {
  constexpr int kBm = 16, kBn = 32;
  product_probe<M, K, kBm, kBn, TA><<<blocks, kBm * kBn / 4, 0, s>>>(x, f,
                                                                     out);
}

template <bool FULL, bool ZERO_REST>
void pipeline_launch(const float* x, const float* f, const float* g,
                     const float* t, float* out, int blocks,
                     cudaStream_t s) {
  pipeline_probe<FULL, ZERO_REST><<<blocks, kM * 8 / 4, 0, s>>>(x, f, g, t,
                                                                out);
}

// each op's CTAs: the grid column of ops/probes.py's _PROBE table
constexpr int kGrid[kOps] = {
    kTb * kN / 4 / kCopyThreads,  // m1: 64
    64, 64, 8, 64, 64, 64, 64,    // m2 m2p m2f m3 m5 m6 m4: [16, 32] slices
    8,                            // p1
    8, 8,                         // p2 p3: kM * kM / 4 / kCopyThreads
    64, 64, 8,                    // p4 p4c (8 blocks x 8), p4d (block 0)
    8, 8,                         // p5 p6
};

}  // namespace

// op: the probe (see Op; the order of ops/probes.py PROBES); x, f, g, t:
// float32 inputs in the probe's shapes (f, g, t may be null when the op
// does not read them); blocks: CTAs, the probe's grid (kGrid; anything
// else is refused); out: float32 in the probe's output shape, every
// element written.
extern "C" int fdc_tile_probe(int op, const void* x, const void* f,
                              const void* g, const void* t, int blocks,
                              void* out, void* stream) {
  if (op < 0 || op >= kOps || blocks != kGrid[op])
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const float*>(x);
  const auto* fs = static_cast<const float*>(f);
  const auto* gs = static_cast<const float*>(g);
  const auto* ts = static_cast<const float*>(t);
  auto* o = static_cast<float*>(out);
  switch (op) {
    case kM1: copy_launch<kM1>(xs, o, blocks, s); break;
    case kP2: copy_launch<kP2>(xs, o, blocks, s); break;
    case kP3: copy_launch<kP3>(xs, o, blocks, s); break;
    case kP5: copy_launch<kP5>(xs, o, blocks, s); break;
    case kP6: copy_launch<kP6>(xs, o, blocks, s); break;
    case kM2f: product_launch<kM, kM, false>(xs, fs, o, blocks, s); break;
    case kM6:
      product_launch<kTb * 32, 2 * kM, false>(xs, fs, o, blocks, s);
      break;
    case kP1: product_launch<kM, kM, true>(xs, fs, o, blocks, s); break;
    case kP4:
      pipeline_launch<true, false>(xs, fs, gs, ts, o, blocks, s);
      break;
    case kP4c:
      pipeline_launch<false, false>(xs, fs, gs, ts, o, blocks, s);
      break;
    case kP4d:
      pipeline_launch<true, true>(xs, fs, gs, ts, o, blocks, s);
      break;
    default:  // m2, m2p, m3, m4, m5: [tb * 64, 64] @ [64, 64]
      product_launch<kTb * kM, kM, false>(xs, fs, o, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}
