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
// Every op composes kernel F's shared-memory tile functions
// (fft_tiles.cuh: tile_dot, tile_dotT, twiddle, halves, pack_even_odd):
// the operand tile in shared memory, the constant matrices read through
// the cache. No path of either package runs a probe; chip_smoke.py holds
// each against its plain version (ops/probes.py).
//
// What bounds it: nothing on the card; a probe is a few microseconds of
// work (the largest, p4, is 8 blocks x 2 products of 64^3: 8.4 MFLOP), so
// its time is the launch. One CTA of 256 threads per block (per op with
// one block of input: one CTA), 4 x 4 register tiles, fp32 FFMA.

#include <cuda_runtime.h>

#include "fft_tiles.cuh"

namespace {

using fdc_fft::RealTile;
using fdc_fft::TileMap;

constexpr int kM = 64, kN = 4096, kNT = 256, kLd = kM + 1;

// the op index: the order of ops/probes.py's _PROBE table
enum Op {
  kM1 = 0, kM2, kM2p, kM2f, kM3, kM5, kM6, kM4,
  kP1, kP2, kP3, kP4, kP4c, kP4d, kP5, kP6, kOps
};

// a [rows, cols] tile from src (row stride lds)
__device__ void load(const RealTile& dst, const float* src, int lds, int rows,
                     int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += kNT)
    dst.set(e / cols, e % cols, src[(e / cols) * lds + e % cols]);
}

// a [rows, cols] tile into dst (row stride ldd)
__device__ void save(float* dst, int ldd, const RealTile& src, int rows,
                     int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += kNT)
    dst[(e / cols) * ldd + e % cols] = src.get(e / cols, e % cols);
}

__device__ void save_acc(float* dst, int ldd, const float (&acc)[4][4],
                         const TileMap<4, 4>& m) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[m.row[i] * ldd + m.col[j]] = acc[i][j];
}

struct Global {
  const float* p;
  int ld;
  __device__ float operator()(int r, int c) const { return p[r * ld + c]; }
};

__global__ void __launch_bounds__(kNT)
    tile_probe(int op, const float* __restrict__ x,
               const float* __restrict__ f, const float* __restrict__ g,
               const float* __restrict__ t, float* __restrict__ out) {
  __shared__ float s0[kM * kLd], s1[kM * kLd];
  const int tid = threadIdx.x, b = blockIdx.x;
  const RealTile a{s0, kLd}, c{s1, kLd};
  float acc[4][4];
  switch (op) {
    case kM1:
      load(a, x + b * kN, kM, kM, kM);
      __syncthreads();
      for (int e = tid; e < kN; e += kNT)
        out[b * kN + e] = a.get(e / kM, e % kM) * 2.0f;
      return;
    case kM2:
    case kM2p:
    case kM2f:
    case kM3:
    case kM5:
    case kM4: {
      load(a, x + b * kN, kM, kM, kM);
      __syncthreads();
      const TileMap<4, 4> m(tid, kM, kM);
      fdc_fft::zero(acc);
      fdc_fft::tile_dot(acc, a, Global{f, kM}, kM, m);
      save_acc(out + b * kN, kM, acc, m);
      return;
    }
    case kM6: {
      const RealTile w{s0, 2 * kM + 1};
      load(w, x + b * kN, 2 * kM, kM / 2, 2 * kM);
      __syncthreads();
      const TileMap<4, 4> m(tid, kM / 2, 2 * kM);
      fdc_fft::zero(acc);
      fdc_fft::tile_dot(acc, w, Global{f, 2 * kM}, 2 * kM, m);
      save_acc(out + b * kN, 2 * kM, acc, m);
      return;
    }
    case kP1: {
      load(a, x, kM, kM, kM);
      __syncthreads();
      const TileMap<4, 4> m(tid, kM, kM);
      fdc_fft::zero(acc);
      fdc_fft::tile_dotT(acc, a, Global{f, kM}, kM, m);
      save_acc(out, kM, acc, m);
      return;
    }
    case kP2:
      load(a, x, kM, kM, kM);
      __syncthreads();
      for (int e = tid; e < kM * kM; e += kNT) {
        const int r = e / kM;
        out[e] = a.get(2 * (r % (kM / 2)) + r / (kM / 2), e % kM);
      }
      return;
    case kP3:
      fdc_fft::halves(a, x, 2 * kM, kM / 2, kM, tid, kNT);
      __syncthreads();
      save(out, kM, a, kM, kM);
      return;
    case kP4:
    case kP4c:
    case kP4d: {
      const float* blk = x + b * (kM / 2) * (2 * kM);
      fdc_fft::halves(a, blk, 2 * kM, kM / 2, kM, tid, kNT);
      if (op != kP4c) load(c, g, kM, kM, kM);
      __syncthreads();
      const TileMap<4, 4> m(tid, kM, kM);
      fdc_fft::zero(acc);
      fdc_fft::tile_dotT(acc, a, Global{f, kM}, kM, m);  // S = X^T @ f
      if (op != kP4c) {
        fdc_fft::twiddle(acc, Global{t, kM}, m);  // S *= t
        __syncthreads();
        fdc_fft::store<false>(acc, a, m);
        __syncthreads();
        fdc_fft::zero(acc);
        fdc_fft::tile_dot(  // X' = g @ S
            acc, c, [&](int k, int col) { return a.get(k, col); }, kM, m);
      }
      __syncthreads();
      fdc_fft::store<false>(acc, a, m);
      __syncthreads();
      fdc_fft::pack_even_odd(out + b * (kM / 2) * (2 * kM), 2 * kM, a, kM / 2,
                             kM, tid, kNT);
      return;
    }
    case kP5:
      load(a, x, kM, kM, kM);
      __syncthreads();
      fdc_fft::pack_even_odd(out, 2 * kM, a, kM / 2, kM, tid, kNT);
      return;
    case kP6:
      load(a, x, kM, kM, kM);
      __syncthreads();
      for (int e = tid; e < kM * kM; e += kNT) {
        const int p = e / (2 * kM), q = e % (2 * kM);
        out[e] = a.get((q / kM) * (kM / 2) + p, q % kM);
      }
      return;
  }
}

}  // namespace

// op: the probe (see Op; the order of ops/probes.py PROBES); x, f, g, t:
// float32 inputs in the probe's shapes (f, g, t may be null when the op
// does not read them); blocks: CTAs, one per block of input; out: float32
// in the probe's output shape.
extern "C" int fdc_tile_probe(int op, const void* x, const void* f,
                              const void* g, const void* t, int blocks,
                              void* out, void* stream) {
  if (op < 0 || op >= kOps || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  tile_probe<<<blocks, kNT, 0, static_cast<cudaStream_t>(stream)>>>(
      op, static_cast<const float*>(x), static_cast<const float*>(f),
      static_cast<const float*>(g), static_cast<const float*>(t),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
