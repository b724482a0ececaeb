// Pipelined fp32 GEMM whose A-tile loader gathers spectrum rows in place:
// the body of kernels A (extract_shared.cu) and E (extract_static.cu).
//
// Replaces, with extract_shared.cu and extract_static.cu, the Pallas
// kernels fdc_tpu/ops/extract_pallas.py _kernel_shared_measured,
// _kernel_shared (with its fold_phase_r branch) and _kernel: on the TPU
// one matrix-unit product per bucket; here an FFMA GEMM (no TF32: it
// would cost ~40 dB of output SNR).
//
// What it computes, out[z] = A @ B_grp over the k range of split z:
//
//   gather mode:  A[g, kk] = spec_f[(r * N + starts[c]) * 2 + kk],
//                 g = c * R + r (C slices stacked along M), kk a float of
//                 the slice's interleaved (re, im) pairs
//   power mode:   A[r, kb] = |spec[r, kb]|^2, kb a bin of the spectrum
//
// and B_grp [K, ldb] row-major (its first nout columns). The M rows fall
// into groups of mg rows, group grp multiplied by its own matrix at
// b + grp * b_group: kernel A has one group (one matrix for the bucket),
// kernel E one a channel (mg = R, a matrix each). A row tile never
// straddles two groups; grid z walks group x k split. The gathered
// operand never exists in device memory.
//
// What bounds it on the H100: fp32 FFMA at 67 TFLOP/s against 3.35 TB/s;
// the example's measured bucket ([512, 2048] x [2048, 1536] and [512,
// 1938] x [1938, 54], the measures over the bins their columns cover;
// 3.33 GFLOP over 26 MB) is 49.7 us of FFMA against 8 us of bytes. So the design is about FFMA issue: each thread owns an
// 8 x 8 micro-tile (rows ty*4 + i and BM/2 + ty*4 + i, columns tx*4 + j
// and BN/2 + tx*4 + j, i, j < 4) and reads, per two k, eight float2 of A
// and four float4 of B from shared memory for 128 FFMAs (4 FFMAs per
// shared-memory word). The A tile is stored k-major (a row's k run
// contiguous) as the spectrum holds it, so a STAGES-deep cp.async ring
// copies it straight from device memory: a slice row starts at byte
// (r * N + s_c) * 8, 16 B aligned only for an even s_c, so even rows take
// 16 B copies and odd rows two 8 B copies (one complex64 each); B takes
// 16 B copies when its row length allows. The tile (BM, BN) and any k
// split are the wrapper's (ops/extract_fused.py gemm_plan for kernel A,
// static_plan for E). Rows past the group, columns past nout and k past
// the split's range are zero-filled in shared memory (cp.async's source
// size), so the loop has no masks.
//
// For one split the sum over k runs in order, k = 0, 1, ..., K - 1, one
// fmaf each, whatever the tile: kernels A and E agree bit for bit on the
// same operands and the same k ranges. A k split writes its partial sums
// at out + z * M * nout; sum_splits (below) adds them in split order (no
// atomics).
//
// XR (gather mode): a group's last row tile may also compute the up to XR
// rows past its last whole tile (tail = mg % BM, R = 513 = 4 * 128 + 1
// for kernel E), so no CTA runs a whole tile's FFMAs for one row. The
// tile's threads t < tail * BN each own one (row, column) of them and
// add its 16 products a stage after the micro-tiles, in k order, one
// fmaf each (the same sum as any other row's).
//
// FOLD_R (gather mode; 0 = off): the store epilogue rotates every output
// pair of row g = c * R + r by q = ((r % FOLD_R) * (starts[c] % FOLD_R))
// % FOLD_R * (4 / FOLD_R) quarter turns, the overlap-save phase when the
// global index of row 0 is a multiple of FOLD_R. Both floats of a pair
// sit in one thread, so the rotation is a select and a negation (exact),
// and it commutes exactly with the split sum.

#pragma once

#include <cuda_runtime.h>

#include "smem_optin.cuh"

namespace fdc_gather {

constexpr int BK = 16;     // k a stage
constexpr int STAGES = 3;  // the cp.async ring

struct Args {
  const float* spec;  // complex64 [rows, n] as float pairs
  int rows, n;
  const int* starts;  // gather mode: [c] slice starts (bins)
  const float* b;     // [groups, K, ldb]
  int ldb;
  size_t b_group;        // floats from one group's matrix to the next
  int m, nout;           // the output [m, nout] of one split
  int mg;                // rows a group (m with one group)
  int tail;              // rows the last row tile adds (0 ... XR)
  int k_begin, k_end;    // the k range (floats in gather mode, bins else)
  int k_chunk;           // k a split (a multiple of BK)
  int splits;            // k splits (grid z = groups * splits)
  float* out;            // [splits, m, nout]
};

template <int BM, int BN, bool POWER, int XR = 0>
struct Tile {
  static constexpr int NT = (BM / 8) * (BN / 8);
  static constexpr int AW = (POWER ? 2 * BK : BK) + 4;  // A row, floats
  static constexpr int BW = BN + 4;                     // B row, floats
  static constexpr int AR = BM + XR;                    // A rows a stage
  static constexpr int A_CHUNKS = AR * (AW - 4) / 4;    // 16 B a stage
  static constexpr int B_CHUNKS = BK * BN / 4;
  static constexpr int A_PER = (A_CHUNKS + NT - 1) / NT;
  static constexpr int B_PER = (B_CHUNKS + NT - 1) / NT;
  static constexpr int STAGE_FLOATS = AR * AW + BK * BW;
  static constexpr int SMEM = STAGES * STAGE_FLOATS * 4;  // bytes
  static constexpr int MIN_BLOCKS = NT >= 384 ? 1 : 384 / NT;
};

__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp8(float* dst, const float* src,
                                    int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the floats of [k, k + w) that lie below end, in bytes (0 ... 4 w)
__device__ __forceinline__ int valid_bytes(int k, int w, int end) {
  return max(0, min(w, end - k)) * 4;
}

// MIN_BLOCKS: the 8 x 8 body takes ~170 registers a thread (spilling
// under 128)
template <int BM, int BN, bool POWER, int FOLD_R, int XR = 0>
__global__ void __launch_bounds__(Tile<BM, BN, POWER, XR>::NT,
                                  Tile<BM, BN, POWER, XR>::MIN_BLOCKS)
    gather_gemm(const Args p) {
  using T = Tile<BM, BN, POWER, XR>;
  static_assert(FOLD_R == 0 || (!POWER && (FOLD_R == 2 || FOLD_R == 4)),
                "the quarter-turn fold is a gather-mode epilogue, R in "
                "{2, 4}");
  static_assert(XR == 0 || (!POWER && FOLD_R == 0 && XR * BN <= T::NT),
                "tail rows: gather mode without fold, a thread each");
  constexpr int NT = T::NT;
  constexpr int AW = T::AW;
  constexpr int BW = T::BW;
  constexpr int CPR = (AW - 4) / 4;  // A chunks a row
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int tx = tid % (BN / 8);
  const int ty = tid / (BN / 8);
  const int grp = blockIdx.z / p.splits;
  const int zs = blockIdx.z - grp * p.splits;
  const int gbase = grp * p.mg;          // the group's first row of M
  const int m0 = blockIdx.x * BM;        // the tile's first row in it
  const int n0 = blockIdx.y * BN;
  const float* bg = p.b + grp * p.b_group;
  // the group's tail rows, on its last row tile
  const int tail = blockIdx.x == gridDim.x - 1 ? p.tail : 0;
  const int kb0 = p.k_begin + zs * p.k_chunk;
  const int kb1 = min(p.k_end, kb0 + p.k_chunk);
  const int kt_n = (kb1 - kb0 + BK - 1) / BK;

  // this thread's A chunks: the row's source at k = 0 of the chunk, and
  // whether it is 16 B aligned (gather mode: an even start)
  const float* asrc[T::A_PER];
  bool a16[T::A_PER];
#pragma unroll
  for (int i = 0; i < T::A_PER; ++i) {
    const int ch = tid + i * NT;
    const int row = ch / CPR;
    // rows past the group: zero-filled
    const int g = gbase + min(m0 + row, p.mg - 1);
    const int kq = (ch % CPR) * 4;
    if (POWER) {
      asrc[i] = p.spec + static_cast<size_t>(g) * p.n * 2 + kq;
    } else {
      const int c = g / p.rows;
      const int r = g - c * p.rows;
      asrc[i] = p.spec + (static_cast<size_t>(r) * p.n + p.starts[c]) * 2 + kq;
    }
    a16[i] = (reinterpret_cast<size_t>(asrc[i]) & 15) == 0;
  }
  const bool b16 = (p.ldb & 3) == 0 &&
                   (reinterpret_cast<size_t>(bg) & 15) == 0;

  auto load = [&](int stage, int k0) {
    float* as = smem + stage * T::STAGE_FLOATS;
    float* bs = as + T::AR * AW;
#pragma unroll
    for (int i = 0; i < T::A_PER; ++i) {
      const int ch = tid + i * NT;
      if (T::A_CHUNKS % NT != 0 && ch >= T::A_CHUNKS) break;
      const int row = ch / CPR;
      const int kq = (ch % CPR) * 4;
      float* dst = as + row * AW + kq;
      const bool live = row < BM ? m0 + row < p.mg : row - BM < tail;
      // power mode: k counts bins, two to a chunk, at floats 2 k0 + kq
      const int bytes =
          !live ? 0
          : POWER ? 2 * valid_bytes(k0 + kq / 2, 2, kb1)
                  : valid_bytes(k0 + kq, 4, kb1);
      const float* src = asrc[i] + (POWER ? 2 * k0 : k0);
      if (a16[i]) {
        cp16(dst, bytes ? src : p.spec, bytes);
      } else {  // one complex64 a copy
        const int lo = min(bytes, 8);
        cp8(dst, lo ? src : p.spec, lo);
        cp8(dst + 2, bytes > 8 ? src + 2 : p.spec, bytes - lo);
      }
    }
#pragma unroll
    for (int i = 0; i < T::B_PER; ++i) {
      const int ch = tid + i * NT;
      if (T::B_CHUNKS % NT != 0 && ch >= T::B_CHUNKS) break;
      const int kr = ch / (BN / 4);
      const int cq = (ch % (BN / 4)) * 4;
      float* dst = bs + kr * BW + cq;
      const int k = k0 + kr;
      const int n = n0 + cq;
      const int bytes = k < kb1 ? valid_bytes(n, 4, p.nout) : 0;
      const float* src = bg + static_cast<size_t>(k) * p.ldb + n;
      if (b16) {
        cp16(dst, bytes ? src : bg, bytes);
      } else {
        const int lo = min(bytes, 8);
        cp8(dst, lo ? src : bg, lo);
        cp8(dst + 2, bytes > 8 ? src + 2 : bg, bytes - lo);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  // a tail row's (row, column): thread tid < tail * BN
  const int xr = tid / BN;
  const int xc = tid - xr * BN;
  const bool xmine = XR > 0 && xr < tail;
  float xacc = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) load(s, kb0 + s * BK);
    cp_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free
    {
      const int nk = kt + STAGES - 1;
      if (nk < kt_n) load(nk % STAGES, kb0 + nk * BK);
      cp_commit();
    }
    const float* as = smem + (kt % STAGES) * T::STAGE_FLOATS;
    const float* bs = as + T::AR * AW;
#pragma unroll
    for (int kp = 0; kp < BK / 2; ++kp) {
      float2 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = (i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3);
        if (POWER) {
          const float4 z =
              *reinterpret_cast<const float4*>(as + row * AW + 4 * kp);
          a[i] = make_float2(z.x * z.x + z.y * z.y, z.z * z.z + z.w * z.w);
        } else {
          a[i] = *reinterpret_cast<const float2*>(as + row * AW + 2 * kp);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* brow = bs + (2 * kp + h) * BW;
        const float4 b0 = *reinterpret_cast<const float4*>(brow + tx * 4);
        const float4 b1 =
            *reinterpret_cast<const float4*>(brow + BN / 2 + tx * 4);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = h ? a[i].y : a[i].x;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
    if (XR > 0 && xmine) {
      const float* xa = as + (BM + xr) * AW;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk)
        xacc = fmaf(xa[kk], bs[kk * BW + xc], xacc);
    }
  }

  float* o = p.out + static_cast<size_t>(zs) * p.m * p.nout;
  if (XR > 0 && xmine && n0 + xc < p.nout)
    o[static_cast<size_t>(gbase + m0 + BM + xr) * p.nout + n0 + xc] = xacc;
  const bool o16 = (p.nout & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lr = m0 + (i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3);
    if (lr >= p.mg) continue;
    const int g = gbase + lr;
    if constexpr (FOLD_R > 1) {
      const int c = g / p.rows;
      const int r = g - c * p.rows;
      const int q =
          ((r % FOLD_R) * (p.starts[c] % FOLD_R)) % FOLD_R * (4 / FOLD_R);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const float re = acc[i][j], im = acc[i][j + 1];
        // (re, im) times i^q: (re, im), (-im, re), (-re, -im), (im, -re)
        acc[i][j] = q == 0 ? re : q == 1 ? -im : q == 2 ? -re : im;
        acc[i][j + 1] = q == 0 ? im : q == 1 ? re : q == 2 ? -im : -re;
      }
    }
    float* orow = o + static_cast<size_t>(g) * p.nout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * (BN / 2) + tx * 4;
      if (o16 && n + 4 <= p.nout) {
        *reinterpret_cast<float4*>(orow + n) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < p.nout) orow[n + j] = acc[i][4 * h + j];
      }
    }
  }
}

// Launch gather_gemm on `groups` groups of a.mg rows: a.mg / BM row tiles
// a group when its last one takes the a.tail rows past them, else
// ceil(a.mg / BM); a.splits k ranges each.
template <int BM, int BN, bool POWER, int FOLD_R, int XR = 0>
int launch(const Args& a, int groups, cudaStream_t st) {
  using T = Tile<BM, BN, POWER, XR>;
  auto* kern = gather_gemm<BM, BN, POWER, FOLD_R, XR>;
  static bool done[64] = {};
  const cudaError_t err = allow_smem(kern, T::SMEM, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.tail < 0 || a.tail > XR || (a.tail > 0 && a.mg % BM != a.tail))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = a.tail > 0 ? a.mg / BM : (a.mg + BM - 1) / BM;
  dim3 grid(tiles, (a.nout + BN - 1) / BN, groups * a.splits);
  kern<<<grid, T::NT, T::SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The split sums, in split order (no atomics): blockIdx.y = 0 the
// extraction's (ext_splits > 1, ext_len floats a split), 1 kernel A's
// measures' (into [rows, cm], columns from cu on zero).
static __global__ void sum_splits(const float* __restrict__ ext_part,
                                  int ext_splits, int ext_len,
                                  float* __restrict__ ext_out,
                                  const float* __restrict__ m_part,
                                  int m_splits, int rows, int cu, int cm,
                                  float* __restrict__ powers) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.y == 0) {
    if (ext_splits < 2 || i >= ext_len) return;
    float s = 0.0f;
    for (int z = 0; z < ext_splits; ++z)
      s += ext_part[static_cast<size_t>(z) * ext_len + i];
    ext_out[i] = s;
    return;
  }
  if (powers == nullptr || i >= rows * cm) return;
  const int r = i / cm;
  const int c = i - r * cm;
  float s = 0.0f;
  if (c < cu)
    for (int z = 0; z < m_splits; ++z)
      s += m_part[(static_cast<size_t>(z) * rows + r) * cu + c];
  powers[i] = s;
}

}  // namespace fdc_gather
