// Shared-memory tile device functions of the four-step forward FFT
// (kernel F, forward_fft.cu) and its probes (kernel P, fft_probes.cu).
//
// A tile is a row-major matrix in shared memory, real (one plane) or
// complex (planar re / im planes with one leading dimension). A thread
// owns a TR x TC register tile of an R x C product: rows
// r0 + i * (R / TR), columns c0 + j * (C / TC), with r0 the fast index of
// the thread, so the lanes of a warp read neighbouring rows of the
// operand that is indexed by the output row. Every product is plain fp32
// FFMA (no TF32).
//
//   tile_dot   acc[i][j] += sum_t X(row_i, t) * W(t, col_j)   X @ W
//   tile_dotT  acc[i][j] += sum_t X(t, row_i) * W(t, col_j)   X^T @ W
//   twiddle    acc[i][j] *= T(row_i, col_j)                   elementwise
//   halves     dst(r, c) = src[r % H][(r / H) * W + c]         [H, 2W] -> [2H, W]
//   pack_even_odd  dst[p][h * W + c] = src(2p + h, c)         [2H, W] -> [H, 2W]
//
// X is a shared-memory tile, W and T are functors (a shared tile, a
// table of DFT roots, a matrix in device memory).

#pragma once

#include <cuda_runtime.h>

namespace fdc_fft {

struct cplx {
  float re, im;
};

__device__ __forceinline__ void mac(float& acc, float a, float b) {
  acc = fmaf(a, b, acc);
}

__device__ __forceinline__ void mac(cplx& acc, cplx a, cplx b) {
  acc.re = fmaf(a.re, b.re, acc.re);
  acc.re = fmaf(-a.im, b.im, acc.re);
  acc.im = fmaf(a.re, b.im, acc.im);
  acc.im = fmaf(a.im, b.re, acc.im);
}

__device__ __forceinline__ float mul(float a, float b) { return a * b; }

__device__ __forceinline__ cplx mul(cplx a, cplx b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// a real tile: element (r, c) at p[r * ld + c]
struct RealTile {
  float* p;
  int ld;
  __device__ __forceinline__ float get(int r, int c) const {
    return p[r * ld + c];
  }
  __device__ __forceinline__ void set(int r, int c, float v) const {
    p[r * ld + c] = v;
  }
};

// a complex tile in planar layout
struct CplxTile {
  float* re;
  float* im;
  int ld;
  __device__ __forceinline__ cplx get(int r, int c) const {
    return {re[r * ld + c], im[r * ld + c]};
  }
  __device__ __forceinline__ void set(int r, int c, cplx v) const {
    re[r * ld + c] = v.re;
    im[r * ld + c] = v.im;
  }
};

// The rows and columns a thread's register tile covers in an R x C
// output, for threads 0 .. (R / TR) * (C / TC) - 1.
template <int TR, int TC>
struct TileMap {
  int row[TR], col[TC];
  __device__ __forceinline__ TileMap(int tid, int r, int c) {
    const int rs = r / TR, cs = c / TC;
#pragma unroll
    for (int i = 0; i < TR; ++i) row[i] = tid % rs + i * rs;
#pragma unroll
    for (int j = 0; j < TC; ++j) col[j] = tid / rs + j * cs;
  }
};

template <typename T, int TR, int TC>
__device__ __forceinline__ void zero(T (&acc)[TR][TC]) {
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = T{};
}

template <typename T, int TR, int TC, typename Tile, typename WFn>
__device__ __forceinline__ void tile_dot(T (&acc)[TR][TC], const Tile& x,
                                         const WFn& w, int k,
                                         const TileMap<TR, TC>& m) {
  for (int t = 0; t < k; ++t) {
    T a[TR], b[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i) a[i] = x.get(m.row[i], t);
#pragma unroll
    for (int j = 0; j < TC; ++j) b[j] = w(t, m.col[j]);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) mac(acc[i][j], a[i], b[j]);
  }
}

template <typename T, int TR, int TC, typename Tile, typename WFn>
__device__ __forceinline__ void tile_dotT(T (&acc)[TR][TC], const Tile& x,
                                          const WFn& w, int k,
                                          const TileMap<TR, TC>& m) {
  for (int t = 0; t < k; ++t) {
    T a[TR], b[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i) a[i] = x.get(t, m.row[i]);
#pragma unroll
    for (int j = 0; j < TC; ++j) b[j] = w(t, m.col[j]);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) mac(acc[i][j], a[i], b[j]);
  }
}

template <typename T, int TR, int TC, typename TFn>
__device__ __forceinline__ void twiddle(T (&acc)[TR][TC], const TFn& tw,
                                        const TileMap<TR, TC>& m) {
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = mul(acc[i][j], tw(m.row[i], m.col[j]));
}

// store a register tile into a shared tile, transposed when T_OUT
template <bool T_OUT, typename T, int TR, int TC, typename Tile>
__device__ __forceinline__ void store(const T (&acc)[TR][TC], const Tile& y,
                                      const TileMap<TR, TC>& m) {
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      if (T_OUT)
        y.set(m.col[j], m.row[i], acc[i][j]);
      else
        y.set(m.row[i], m.col[j], acc[i][j]);
    }
}

// dst (a [2h, w] real tile) from src [h, 2w] (row stride lds): the two
// lane halves of every source row stacked as two row blocks
__device__ __forceinline__ void halves(const RealTile& dst, const float* src,
                                       int lds, int h, int w, int tid,
                                       int nt) {
  for (int e = tid; e < 2 * h * w; e += nt) {
    const int r = e / w, c = e % w;
    dst.set(r, c, src[(r % h) * lds + (r / h) * w + c]);
  }
}

// dst [h, 2w] (row stride ldd) from src (a [2h, w] real tile): rows 2p
// and 2p + 1 side by side in row p
__device__ __forceinline__ void pack_even_odd(float* dst, int ldd,
                                              const RealTile& src, int h,
                                              int w, int tid, int nt) {
  for (int e = tid; e < 2 * h * w; e += nt) {
    const int p = e / (2 * w), q = e % (2 * w);
    dst[p * ldd + q] = src.get(2 * p + q / w, q % w);
  }
}

}  // namespace fdc_fft
