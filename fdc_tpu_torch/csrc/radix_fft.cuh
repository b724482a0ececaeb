// Complex float2 arithmetic and the in-register radix DFTs of kernel F
// (forward_fft.cu) and its two-pass form (forward_fft_2pass.cu). fp32
// FFMA only; the radix butterflies use float32 constants of W_16^k (no
// __sincosf).

#pragma once

#include <cuda_runtime.h>

namespace radix {

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// W_16^k = e^{-2 pi i k / 16}, k < 8, as float32 constants
__device__ __forceinline__ float2 w16(int k) {
  constexpr float c1 = 0.92387953251128674f;
  constexpr float s1 = 0.38268343236508978f;
  constexpr float h = 0.70710678118654752f;
  switch (k) {
    case 1: return make_float2(c1, -s1);
    case 2: return make_float2(h, -h);
    case 3: return make_float2(s1, -c1);
    case 5: return make_float2(-s1, -c1);
    case 6: return make_float2(-h, -h);
    default: return make_float2(-c1, -s1);  // k = 7
  }
}

// t * W_R^k, R in {8, 16}, k < R / 2: exact for k = 0 and the quarter turn
template <int R>
__device__ __forceinline__ float2 rot(float2 t, int k) {
  if (k == 0) return t;
  if (2 * k == R / 2) return make_float2(t.y, -t.x);  // times -i
  return cmul(t, w16(k * (16 / R)));
}

// in-register DFT of R values, natural order in and out
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R == 2) {
    const float2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  } else if constexpr (R == 4) {
    const float2 s02 = cadd(v[0], v[2]), d02 = csub(v[0], v[2]);
    const float2 s13 = cadd(v[1], v[3]), d13 = csub(v[1], v[3]);
    v[0] = cadd(s02, s13);
    v[2] = csub(s02, s13);
    v[1] = make_float2(d02.x + d13.y, d02.y - d13.x);  // d02 - i d13
    v[3] = make_float2(d02.x - d13.y, d02.y + d13.x);  // d02 + i d13
  } else {
    // radix 2 over two half-length DFTs (even and odd samples)
    constexpr int H = R / 2;
    float2 e[H], o[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      e[i] = v[2 * i];
      o[i] = v[2 * i + 1];
    }
    dft<H>(e);
    dft<H>(o);
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float2 t = rot<R>(o[k], k);
      v[k] = cadd(e[k], t);
      v[k + H] = csub(e[k], t);
    }
  }
}

}  // namespace radix
