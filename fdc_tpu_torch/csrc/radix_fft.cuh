// Complex float2 arithmetic and the in-register radix DFTs of kernel F
// (forward_fft.cu), and the Stockham passes of its large-N forms over
// transforms laid side by side in shared memory (forward_fft_2pass.cu,
// forward_fft_cluster.cu). fp32 FFMA only; the radix butterflies use
// float32 constants of W_16^k (no __sincosf).

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

// Stockham pass of radix R over stride NS on transforms of M points, then
// the remaining passes; value i of transform g at buf[i P + g] in shared
// memory (P: the pitch of one index), thread (g, t) of M / V a transform;
// the twiddles from a float32 table of W_M^k. The result is in natural
// order (the self-sorting form: the last pass writes index j + r L). With
// LOAD the first pass reads value i from ld(i) instead of buf, with STORE
// the last one writes it through st(i, v) (both the thread's own
// transform): neither then needs a barrier between its reads and writes.
// Ends with every thread past its last write to buf.
template <int M, int V, int P, bool LOAD, bool STORE, int NS, int R,
          int... REST, class Ld, class St>
__device__ __forceinline__ void passes(float2* buf,
                                       const float2* __restrict__ tw, int g,
                                       int t, Ld ld, St st) {
  constexpr int T = M / V;   // threads a transform
  constexpr int NB = V / R;  // butterflies a thread
  constexpr int L = M / R;   // butterflies, and the stride of their inputs
  constexpr bool from_ld = LOAD && NS == 1;
  constexpr bool to_st = STORE && sizeof...(REST) == 0;
  static_assert(NB * R == V && T * NB == L, "radix plan");
  float2 v[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = t + b * T;
    const int k = j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (from_ld)
        v[b][r] = ld(j + r * L);
      else
        v[b][r] = buf[(j + r * L) * P + g];
    }
    if constexpr (NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[b][r] = cmul(v[b][r], __ldg(&tw[r * k * (M / (NS * R))]));
    }
    dft<R>(v[b]);
  }
  if constexpr (!from_ld && !to_st) __syncthreads();  // reads done
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = t + b * T;
    const int d = (j / NS) * NS * R + j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (to_st)
        st(d + r * NS, v[b][r]);
      else
        buf[(d + r * NS) * P + g] = v[b][r];
    }
  }
  if constexpr (!to_st) __syncthreads();
  if constexpr (sizeof...(REST) > 0)
    passes<M, V, P, LOAD, STORE, NS * R, REST...>(buf, tw, g, t, ld, st);
}

// every pass in shared memory
template <int M, int V, int P, int NS, int R, int... REST>
__device__ __forceinline__ void stockham(float2* buf,
                                         const float2* __restrict__ tw,
                                         int g, int t) {
  passes<M, V, P, false, false, NS, R, REST...>(
      buf, tw, g, t, [](int) { return make_float2(0.0f, 0.0f); },
      [](int, float2) {});
}

}  // namespace radix
