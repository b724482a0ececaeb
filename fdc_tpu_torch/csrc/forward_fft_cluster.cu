// Kernel F2c: kernel F's large-N form on a thread-block cluster, blocks of
// 32768 to 131072 points in one pass over device memory.
//
// It replaces the same TPU kernels as kernel F (forward_fft.cu) and its
// two-pass form (forward_fft_2pass.cu): the fused four-step forward FFT of
// tools/pallas_fft_proto.py (kernel_w1 / kernel_w2, call :130) and
// tools/pallas_fft_proto2.py (kernel, call :133), i.e.
// fdc_tpu.ops.fft.forward_spectrum_mxu: per block of N complex64 samples,
// the DFT, fftshifted (DC at bin N/2) and scaled by 1/N. It computes what
// the two-pass form computes, with its split (N = m1 m2, m1 =
// 2^ceil(log2 N / 2), n = n1 m2 + n2, k = k1 + m1 k2), its radix plans
// (ops/fft.py TWO_PASS_PLANS) and its float64-made twiddles, in the same
// order of operations (the two agree bit for bit):
//
//   X[k1 + m1 k2] = sum_n2 W_m2^(n2 k2) W_N^(n2 k1) sum_n1 x[n1 m2 + n2]
//                   W_m1^(n1 k1).
//
// What bounds it on the H100: the block read once and the spectrum written
// once, 8 N bytes each way; at [512, 32768], [256, 65536] and [128, 131072]
// 268.4 MB, 0.080 ms at 3.35 TB/s. 5 N log2 N fp32 operations take
// 0.019-0.021 ms at 67 TFLOP/s: bound by bytes, so no tensor cores (fp32
// FFMA only). The two-pass form moves twice the bytes: one CTA's 227 KB of
// shared memory cannot hold a 32768-point block (256 KB), so it writes the
// twiddled column FFTs to a scratch block in device memory and reads them
// back.
//
// The design: a cluster of C CTAs a block (C a power of two <= 8, the
// portable size: 16 can leave part of a GPC idle), on neighbouring SMs,
// whose shared memories hold the block between them, N / C values each,
// and read each other's (distributed shared memory, DSMEM). The four-step
// transpose stays on chip, and device memory sees the block once in and
// once out, with no scratch tensor.
//
// 1. CTA c (its rank in the cluster) takes the TC = m2 / C columns n2 =
//    c TC + j and runs their m1-point FFTs (radix_fft.cuh's Stockham
//    passes, G1 columns at a time, j the fastest index of the thread). The
//    first pass reads its values straight from device memory (16 adjacent
//    columns a half-warp: 128-byte runs), the others work in shared memory,
//    value k1 of column j at buf[k1 TC + j].
// 2. The transpose through DSMEM, (C - 1) / C of the block: a cluster
//    barrier (every CTA's column FFTs are done), then CTA c reads its RC =
//    m1 / C rows k1 = c RC + k of every peer's columns (peer r holds n2 =
//    r TC + j; its rows c RC ... c RC + RC - 1 are one contiguous run of RC
//    TC values: 16-byte reads, adjacent threads on adjacent addresses)
//    into registers, N / (C NT) values a thread. A second cluster barrier
//    (no peer reads this CTA's columns any more) comes before it
//    multiplies them by W_N^(k1 n2) and writes value n2 of row k over its
//    columns, at buf[n2 (RC + 1) + k] (one pad: the transposed writes and
//    the row passes' reads hit 16 banks a half-warp). The twiddles come
//    from twk [m1, m2], the two-pass form's table values twn[k1 n2] laid
//    out row by row, so these reads are 16-byte and adjacent too (reads
//    of twn[k1 n2] scatter over sectors).
// 3. CTA c runs the m2-point row FFTs; the last pass writes
//    out[k1 + m1 ((k2 + m2 / 2) mod m2)] / N straight from registers: RC
//    adjacent rows k1 give runs of RC adjacent outputs (256 bytes and
//    more).
// 4. No CTA touches a peer's shared memory after the second barrier, so
//    none can leave while a peer may still read its buffer: that barrier
//    is also the exit's.
//
// One buffer staged through registers, against two (the columns in one,
// the gather straight into the other, no second barrier before it):
// staging costs N / (C NT) registers' worth of values a thread (8 to 16
// here) and one barrier; a second buffer doubles a CTA's shared memory, so
// fewer CTAs share an SM and fewer of one CTA's loads overlap another's
// passes. On the card two buffers were slower at every N; one buffer also
// brings 131072 in reach at all (C = 8: 130 KB a CTA; two would need 260
// KB). Likewise C = 4 at 32768 with two 64 KB buffers against C = 2 with
// one 128 KB buffer staged in registers: both hold fewer CTAs an SM than
// C = 8 with 33 KB, and both ran slower on the card than C = 8 (C = 4
// with one buffer too). A larger C moves more of the block through DSMEM
// ((C - 1) / C), a smaller one needs more shared memory a CTA. So there is
// one build an N, C = 8: 512 threads and 4 CTAs an SM at 32768 (33 KB a
// CTA), 512 and 2 at 65536 (66 KB), 1024 and 1 at 131072 (130 KB, the row
// tile of m2 (m1 / C + 1) values).
//
// Tried on the card and dropped, each slower: the column tile brought in
// by bulk copies (cp.async.bulk) on an mbarrier (its latency in the open,
// and one more trip through shared memory than the first pass reading the
// block itself); persistent clusters that prefetch the next block's tile
// the same way (they spill registers); the twiddle read from twn[k1 n2],
// as the two-pass form reads it (scattered 8-byte reads, a sector each);
// two buffers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "radix_fft.cuh"
#include "smem_optin.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace radix;

// the Stockham plan of each transform length (ops/fft.py TWO_PASS_PLANS):
// values a thread, then the radices in order
template <int M>
struct Plan;

#define FDC_PLAN(M, V, ...)                                                \
  template <>                                                              \
  struct Plan<M> {                                                         \
    static constexpr int values = V;                                       \
    template <int P, bool LOAD, bool STORE, class Ld, class St>            \
    static __device__ __forceinline__ void run(                            \
        float2* buf, const float2* __restrict__ tw, int g, int t, Ld ld,   \
        St st) {                                                           \
      passes<M, V, P, LOAD, STORE, 1, __VA_ARGS__>(buf, tw, g, t, ld, st); \
    }                                                                      \
  };
FDC_PLAN(128, 8, 8, 4, 4)
FDC_PLAN(256, 8, 8, 8, 4)
FDC_PLAN(512, 8, 8, 8, 8)
#undef FDC_PLAN

// values of a CTA's buffer: the column tile (m1 x TC, dense) or the row
// tile (m2 x (RC + 1)), whichever is larger
template <int M1, int M2, int C>
__host__ __device__ constexpr int tile_values() {
  return M1 * (M2 / C) > M2 * (M1 / C + 1) ? M1 * (M2 / C)
                                            : M2 * (M1 / C + 1);
}

// one cluster of C CTAs a block of N = M1 M2 values, NT threads a CTA, at
// least MINB CTAs an SM
template <int M1, int M2, int C, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB)
    cluster_fft(const float2* __restrict__ x, const float2* __restrict__ tw1,
                const float2* __restrict__ tw2,
                const float2* __restrict__ twk, float2* __restrict__ out,
                float scale) {
  constexpr int N = M1 * M2;
  constexpr int TC = M2 / C;  // columns n2 a CTA (step 1)
  constexpr int RC = M1 / C;  // rows k1 a CTA (steps 2-3)
  constexpr int PR = RC + 1;  // the row tile's pitch
  constexpr int RUN = RC * TC;  // a peer's run for one CTA
  constexpr int G1 = NT / (M1 / Plan<M1>::values);  // columns at a time
  constexpr int G2 = NT / (M2 / Plan<M2>::values);  // rows at a time
  constexpr int S = RC * M2 / (2 * NT);  // 16-byte reads a thread (step 2)
  static_assert(G1 >= 16 && TC % G1 == 0 && G2 >= 16 && RC % G2 == 0,
                "threads: whole groups of >= 16 transforms");
  static_assert(2 * S * NT == RC * M2 && TC % 2 == 0, "the gather");
  const auto no_ld = [](int) { return make_float2(0.0f, 0.0f); };
  const auto no_st = [](int, float2) {};

  extern __shared__ __align__(16) float2 buf[];  // the columns, then rows
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const size_t row = blockIdx.x / C;
  const int tid = threadIdx.x;

  // 1. the column FFTs, the first pass reading x[n1 m2 + c TC + j]
  const float2* src = x + row * N + c * TC;
#pragma unroll 1
  for (int q = 0; q < TC; q += G1) {
    const int g = tid % G1;
    const float2* col = src + q + g;
    Plan<M1>::template run<TC, true, false>(
        buf + q, tw1, g, tid / G1,
        [col](int i) { return __ldg(&col[static_cast<size_t>(i) * M2]); },
        no_st);
  }

  // 2. the transpose: rows k1 = c RC + k of every peer's columns, value
  // (k, j) of peer r at its buf[c RUN + k TC + j], twiddled
  cluster.sync();
  float4 st[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int e = 2 * (tid + s * NT);
    const int r = e / RUN, q = e % RUN;
    st[s] = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(buf, r) + c * RUN + q);
  }
  cluster.sync();  // no peer reads this CTA's columns any more
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int e = 2 * (tid + s * NT);
    const int r = e / RUN, q = e % RUN;
    const int k = q / TC, n2 = r * TC + q % TC;
    const float4 w = __ldg(reinterpret_cast<const float4*>(
        twk + (c * RC + k) * M2 + n2));
    buf[n2 * PR + k] =
        cmul(make_float2(st[s].x, st[s].y), make_float2(w.x, w.y));
    buf[(n2 + 1) * PR + k] =
        cmul(make_float2(st[s].z, st[s].w), make_float2(w.z, w.w));
  }
  __syncthreads();

  // 3. the row FFTs, the last pass writing out[k1 + m1 ((k2 + m2/2) mod m2)]
  float2* dst = out + row * N + c * RC;
#pragma unroll 1
  for (int q = 0; q < RC; q += G2) {
    const int g = tid % G2;
    float2* o = dst + q + g;
    Plan<M2>::template run<PR, false, true>(
        buf + q, tw2, g, tid / G2, no_ld, [o, scale](int k2, float2 v) {
          o[static_cast<size_t>(M1) * ((k2 + M2 / 2) & (M2 - 1))] =
              make_float2(v.x * scale, v.y * scale);
        });
  }
}

// launch (fit == nullptr) or ask how many clusters the card holds at once
template <int M1, int M2, int C, int NT, int MINB>
int call(const void* x, int batch, const void* tw1, const void* tw2,
         const void* twk, void* out, int* fit, cudaStream_t st) {
  auto* kern = cluster_fft<M1, M2, C, NT, MINB>;
  constexpr int smem =
      static_cast<int>(tile_values<M1, M2, C>() * sizeof(float2));
  static bool done[64] = {};
  cudaError_t err = allow_smem(kern, smem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch > 0 ? batch : 1) * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (fit != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveClusters(fit, kern, &cfg));
  const float scale =
      1.0f / (static_cast<float>(M1) * static_cast<float>(M2));
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const float2*>(x),
                           static_cast<const float2*>(tw1),
                           static_cast<const float2*>(tw2),
                           static_cast<const float2*>(twk),
                           static_cast<float2*>(out), scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// (m1, m2, C, NT, MINB) of the build an N
#define FDC_CLUSTER_BUILDS(X) \
  X(256, 128, 8, 512, 4)      \
  X(256, 256, 8, 512, 2)      \
  X(512, 256, 8, 1024, 1)

int dispatch(int n, const void* x, int batch, const void* tw1,
             const void* tw2, const void* twk, void* out, int* fit,
             cudaStream_t st) {
#define FDC_CASE(M1, M2, C, NT, MINB)                                    \
  if (n == (M1) * (M2))                                                 \
    return call<M1, M2, C, NT, MINB>(x, batch, tw1, tw2, twk, out, fit, \
                                     st);
  FDC_CLUSTER_BUILDS(FDC_CASE)
#undef FDC_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: complex64 [batch, n], contiguous; n = m1 m2 in {32768, 65536, 131072}
// with m1 = 2^ceil(log2 n / 2); tw1, tw2: complex64 [m1], [m2], W_m^k;
// twk: complex64 [m1, m2], W_n^(k1 n2), 16-byte aligned; out: complex64
// rows of n values, row b at out + b * n.
extern "C" int fdc_forward_fft_cluster(const void* x, int batch, int n,
                                       const void* tw1, const void* tw2,
                                       const void* twk, void* out,
                                       void* stream) {
  return dispatch(n, x, batch, tw1, tw2, twk, out, nullptr,
                  static_cast<cudaStream_t>(stream));
}

// clusters: int [1], set to cudaOccupancyMaxActiveClusters of n's build;
// the stream is not used
extern "C" int fdc_forward_fft_cluster_fit(int n, void* clusters,
                                           void* stream) {
  return dispatch(n, nullptr, 0, nullptr, nullptr, nullptr, nullptr,
                  static_cast<int*>(clusters),
                  static_cast<cudaStream_t>(stream));
}
