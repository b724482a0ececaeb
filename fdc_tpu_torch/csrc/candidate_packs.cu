// Candidate packs of the detection segments (kernel B).
//
// Replaces the Pallas kernel fdc_tpu/ops/detect.py:183
// _greedy_accept_kernel (greedy_accept_batch), and with it the candidate
// stage around it: the edge detection, the compaction and the geometry,
// which the JAX package's SegmentDetector._packed_candidates runs as
// separate operations.
//
// What it computes: for every segment g of a step and every spectrum
// block b, the cell powers P[b, :n_cells] -> row b of g's [B, 7K] pack
// (K = k_pack; groups start bin, end bin, valid, wlog2, ext_start,
// ext_start % R, too_big), bit-equal to ops/detect.py
// candidate_packs_plain (reference: lib/SegmentDetection_impl.cc:195-344):
//
//   ratio_i = P[i + 1] / P[i] (IEEE fp32; with zero_floor a zero
//     denominator is FLT_MIN), rise_i = ratio_i > thr, fall_i = ratio_i <
//     1/thr (NaN is neither);
//   the rises by ratio, descending, ties to the lower index (a stable
//     sort); only the first min(k_detect, n_cells - 1) count;
//   each paired with the nearest fall at or after it, end = fall + 1;
//   greedy acceptance in that order under the reference's test
//     s_j < e_i && e_j >= s_i against every accepted i;
//   the accepted ones compacted to the front, the empty columns 0, all
//     converted to bins, and their new-channel geometry.
//
// All segments of a step share one launch: a segment table (CandTab)
// names each one's powers (a row-strided view), parameters and offset in
// one flat int32 buffer, kernel C's pack layout (lifecycle.cu SegTab).
//
// What bounds it on the H100: bytes, 0.1-0.8 us at 3.35 TB/s for the
// paths' powers in and packs out (hunter4seg: 4 x [512, 93] floats in,
// 4 x [512, 224] ints out, 2.6 MB), and the latency of the dependent
// steps each block's row takes: the ratio pass (n_cells / 32 steps),
// the ranking (a step a rise), the acceptance chain (a step a paired
// candidate in rank order) and the stores.
//
// What the design does about it: a warp a (segment, block) row, so the
// 512 x G rows run side by side and each row's steps are few. Lane j of
// step c divides for position 32 c + j; two ballots give the rise and
// fall bits; the nearest fall at or after each position is the first set
// bit of its chunk's fall mask above it, or the suffix minimum (a warp
// scan over the chunks) of the first falls of the chunks after it. Only
// the rises are ranked: each rise's key (its ratio's bits inverted, then
// its index) against the other rises' keys in shared memory, so the
// stable sort is a count of smaller keys. The accepted intervals are
// disjoint, so the acceptance tests a bitmap of the occupied cells, held
// in registers (two 32-bit words a lane, 2048 cells): candidate j is
// blocked iff an occupied cell lies in [s_j, e_j], one warp vote a step
// instead of compares against every accepted interval. The geometry and
// the seven groups' stores run a lane a column, coalesced.
//
// Limits: n_cells <= 2048 a segment (the bitmap), 32 segments a launch.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

#include "smem_optin.cuh"

namespace {

constexpr int MAXG = 32;         // segments a launch
constexpr int MAX_CELLS = 2048;  // a segment's cells: 64 bitmap words
constexpr int WARPS = 4;         // rows a CTA
constexpr int MAX_SMEM = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_FALL = 0x7fffffff;

struct CandSeg {
  const float* powers;  // row b at powers + b * stride
  long long stride;     // floats
  int n_cells, k_detect, k_pack, start, dec, w_cap, w_cap_log2, n, r;
  int zero_floor, pack_off;
  float thr, inv_thr, grow;  // fp32 thresh, fp32 1 / thresh, 1 + 2 puffer
};

struct CandTab {
  int n;
  CandSeg seg[MAXG];
};

// a warp's shared memory at nr ratio positions and kp pack columns:
// uint64 keys [nr], int2 ranked candidates [nr], int2 accepted [kp],
// uint32 fall masks and int suffix minima [nr / 32 rounded up]
__host__ __device__ inline int warp_bytes(int nr, int kp) {
  const int nch = (nr + 31) / 32;
  return (16 * nr + 8 * kp + 8 * nch + 15) / 16 * 16;
}

// the bits of bitmap word w (cells 32 w ... 32 w + 31) in cells [lo, hi]
__device__ __forceinline__ unsigned range_bits(int w, int lo, int hi) {
  const int a = max(lo - 32 * w, 0);
  const int b = min(hi - 32 * w, 31);
  return a > b ? 0u : (FULL >> (31 - b)) & (FULL << a);
}

// The greedy acceptance, called by all 32 lanes of a warp: candidates
// cand[0, n) in order, each (start, end) in cells, end < 0 if unpaired;
// candidate j is accepted iff paired and no cell of an accepted one lies
// in [s_j, e_j]. For accepted intervals [s_i, e_i) with s_i < e_i and
// candidates with s_j <= e_j that is the reference's s_j < e_i &&
// e_j >= s_i; cells 0 ... 2047, lane l holding words l and l + 32 of the
// bitmap. emit(j, count) for each accepted one (count accepted before
// it); returns the count.
template <class Emit>
__device__ __forceinline__ int accept_chain(const int2* cand, int n,
                                            Emit&& emit) {
  const int lane = threadIdx.x & 31;
  unsigned occ0 = 0u, occ1 = 0u;
  int count = 0;
  for (int j = 0; j < n; ++j) {
    const int2 c = cand[j];
    if (c.y < 0) continue;
    const unsigned hit = (range_bits(lane, c.x, c.y) & occ0) |
                         (range_bits(lane + 32, c.x, c.y) & occ1);
    if (__any_sync(FULL, hit != 0u)) continue;
    occ0 |= range_bits(lane, c.x, c.y - 1);
    occ1 |= range_bits(lane + 32, c.x, c.y - 1);
    emit(j, count);
    ++count;
  }
  return count;
}

__global__ void __launch_bounds__(WARPS * 32)
    candidate_packs_kernel(const __grid_constant__ CandTab tab, int nb,
                           int* __restrict__ out, int nr_max, int kp_max) {
  extern __shared__ int4 smem4[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int row = blockIdx.x * WARPS + w;
  const int g = row / nb;
  if (g >= tab.n) return;
  const int b = row - g * nb;
  const CandSeg& sg = tab.seg[g];

  unsigned char* base = reinterpret_cast<unsigned char*>(smem4) +
                        w * warp_bytes(nr_max, kp_max);
  uint64_t* keys = reinterpret_cast<uint64_t*>(base);
  int2* cand = reinterpret_cast<int2*>(base + 8 * nr_max);
  int2* acc = reinterpret_cast<int2*>(base + 16 * nr_max);
  unsigned* fallm = reinterpret_cast<unsigned*>(base + 16 * nr_max +
                                                8 * kp_max);
  int* suf = reinterpret_cast<int*>(fallm + (nr_max + 31) / 32);

  const int n_r = sg.n_cells - 1;
  const int nch = (n_r + 31) >> 5;
  const float* p = sg.powers + static_cast<long long>(b) * sg.stride;

  // 1. ratios: fall masks by chunk, the rises' keys in a list
  int nrise = 0;
#pragma unroll 4
  for (int c = 0; c < nch; ++c) {
    const int i = 32 * c + lane;
    const bool in = i < n_r;
    float den = in ? __ldg(p + i) : 1.0f;
    const float num = in ? __ldg(p + i + 1) : 1.0f;
    if (sg.zero_floor && den == 0.0f) den = FLT_MIN;
    const float ratio = __fdiv_rn(num, den);
    const bool rise = in && ratio > sg.thr;
    const unsigned rm = __ballot_sync(FULL, rise);
    const unsigned fm = __ballot_sync(FULL, in && ratio < sg.inv_thr);
    if (lane == 0) fallm[c] = fm;
    // a rise's ratio is > thr >= 1: positive, so its bits order as the
    // ratios do (+inf included); inverted they sort descending
    if (rise)
      keys[nrise + __popc(rm & ((1u << lane) - 1u))] =
          (static_cast<uint64_t>(~__float_as_uint(ratio)) << 32) |
          static_cast<unsigned>(i);
    nrise += __popc(rm);
  }
  __syncwarp();

  // 2. suf[c]: the first fall at or after cell 32 c (a suffix minimum
  // over the chunks, 32 chunks a warp step, from the last)
  int carry = NO_FALL;
  for (int c0 = (nch - 1) & ~31; c0 >= 0; c0 -= 32) {
    const int c = c0 + lane;
    const unsigned m = c < nch ? fallm[c] : 0u;
    int v = m ? 32 * c + __ffs(m) - 1 : NO_FALL;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_down_sync(FULL, v, off);
      if (lane + off < 32) v = min(v, o);
    }
    v = min(v, carry);
    if (c < nch) suf[c] = v;
    carry = __shfl_sync(FULL, v, 0);
  }
  __syncwarp();

  // 3. rank the rises (smaller keys before them), pair the first k_eff
  const int k_eff = min(sg.k_detect, n_r);
  for (int e = lane; e < nrise; e += 32) {
    const uint64_t key = keys[e];
    int rank = 0;
    for (int j = 0; j < nrise; ++j) rank += keys[j] < key;
    if (rank < k_eff) {
      const int i = static_cast<int>(key & 0xffffffffu);
      const int c = i >> 5;
      const unsigned m = fallm[c] & (FULL << (i & 31));
      const int nf = m ? 32 * c + __ffs(m) - 1
                       : (c + 1 < nch ? suf[c + 1] : NO_FALL);
      cand[rank] = make_int2(i, nf < n_r ? nf + 1 : -1);
    }
  }
  __syncwarp();

  // 4. the acceptance chain; the accepted ones in acceptance order
  const int kp = sg.k_pack;
  const int count = accept_chain(
      cand, min(nrise, k_eff), [&](int j, int cnt) {
        if (lane == 0 && cnt < kp) acc[cnt] = cand[j];
      });
  __syncwarp();

  // 5. the row: bins and geometry a column (empty columns are cells 0)
  int* o = out + sg.pack_off + static_cast<size_t>(b) * 7 * kp;
  for (int j = lane; j < kp; j += 32) {
    const bool v = j < count;
    const int2 c = v ? acc[j] : make_int2(0, 0);
    const int cs = c.x * sg.dec + sg.start;
    const int ce = c.y * sg.dec + sg.start;
    const int det_w = ce - cs;  // >= 0
    const int ext_raw =
        static_cast<int>(ceilf(__fmul_rn(static_cast<float>(det_w), sg.grow)));
    // ceil(log2) of max(ext_raw, 1), saturating at w_cap_log2 + 2
    const int wl2 = min(32 - __clz(max(ext_raw, 1) - 1), sg.w_cap_log2 + 2);
    const int ext_w = 1 << wl2;
    const int mid = cs + det_w / 2;
    int es = mid - ext_w / 2;
    int ee = mid + ext_w / 2;
    if (es < 0) {
      es = 0;
      ee = ext_w;
    }
    if (ee > sg.n) es = sg.n - ext_w;  // negative where ext_w > n
    int esr = es % sg.r;                 // floor modulo
    if (esr < 0) esr += sg.r;
    o[j] = cs;
    o[kp + j] = ce;
    o[2 * kp + j] = v;
    o[3 * kp + j] = wl2;
    o[4 * kp + j] = es;
    o[5 * kp + j] = esr;
    o[6 * kp + j] = ext_w > sg.w_cap;
  }
}

// greedy_accept_batch's form: the candidates of a [nb, k] row as given,
// through the same acceptance chain (paired ones checked by the wrapper
// to lie in cells 0 <= s < e < 2048)
__global__ void __launch_bounds__(WARPS * 32)
    greedy_accept_kernel(const int* __restrict__ cs,
                         const int* __restrict__ ce,
                         const uint8_t* __restrict__ has_pair,
                         uint8_t* __restrict__ out, int nb, int k) {
  extern __shared__ int4 smem4[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int row = blockIdx.x * WARPS + w;
  if (row >= nb) return;
  int2* cand = reinterpret_cast<int2*>(smem4) + w * k;
  const size_t o = static_cast<size_t>(row) * k;
  for (int j = lane; j < k; j += 32) {
    cand[j] = make_int2(cs[o + j], has_pair[o + j] ? ce[o + j] : -1);
    out[o + j] = 0;
  }
  __syncwarp();
  accept_chain(cand, k, [&](int j, int) {
    if (lane == 0) out[o + j] = 1;
  });
}

}  // namespace

// seg_ptrs: HOST int64 [n_seg, 2] rows (powers pointer, row stride in
// floats); seg_ints: HOST int32 [n_seg, 11] rows (n_cells, k_detect,
// k_pack, start, decimation, w_cap, w_cap_log2, n, r, zero_floor,
// pack_off); seg_floats: HOST float32 [n_seg, 3] rows (thresh, 1 /
// thresh, 1 + 2 puffer, each rounded to fp32). out: int32, segment g's
// [nb, 7 k_pack] pack at pack_off.
extern "C" int fdc_candidate_packs(int n_seg, const void* seg_ptrs,
                                   const void* seg_ints,
                                   const void* seg_floats, int nb, void* out,
                                   void* stream) {
  if (n_seg < 1 || n_seg > MAXG || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CandTab tab{};
  tab.n = n_seg;
  int nr_max = 1, kp_max = 1;
  const long long* ptrs = static_cast<const long long*>(seg_ptrs);
  const int* ints = static_cast<const int*>(seg_ints);
  const float* fl = static_cast<const float*>(seg_floats);
  for (int g = 0; g < n_seg; ++g) {
    CandSeg& s = tab.seg[g];
    const int* row = ints + 11 * g;
    s.powers = reinterpret_cast<const float*>(ptrs[2 * g]);
    s.stride = ptrs[2 * g + 1];
    s.n_cells = row[0];
    s.k_detect = row[1];
    s.k_pack = row[2];
    s.start = row[3];
    s.dec = row[4];
    s.w_cap = row[5];
    s.w_cap_log2 = row[6];
    s.n = row[7];
    s.r = row[8];
    s.zero_floor = row[9];
    s.pack_off = row[10];
    s.thr = fl[3 * g];
    s.inv_thr = fl[3 * g + 1];
    s.grow = fl[3 * g + 2];
    if (s.n_cells < 2 || s.n_cells > MAX_CELLS || s.k_detect < 1 ||
        s.k_pack < 1 || s.dec < 1 || s.r < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    nr_max = max(nr_max, s.n_cells - 1);
    kp_max = max(kp_max, s.k_pack);
  }
  const int bytes = WARPS * warp_bytes(nr_max, kp_max);
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static bool done[64] = {};
  const cudaError_t err = allow_smem(candidate_packs_kernel, MAX_SMEM, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = n_seg * nb;
  candidate_packs_kernel<<<(rows + WARPS - 1) / WARPS, WARPS * 32, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      tab, nb, static_cast<int*>(out), nr_max, kp_max);
  return static_cast<int>(cudaGetLastError());
}

// cs, ce: int32 [nb, k]; has_pair, out: uint8 (bool) [nb, k]
extern "C" int fdc_greedy_accept(const void* cs, const void* ce,
                                 const void* has_pair, void* out, int nb,
                                 int k, void* stream) {
  if (nb < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = WARPS * k * 8;
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static bool done[64] = {};
  const cudaError_t err = allow_smem(greedy_accept_kernel, MAX_SMEM, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_accept_kernel<<<(nb + WARPS - 1) / WARPS, WARPS * 32, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cs), static_cast<const int*>(ce),
      static_cast<const uint8_t*>(has_pair), static_cast<uint8_t*>(out), nb,
      k);
  return static_cast<int>(cudaGetLastError());
}
