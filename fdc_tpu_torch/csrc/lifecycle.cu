// Slot-lifecycle automata of the detection segments, with the burst
// hysteresis chain in the same launch.
//
// Replaces the Pallas kernel fdc_tpu/ops/lifecycle_pallas.py
// _lifecycle_kernel (slot_lifecycle_multi, with its powact chain).
//
// What it computes: the semantics of the plain paths, not the TPU
// kernel's structure — per segment, over the B blocks of a batch, the
// scan body of SegmentDetector.scan_slots (fdc_tpu/models/
// segment_detection.py:571-690): match pre-accepted candidates against
// the live slots (the earliest-activated overlapping slot consumes a
// candidate and is refreshed), age unmatched slots, allocate free slots
// in index order to the remaining candidates in acceptance order, retire
// a slot (tombstone) after the deactivation delay, keep the overlap-save
// phase bookkeeping; at the end free the tombstones (_free_tombstones).
// The burst bank's chain is PowerActivationBank.scan_flags
// (fdc_tpu/models/power_activation.py:184-212). Flags, slot tables and
// counters are exact (integer logic; the burst ratios are IEEE fp32
// divisions, as on the host).
//
// What bounds it on the H100: latency. The work is tiny (S = 16 slots,
// K = 16 candidates, 512 blocks on the flagship) and every block depends
// on the previous one, so the kernel is one dependency chain of B steps:
// its time is the number of steps times the latency of each, not its
// arithmetic or its bytes.
//
// What the design does about it: one CUDA block per segment, and in it
// ONE warp runs the chain with no block barrier and no shared-memory
// round trip on the match. Each lane holds SPL = S/32 slots (rounded up
// to a power of two, 1 ... 32; a template) in registers, slot
// i * 32 + lane in its register i: so a warp store of slot i is 32
// consecutive words, and the rank of a free slot in slot order is the
// popcounts of the ballots of the registers before it plus a lane-prefix
// popcount (a warp prefix sum by ballots, no shuffle chain). The chain
// walks only the valid candidates of a block (nv of them, 1.6-6 on the
// paths against K = 16-32 columns): for each, every lane marks its live
// slots that overlap it (a bitmask, no dependent chain); where exactly
// one slot in the warp overlaps, it consumes the candidate, else every
// lane takes its earliest (order, slot), __reduce_min_sync gives the
// warp's earliest (sign-flipped) order, and where two lanes share it a
// second reduction on the slot index picks the lower slot — argmin's tie
// rule. Unconsumed candidates that fit go to a list of new ones; the
// free slot of rank r takes the r-th. The work over a lane's registers
// is bit masks and selects, and it visits only the registers up to the
// last that holds a live slot in some lane (nr, warp-uniform): allocation
// takes the lowest free slots, so on the paths (at most a few dozen slots
// live) S = 512's sixteen registers a lane cost about one. The slots of
// the registers past nr are idle: the chain writes no flag for them, and
// the flush writes theirs (none, and the phase of the chunk's start).
//
// The other warps of the block feed the chain. While warp 0 walks chunk
// c (up to 32 blocks), they stage chunk c + 1's candidate rows from
// device memory into shared memory with 16-byte loads, build its
// per-block candidate lists from the valid column itself (the kernel
// does not rely on the pack's compaction): the count nv and each valid
// candidate's (start, end) and (wlog2, ext_start, ext_start % R,
// too_big), packed contiguously in k order; and they write chunk c - 1's
// flags from shared memory to the slot-major [S, B] outputs in coalesced
// stores. Lists and flags are double-buffered, so warp 0 meets the
// helpers only at a chunk boundary (named barrier 2); the helpers
// synchronise among themselves on named barrier 1. ext_start and wlog2,
// which only allocation writes, live in shared memory; the slot state
// the chain reads every block lives in registers. One extra block runs
// the burst chain, a warp per channel: kernel D's chain (a warp scan),
// shared through powact_chain.cuh, staging its flags in the block's
// shared memory. All segments and the burst bank share one launch.
// The TPU kernel's tier ladders, chunk closed forms, gap prefilter and
// [1, S] row layout were TPU devices and are not reproduced.

#include <type_traits>

#include "powact_chain.cuh"
#include "smem_optin.cuh"

namespace {

constexpr int MAXG = 32;
constexpr int HELPERS = 7;                 // helper warps a block
constexpr int THREADS = 32 * (1 + HELPERS);
constexpr int MAX_CHUNK = 32;              // blocks a chunk
constexpr int SMEM_BUDGET = 160 * 1024;    // bytes, chunk buffers
constexpr int MAX_SMEM = 227 * 1024;       // a block's opt-in limit
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;

// per-segment static parameters and offsets into the flat buffers
struct SegTab {
  int n;
  int k[MAXG];         // candidates per block (pack group width)
  int r[MAXG];         // relinvovl
  int delay[MAXG];     // deactivation delay
  int s[MAXG];         // slots
  int pack_off[MAXG];  // int32 [B, 7K] pack
  int state_off[MAXG]; // int32 [10, S] slot table
  int flag_off[MAXG];  // uint8 [3, S, B] got/processed/emit
  int pu_off[MAXG];    // int32 [S, B] phase_used
};

// The shared-memory carve-up of one block (all sizes from the launch)
struct Layout {
  int chunk;  // blocks a chunk
  int kmax;   // candidate columns
  int sp;     // flag row stride: slots + 1
  int spl;    // slots a lane
  // byte offsets
  int geo, se, stage, pu, nv, nr, ph, xs, wl, newl, fl, total;
};

__host__ __device__ inline Layout layout(int chunk, int kmax, int smax,
                                         int spl) {
  Layout L;
  L.chunk = chunk;
  L.kmax = kmax;
  L.sp = smax + 1;
  L.spl = spl;
  int o = 0;
  L.geo = o;    // int4 [2][chunk][kmax] (wlog2, ext_start, esr, too_big)
  o += 2 * chunk * kmax * 16;
  L.se = o;     // int2 [2][chunk][kmax] (start, end)
  o += 2 * chunk * kmax * 8;
  L.stage = o;  // int [chunk][7 kmax], staged pack rows
  o += (chunk * 7 * kmax * 4 + 15) / 16 * 16;
  L.pu = o;     // int [2][chunk][sp] phase_used
  o += 2 * chunk * L.sp * 4;
  L.nv = o;     // int [2][chunk] valid candidates a block
  o += 2 * chunk * 4;
  L.nr = o;     // int [2][chunk] registers the chain wrote a block
  o += 2 * chunk * 4;
  L.ph = o;     // int [2][32 spl] each slot's phase at the chunk's start
  o += 2 * 32 * spl * 4;
  L.xs = o;     // int [32 spl] ext_start of each slot
  o += 32 * spl * 4;
  L.wl = o;     // int [32 spl] wlog2
  o += 32 * spl * 4;
  L.newl = o;   // int [kmax] the block's new candidates (list positions)
  o += kmax * 4;
  L.fl = o;     // uint8 [2][chunk][sp] got | processed << 1 | emit << 2
  o += 2 * chunk * L.sp;
  L.total = (o + 15) / 16 * 16;
  return L;
}

__device__ __forceinline__ int mod_pos(int x, int r) {
  const int m = x % r;  // floor modulo, as jnp / torch %
  return m < 0 ? m + r : m;
}

// the helper warps among themselves (named barrier 1), and the whole
// block at a chunk boundary (named barrier 2): warp 0 and the helpers
// reach it from their own code
__device__ __forceinline__ void helper_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(32 * HELPERS) : "memory");
}

__device__ __forceinline__ void chunk_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"r"(THREADS) : "memory");
}

constexpr int STAGE_UNROLL = 8;  // 16-byte loads in flight per thread

// Copy n ints of device memory into shared memory, threads [0, nt) of
// the caller's group with tid its index, many loads in flight per
// thread: 16-byte vectors when the source is aligned (dst always is),
// scalars for the rest.
__device__ void stage(int* dst, const int* src, int n, int tid, int nt) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n / 4;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i0 = tid; i0 < n4; i0 += STAGE_UNROLL * nt) {
      int4 v[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * nt;
        if (i < n4) v[u] = s4[i];
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * nt;
        if (i < n4) d4[i] = v[u];
      }
    }
    done = n4 * 4;
  }
  for (int i0 = done + tid; i0 < n; i0 += STAGE_UNROLL * nt) {
    int v[STAGE_UNROLL];
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int i = i0 + u * nt;
      if (i < n) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int i = i0 + u * nt;
      if (i < n) dst[i] = v[u];
    }
  }
}

// Helpers: stage blocks [b0, b0 + n_blk) of the pack and build their
// candidate lists into list buffer `buf` (a warp a block).
__device__ void build_chunk(const Layout& L, unsigned char* sm,
                            const int* pack, int K, int b0, int n_blk,
                            int buf) {
  const int tid = threadIdx.x - 32;
  const int lane = threadIdx.x & 31;
  const int hw = tid >> 5;
  const int row_len = 7 * K;
  int* st = reinterpret_cast<int*>(sm + L.stage);
  stage(st, pack + static_cast<size_t>(b0) * row_len, n_blk * row_len, tid,
        32 * HELPERS);
  helper_sync();
  int4* geo = reinterpret_cast<int4*>(sm + L.geo) + buf * L.chunk * L.kmax;
  int2* se = reinterpret_cast<int2*>(sm + L.se) + buf * L.chunk * L.kmax;
  int* nvs = reinterpret_cast<int*>(sm + L.nv) + buf * L.chunk;
  for (int jb = hw; jb < n_blk; jb += HELPERS) {
    const int* row = st + jb * row_len;
    int4* g = geo + jb * L.kmax;
    int2* e = se + jb * L.kmax;
    int cnt = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const bool v = k < K && row[2 * K + k] != 0;
      const unsigned ball = __ballot_sync(FULL, v);
      if (v) {
        const int pos = cnt + __popc(ball & ((1u << lane) - 1u));
        e[pos] = make_int2(row[k], row[K + k]);
        g[pos] = make_int4(row[3 * K + k], row[4 * K + k], row[5 * K + k],
                           row[6 * K + k] != 0);
      }
      cnt += __popc(ball);
    }
    if (lane == 0) nvs[jb] = cnt;
  }
}

// Helpers: chunk flags of buffer `buf` (blocks [b0, b0 + n_blk), n_blk
// <= 32) to the slot-major outputs, a warp a slot row at a time, lane j
// block b0 + j (coalesced), four rows in flight.
__device__ void flush_chunk(const Layout& L, const unsigned char* sm,
                            uint8_t* __restrict__ fl, int* __restrict__ pu,
                            int S, int nb, int b0, int n_blk, int buf) {
  const uint8_t* fb = sm + L.fl + buf * L.chunk * L.sp;
  const int* pb = reinterpret_cast<const int*>(sm + L.pu) +
                  buf * L.chunk * L.sp;
  const int* phs = reinterpret_cast<const int*>(sm + L.ph) +
                   buf * 32 * L.spl;
  const size_t sb = static_cast<size_t>(S) * nb;
  const int j = threadIdx.x & 31;
  const int hw = (threadIdx.x >> 5) - 1;
  if (j >= n_blk) return;
  // slots of registers from nrj on were idle in block j: no flag, the
  // phase of the chunk's start
  const int nrj = reinterpret_cast<const int*>(sm + L.nr)[buf * L.chunk + j];
  constexpr int U = 4;
  for (int s0 = hw; s0 < S; s0 += U * HELPERS) {
    int f[U], v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u * HELPERS;
      if (s < S) {
        const bool idle = (s >> 5) >= nrj;
        f[u] = idle ? 0 : fb[j * L.sp + s];
        v[u] = idle ? phs[s] : pb[j * L.sp + s];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u * HELPERS;
      if (s < S) {
        const size_t o = static_cast<size_t>(s) * nb + b0 + j;
        fl[o] = f[u] & 1;
        fl[sb + o] = (f[u] >> 1) & 1;
        fl[2 * sb + o] = f[u] >> 2;
        pu[o] = v[u];
      }
    }
  }
}

// f(std::integral_constant<int, i>) for the registers i < n (n warp-
// uniform, at most N): a compile-time index each, so register arrays stay
// in registers, and one uniform branch a register visited.
template <int I, int N>
struct RegLoop {
  template <class F>
  __device__ __forceinline__ static void run(int n, F& f) {
    if constexpr (I < N) {
      if (I < n) {
        f(std::integral_constant<int, I>{});
        RegLoop<I + 1, N>::run(n, f);
      }
    }
  }
};

template <int N, class F>
__device__ __forceinline__ void for_regs(int n, F&& f) {
  RegLoop<0, N>::run(n, f);
}

// Warp 0, the end of a block: retire (tombstone) the live slots idle past
// the delay, flag the processed ones, advance the phases (POW2: r is a
// power of two, the floor modulo a mask) and write the block's flags and
// phase_used of this lane's registers below nr into the chunk buffers.
// Registers from nr on hold no live or new slot in any lane: they only
// repeat their phase at the chunk's start with no flag, which the flush
// writes.
template <int SPL, bool POW2>
__device__ __forceinline__ void retire(int (&ph)[SPL], const int (&pi)[SPL],
                                       const int (&ina)[SPL], unsigned am,
                                       unsigned& tm, unsigned got,
                                       unsigned mine, int delay, int r,
                                       int rmask, uint8_t* fbj, int* pbj,
                                       int lane, int nr) {
  const unsigned live2 = am & ~tm;
  for_regs<SPL>(nr, [&](auto I) {
    constexpr int i = decltype(I)::value;
    const bool gi = (got >> i) & 1u;
    const bool li = (live2 >> i) & 1u;
    const bool em = li && !gi && ina[i] > delay;
    const bool pr = li && !em;
    tm |= static_cast<unsigned>(em) << i;
    const int pused = gi ? pi[i] : ph[i];
    const int x = gi ? 2 * pi[i] : ph[i] + pi[i];
    const int m = POW2 ? (x & rmask) : mod_pos(x, r);
    ph[i] = (gi || pr) ? m : ph[i];
    if ((mine >> i) & 1u) {
      fbj[i * 32 + lane] =
          static_cast<uint8_t>(gi | (pr << 1) | (em << 2));
      pbj[i * 32 + lane] = pused;
    }
  });
}

template <int SPL>
__global__ void __launch_bounds__(THREADS, 1)
    lifecycle_kernel(SegTab tab, int nb, const int* __restrict__ packs,
                     const int* __restrict__ st_in,
                     const int* __restrict__ ctr_in,
                     int* __restrict__ st_out, int* __restrict__ ctr_out,
                     uint8_t* __restrict__ bflags, int* __restrict__ pu_out,
                     int kmax, int chunk, int smax, PowactArgs pa) {
  extern __shared__ int4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  if (blockIdx.x == tab.n) {  // the burst chain, a warp per channel
    const int w = threadIdx.x >> 5;
    for (int c = w; c < pa.n_chan; c += blockDim.x >> 5)
      powact_channel(pa, c, sm + w * POWACT_STAGE_BYTES);
    return;
  }
  const Layout L = layout(chunk, kmax, smax, SPL);

  const int g = blockIdx.x;
  const int K = tab.k[g];
  const int S = tab.s[g];
  const int* pack = packs + tab.pack_off[g];
  uint8_t* fl = bflags + tab.flag_off[g];
  int* pu = pu_out + tab.pu_off[g];
  const int n_ch = (nb + chunk - 1) / chunk;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x >= 32) {  // the helpers
    if (nb > 0) build_chunk(L, sm, pack, K, 0, min(chunk, nb), 0);
    chunk_sync();
    for (int c = 0; c < n_ch; ++c) {
      if (c + 1 < n_ch) {
        const int b1 = (c + 1) * chunk;
        build_chunk(L, sm, pack, K, b1, min(chunk, nb - b1), (c + 1) & 1);
      }
      if (c >= 1) {
        const int bp = (c - 1) * chunk;
        flush_chunk(L, sm, fl, pu, S, nb, bp, min(chunk, nb - bp),
                    (c - 1) & 1);
      }
      chunk_sync();
    }
    if (n_ch > 0) {
      const int bp = (n_ch - 1) * chunk;
      flush_chunk(L, sm, fl, pu, S, nb, bp, nb - bp, (n_ch - 1) & 1);
    }
    return;
  }

  // warp 0: the chain. Slot i * 32 + lane is this lane's register i.
  const int r = tab.r[g];
  const int rmask = (r > 0 && (r & (r - 1)) == 0) ? r - 1 : -1;
  const int delay = tab.delay[g];
  int* xs_sm = reinterpret_cast<int*>(sm + L.xs);
  int* wl_sm = reinterpret_cast<int*>(sm + L.wl);
  int* newl = reinterpret_cast<int*>(sm + L.newl);
  const int* st0 = st_in + tab.state_off[g];
  unsigned am = 0, tm = 0, mine = 0;  // active, tomb, slot < S: bit i
  int ds[SPL], de[SPL], ph[SPL], pi[SPL], ina[SPL], ord[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int s = i * 32 + lane;
    ds[i] = de[i] = ph[i] = pi[i] = ina[i] = ord[i] = 0;
    if (s < S) {
      mine |= 1u << i;
      am |= (st0[0 * S + s] != 0 ? 1u : 0u) << i;
      tm |= (st0[1 * S + s] != 0 ? 1u : 0u) << i;
      ds[i] = st0[2 * S + s];
      de[i] = st0[3 * S + s];
      xs_sm[s] = st0[4 * S + s];
      wl_sm[s] = st0[5 * S + s];
      ph[i] = st0[6 * S + s];
      pi[i] = st0[7 * S + s];
      ina[i] = st0[8 * S + s];
      ord[i] = st0[9 * S + s];
    }
  }
  int alloc = ctr_in[2 * g];
  int dropped = ctr_in[2 * g + 1];
  const unsigned lt = (1u << lane) - 1u;
  chunk_sync();  // chunk 0's lists are built

  for (int c = 0; c < n_ch; ++c) {
    const int buf = c & 1;
    const int n_blk = min(chunk, nb - c * chunk);
    const int4* geo =
        reinterpret_cast<const int4*>(sm + L.geo) + buf * chunk * kmax;
    const int2* se =
        reinterpret_cast<const int2*>(sm + L.se) + buf * chunk * kmax;
    const int* nvs = reinterpret_cast<const int*>(sm + L.nv) + buf * chunk;
    uint8_t* fb = sm + L.fl + buf * chunk * L.sp;
    int* pb = reinterpret_cast<int*>(sm + L.pu) + buf * chunk * L.sp;
    // registers up to the last with a live slot in some lane (warp-
    // uniform): allocation takes the lowest free slots, so the live ones
    // gather in the first registers (S = 512 is 16 registers a lane; the
    // paths keep at most a few dozen slots live). An upper bound: raised
    // by allocation, recomputed here.
    int nr = SPL == 1 ? 1 : 32 - __clz(__reduce_or_sync(FULL, am & ~tm));
    int* nrb = reinterpret_cast<int*>(sm + L.nr) + buf * chunk;
    int* phb = reinterpret_cast<int*>(sm + L.ph) + buf * 32 * SPL;
#pragma unroll
    for (int i = 0; i < SPL; ++i) phb[i * 32 + lane] = ph[i];
    int nv_next = nvs[0];
    int2 c0_next = se[0];
    for (int j = 0; j < n_blk; ++j) {
      // the count and first candidate, loaded a block ahead
      const int nv = nv_next;
      const int2 c0 = c0_next;
      if (j + 1 < n_blk) {
        nv_next = nvs[j + 1];
        c0_next = se[(j + 1) * kmax];
      }
      const unsigned live = am & ~tm;
      unsigned got = 0;
      if (nv > 0) {
        const int2* e = se + j * kmax;
        const int4* gg = geo + j * kmax;
        // 1. match: each valid candidate goes to its earliest-activated
        //    overlapping live slot, ties to the lower slot
        unsigned ref = 0;
        int n_new = 0, n_big = 0;
        int2 cse_next = c0;
        for (int q = 0; q < nv; ++q) {
          const int2 cse = cse_next;
          if (q + 1 < nv) cse_next = e[q + 1];
          unsigned hm = 0;  // this lane's live slots that overlap
          for_regs<SPL>(nr, [&](auto I) {
            constexpr int i = decltype(I)::value;
            hm |= static_cast<unsigned>((cse.x < de[i]) & (cse.y >= ds[i]))
                  << i;
          });
          hm &= live;
          const unsigned hits = __ballot_sync(FULL, hm != 0);
          const bool multi =
              SPL > 1 && __any_sync(FULL, (hm & (hm - 1)) != 0);
          if (hits && !(hits & (hits - 1)) && !multi) {
            ref |= hm;  // one slot overlaps: it consumes the candidate
          } else if (hits) {
            // this lane's earliest (order, slot), then the warp's: the
            // earliest order, and among the lanes holding it (one, unless
            // two slots share an order) the lowest slot
            unsigned best = NONE;
            int bi = 0;
            bool found = false;
            for_regs<SPL>(nr, [&](auto I) {
              constexpr int i = decltype(I)::value;
              const unsigned key =
                  static_cast<unsigned>(ord[i]) ^ 0x80000000u;
              const bool take = ((hm >> i) & 1u) && (!found || key < best);
              best = take ? key : best;
              bi = take ? i : bi;
              found |= take;
            });
            const bool has = hm != 0;  // (a key may equal NONE itself)
            const unsigned m = __reduce_min_sync(FULL, has ? best : NONE);
            const bool at = has && best == m;
            const unsigned atb = __ballot_sync(FULL, at);
            if (!(atb & (atb - 1))) {
              if (at) ref |= 1u << bi;
            } else {
              const unsigned slot = __reduce_min_sync(
                  FULL, at ? (static_cast<unsigned>(bi) << 5 | lane) : NONE);
              if (lane == static_cast<int>(slot & 31))
                ref |= 1u << (slot >> 5);
            }
          } else if (gg[q].w) {
            ++n_big;
          } else {
            if (lane == 0) newl[n_new] = q;
            ++n_new;
          }
        }
        for_regs<SPL>(nr, [&](auto I) {
          constexpr int i = decltype(I)::value;
          ina[i] = ((live >> i) & 1u) ? (((ref >> i) & 1u) ? 0 : ina[i] + 1)
                                      : ina[i];
        });

        // 2. allocate free slots in index order to the new candidates in
        //    acceptance order: the free slot of rank k takes the k-th
        int n_free = 0;
        if (n_new > 0) {
          __syncwarp();  // newl written by lane 0
          const unsigned fr = ~am & ~tm & mine;
#pragma unroll
          for (int i = 0; i < SPL; ++i) {
            if (n_free >= n_new) break;
            const bool f = (fr >> i) & 1u;
            const unsigned ball = __ballot_sync(FULL, f);
            const int rank = n_free + __popc(ball & lt);
            if (f && rank < n_new) {
              const int q = newl[rank];
              const int2 cse = e[q];
              const int4 cg = gg[q];
              const int s = i * 32 + lane;
              got |= 1u << i;
              ds[i] = cse.x;
              de[i] = cse.y;
              wl_sm[s] = cg.x;
              xs_sm[s] = cg.y;
              pi[i] = cg.z;
              ina[i] = 0;
              ord[i] = alloc + rank;
            }
            if (ball && n_free < n_new) nr = max(nr, i + 1);
            n_free += __popc(ball);
          }
          __syncwarp();  // newl is rewritten by the next busy block
        }
        const int n_alloc = min(n_new, n_free);
        dropped += (n_new - n_alloc) + n_big;
        alloc += n_alloc;
        am |= got;
      } else {
        for_regs<SPL>(nr, [&](auto I) {
          constexpr int i = decltype(I)::value;
          ina[i] += (live >> i) & 1u;  // nothing matches
        });
      }

      // 3. retire / process flags and phase bookkeeping
      if (lane == 0) nrb[j] = nr;
      uint8_t* fbj = fb + j * L.sp;
      int* pbj = pb + j * L.sp;
      if (rmask >= 0) {
        retire<SPL, true>(ph, pi, ina, am, tm, got, mine, delay, r, rmask,
                          fbj, pbj, lane, nr);
      } else {
        retire<SPL, false>(ph, pi, ina, am, tm, got, mine, delay, r, rmask,
                           fbj, pbj, lane, nr);
      }
    }
    chunk_sync();  // chunk c's flags are flushed, chunk c + 1 built
  }

  // free the tombstones at step end
  am &= ~tm;
  __syncwarp();
  int* so = st_out + tab.state_off[g];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int s = i * 32 + lane;
    if (s < S) {
      so[0 * S + s] = (am >> i) & 1u;
      so[1 * S + s] = 0;
      so[2 * S + s] = ds[i];
      so[3 * S + s] = de[i];
      so[4 * S + s] = xs_sm[s];
      so[5 * S + s] = wl_sm[s];
      so[6 * S + s] = ph[i];
      so[7 * S + s] = pi[i];
      so[8 * S + s] = ina[i];
      so[9 * S + s] = ord[i];
    }
  }
  if (lane == 0) {
    ctr_out[2 * g] = alloc;
    ctr_out[2 * g + 1] = dropped;
  }
}

template <int SPL>
int launch(const SegTab& tab, int blocks, int nb, const void* packs,
           const void* state_in, const void* ctr_in, void* state_out,
           void* ctr_out, void* bflags, void* pu, int kmax, int smax,
           const PowactArgs& pa, cudaStream_t st) {
  // chunk buffers within SMEM_BUDGET: the layout grows linearly in the
  // chunk, so its size at 1 and 2 blocks gives the per-block bytes
  const int fixed = layout(0, kmax, smax, SPL).total;
  const int per = layout(2, kmax, smax, SPL).total -
                  layout(1, kmax, smax, SPL).total;
  const int chunk = max(1, min(MAX_CHUNK, (SMEM_BUDGET - fixed) / per));
  // the burst block stages its warps' flags in the same buffer
  const int bytes =
      max(layout(chunk, kmax, smax, SPL).total,
          pa.n_chan > 0 ? (THREADS / 32) * POWACT_STAGE_BYTES : 0);
  auto* kern = lifecycle_kernel<SPL>;
  // the size varies with the call: opt in once to the most a block may
  // use, which bounds the launch's own size
  static bool done[64] = {};
  const cudaError_t err =
      bytes > 48 * 1024 ? allow_smem(kern, MAX_SMEM, done) : cudaSuccess;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<blocks, THREADS, bytes, st>>>(
      tab, nb, static_cast<const int*>(packs),
      static_cast<const int*>(state_in), static_cast<const int*>(ctr_in),
      static_cast<int*>(state_out), static_cast<int*>(ctr_out),
      static_cast<uint8_t*>(bflags), static_cast<int*>(pu), kmax, chunk,
      smax, pa);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// seg_tab: HOST int32 [n_seg, 8] rows (k, r, delay, s, pack_off,
// state_off, flag_off, pu_off). Segment buffers are flat concatenations
// at those offsets; counters are int32 [n_seg, 2] (alloc_counter,
// dropped). The pa_* arguments are those of fdc_powact (powact.cu);
// n_pa == 0 runs no burst chain. Slots and candidate columns: 1 ... 1024
// a segment.
extern "C" int fdc_slot_lifecycle(
    int n_seg, const void* seg_tab, int nb, const void* packs,
    const void* state_in, const void* ctr_in, void* state_out, void* ctr_out,
    void* bflags, void* pu, int kmax, int n_pa, const void* pa_powers,
    const void* pa_lastpower, const void* pa_active, const void* pa_phase,
    const void* pa_delta, float pa_thresh, int pa_r, void* pa_rise,
    void* pa_fall, void* pa_processed, void* pa_phase_used,
    void* pa_active_out, void* pa_phase_out, void* pa_lastpower_out,
    void* stream) {
  PowactArgs pa;
  if (n_seg < 1 || n_seg > MAXG || kmax < 1 || kmax > 1024 ||
      !powact_args(&pa, pa_powers, nb, n_pa, pa_lastpower, pa_active,
                   pa_phase, pa_delta, pa_thresh, pa_r, pa_rise, pa_fall,
                   pa_processed, pa_phase_used, pa_active_out, pa_phase_out,
                   pa_lastpower_out))
    return static_cast<int>(cudaErrorInvalidValue);
  SegTab tab{};
  tab.n = n_seg;
  int smax = 1;
  const int* st = static_cast<const int*>(seg_tab);
  for (int g = 0; g < n_seg; ++g) {
    const int* row = st + 8 * g;
    tab.k[g] = row[0];
    tab.r[g] = row[1];
    tab.delay[g] = row[2];
    tab.s[g] = row[3];
    tab.pack_off[g] = row[4];
    tab.state_off[g] = row[5];
    tab.flag_off[g] = row[6];
    tab.pu_off[g] = row[7];
    if (row[0] < 1 || row[0] > kmax || row[3] < 1 || row[3] > 1024)
      return static_cast<int>(cudaErrorInvalidValue);
    smax = max(smax, row[3]);
  }
  const int blocks = n_seg + (n_pa > 0 ? 1 : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int need = (smax + 31) / 32;  // slots a lane, then a power of two
#define FDC_LAUNCH(SPL)                                                     \
  return launch<SPL>(tab, blocks, nb, packs, state_in, ctr_in, state_out,   \
                     ctr_out, bflags, pu, kmax, smax, pa, s)
  if (need <= 1) FDC_LAUNCH(1);
  if (need <= 2) FDC_LAUNCH(2);
  if (need <= 4) FDC_LAUNCH(4);
  if (need <= 8) FDC_LAUNCH(8);
  if (need <= 16) FDC_LAUNCH(16);
  FDC_LAUNCH(32);
#undef FDC_LAUNCH
}
