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
// its time is the number of steps times the latency of each (memory
// loads, barriers, shared-memory round trips), not its arithmetic.
//
// What the design does about it: one CUDA block per segment, one thread
// per slot (S <= 1024), the B-block loop serial inside the block. Device
// memory stays off the serial chain: the candidate rows of up to 32
// blocks are staged in shared memory with 16-byte loads, many in flight,
// and the chunk's flags collect in shared memory and leave in coalesced
// stores. A block without candidates only ages the live slots
// (thread-local, no barrier). On a block with candidates the
// earliest-order match is a shared-memory atomicMin keyed by (order,
// slot) — ties go to the lower slot, as argmin — and then every thread
// walks the K candidates itself for its refresh, the candidate ranks and
// its own allocation; the free-slot rank is a warp ballot. With S <= 32
// the block is one warp and its barriers are warp barriers. One extra
// block runs the burst chain, a warp per channel with lane j holding
// block j of each 32 (coalesced loads and stores). All segments and the
// burst bank share one launch. The candidate geometry arrives
// precomputed in the pack (it is slot-table independent). The TPU
// kernel's tier ladders, chunk closed forms, gap prefilter and [1, S] row
// layout were TPU devices and are not reproduced.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int MAXG = 32;
constexpr unsigned long long NONE = ~0ull;

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

struct PaArgs {
  int c;
  const float* powers;     // [B, C]
  const float* lastpower;  // [C]
  const int* active;       // [C]
  const int* phase;        // [C]
  const int* delta;        // [C]
  float thresh;
  int r;
  int* state_out;          // [2, C]: active, phase
  float* lastpower_out;    // [C]
  uint8_t* bflags;         // [3, C, B]: rise, fall, processed
  int* pu;                 // [C, B] phase_used
};

__device__ __forceinline__ int mod_pos(int x, int r) {
  const int m = x % r;  // floor modulo, as jnp / torch %
  return m < 0 ? m + r : m;
}

// block barrier; a one-warp block (S <= 32, the flagship) needs only
// a warp barrier. blockDim is uniform, so every thread takes one branch.
__device__ __forceinline__ void block_sync() {
  if (blockDim.x == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// rank of this thread among the block's threads with pred set (exclusive)
// and their count (blockDim a multiple of 32)
__device__ int block_rank(bool pred, int* wcount, int* total) {
  const unsigned ball = __ballot_sync(0xffffffffu, pred);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int in_warp = __popc(ball & ((1u << lane) - 1u));
  if (blockDim.x == 32) {
    *total = __popc(ball);
    return in_warp;
  }
  if (lane == 0) wcount[warp] = __popc(ball);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const int n = wcount[w];
    all += n;
    if (w < warp) before += n;
  }
  __syncthreads();
  *total = all;
  return before + in_warp;
}

constexpr int STAGE_UNROLL = 8;  // 16-byte loads in flight per thread

// Copy n ints of device memory into shared memory with many loads in
// flight per thread (a one-warp block would otherwise wait one memory
// latency per element): 16-byte vectors when the source is aligned (dst
// always is), scalars for the rest.
__device__ void stage(int* dst, const int* src, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n / 4;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i0 = threadIdx.x; i0 < n4; i0 += STAGE_UNROLL * blockDim.x) {
      int4 v[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < n4) v[u] = s4[i];
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < n4) d4[i] = v[u];
      }
    }
    done = n4 * 4;
  }
  for (int i0 = done + threadIdx.x; i0 < n; i0 += STAGE_UNROLL * blockDim.x) {
    int v[STAGE_UNROLL];
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) dst[i] = v[u];
    }
  }
}

// The burst chain, one warp per channel. Every lane runs the same serial
// chain; lane j loads the power of block b0 + j and keeps that block's
// results, so loads and stores are one coalesced access per 32 blocks
// instead of one dependent access per block.
__device__ void powact_chain(const PaArgs& pa, int nb) {
  const int lane = threadIdx.x & 31;
  const size_t cb = static_cast<size_t>(pa.c) * nb;
  for (int c = threadIdx.x >> 5; c < pa.c; c += blockDim.x >> 5) {
    bool a = pa.active[c] != 0;
    float lp = pa.lastpower[c];
    int ph = pa.phase[c];
    const int d = pa.delta[c];
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const int bl = b0 + lane;
      const float p_lane =
          bl < nb ? pa.powers[static_cast<size_t>(bl) * pa.c + c] : 1.0f;
      bool rise_l = false, fall_l = false, proc_l = false;
      int pu_l = 0;
      const int n = min(32, nb - b0);
      for (int j = 0; j < n; ++j) {
        const float p = __shfl_sync(0xffffffffu, p_lane, j);
        const bool rise = !a && (p / lp >= pa.thresh);
        const bool fall = a && (lp / p >= pa.thresh);
        const bool proc = rise || a;
        const int pused = rise ? d : ph;
        ph = rise ? mod_pos(2 * d, pa.r) : (proc ? mod_pos(ph + d, pa.r) : ph);
        a = (a || rise) && !fall;
        lp = p;
        if (lane == j) {
          rise_l = rise;
          fall_l = fall;
          proc_l = proc;
          pu_l = pused;
        }
      }
      if (bl < nb) {
        const size_t i = static_cast<size_t>(c) * nb + bl;
        pa.bflags[i] = rise_l;
        pa.bflags[cb + i] = fall_l;
        pa.bflags[2 * cb + i] = proc_l;
        pa.pu[i] = pu_l;
      }
    }
    if (lane == 0) {
      pa.state_out[c] = a;
      pa.state_out[pa.c + c] = ph;
      pa.lastpower_out[c] = lp;
    }
  }
}

__global__ void lifecycle_kernel(SegTab tab, int nb,
                                 const int* __restrict__ packs,
                                 const int* __restrict__ st_in,
                                 const int* __restrict__ ctr_in,
                                 int* __restrict__ st_out,
                                 int* __restrict__ ctr_out,
                                 uint8_t* __restrict__ bflags,
                                 int* __restrict__ pu_out, int kmax,
                                 int chunk_blocks, PaArgs pa) {
  if (blockIdx.x == tab.n) {
    powact_chain(pa, nb);
    return;
  }
  extern __shared__ unsigned long long smem[];
  unsigned long long* firstkey = smem;  // [kmax] earliest (order, slot)
  // [chunk, 7 * kmax], 16-byte aligned for stage()
  int* chunk = reinterpret_cast<int*>(smem + (kmax + 1) / 2 * 2);
  int* busy = chunk + chunk_blocks * 7 * kmax;  // [chunk] any candidate
  int* wcount = busy + chunk_blocks;            // [32]
  int* pu_buf = wcount + 32;                    // [threads, chunk]
  uint8_t* fl_buf = reinterpret_cast<uint8_t*>(
      pu_buf + blockDim.x * chunk_blocks);      // [3, threads, chunk]
  const int fl_stride = blockDim.x * chunk_blocks;

  const int g = blockIdx.x;
  const int K = tab.k[g];
  const int r = tab.r[g];
  const int delay = tab.delay[g];
  const int S = tab.s[g];
  const int s = threadIdx.x;
  const bool mine = s < S;
  const int row_len = 7 * K;

  const int* st0 = st_in + tab.state_off[g];
  int a = 0, t = 0, ds = 0, de = 0, xs = 0, wl = 0, ph = 0, pi = 0,
      ina = 0, ord = 0;
  if (mine) {
    a = st0[0 * S + s] != 0;
    t = st0[1 * S + s] != 0;
    ds = st0[2 * S + s];
    de = st0[3 * S + s];
    xs = st0[4 * S + s];
    wl = st0[5 * S + s];
    ph = st0[6 * S + s];
    pi = st0[7 * S + s];
    ina = st0[8 * S + s];
    ord = st0[9 * S + s];
  }
  int alloc = ctr_in[2 * g];
  int dropped = ctr_in[2 * g + 1];
  const int* pack = packs + tab.pack_off[g];
  uint8_t* fl = bflags + tab.flag_off[g];
  int* pu = pu_out + tab.pu_off[g];
  const size_t sb = static_cast<size_t>(S) * nb;

  for (int b0 = 0; b0 < nb; b0 += chunk_blocks) {
    // stage the chunk's candidate rows in shared memory (one coalesced
    // pass instead of a dependent global load on every serial step)
    const int n_blk = min(chunk_blocks, nb - b0);
    stage(chunk, pack + static_cast<size_t>(b0) * row_len, n_blk * row_len);
    __syncthreads();
    for (int jb = threadIdx.x; jb < n_blk; jb += blockDim.x) {
      const int* cv = chunk + jb * row_len + 2 * K;
      int any = 0;
      for (int k = 0; k < K; ++k) any |= cv[k];
      busy[jb] = any != 0;
    }
    __syncthreads();

    for (int j = 0; j < n_blk; ++j) {
      const bool live = mine && a && !t;
      bool got = false;
      if (busy[j]) {
        const int* cs = chunk + j * row_len;
        const int* ce = cs + K;
        const int* cv = ce + K;
        const int* wl2 = cv + K;
        const int* es = wl2 + K;
        const int* esr = es + K;
        const int* tb = esr + K;
        for (int k = threadIdx.x; k < K; k += blockDim.x) firstkey[k] = NONE;
        block_sync();

        // 1. match: each candidate goes to its earliest-activated
        //    overlapping live slot (overlap test of match_candidates)
        if (live) {
          const unsigned long long key =
              (static_cast<unsigned long long>(static_cast<unsigned>(ord) ^
                                               0x80000000u) << 32) |
              static_cast<unsigned>(s);
#pragma unroll 4
          for (int k = 0; k < K; ++k)
            if (cv[k] && cs[k] < de && ce[k] >= ds)
              atomicMin(&firstkey[k], key);
        }
        block_sync();

        // 2. every thread walks the candidates in acceptance order:
        //    refresh, ranks of the unconsumed ones, drop counts, and the
        //    candidate of this slot if it is the free_rank-th free slot
        const bool fr = mine && !a && !t;
        int n_free;
        const int free_rank = block_rank(fr, wcount, &n_free);
        bool refreshed = false;
        int n_new = 0, n_big = 0, c = -1;
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const unsigned long long fk = firstkey[k];
          if (fk != NONE) {  // consumed by a live slot
            refreshed |= static_cast<unsigned>(fk) == static_cast<unsigned>(s);
            continue;
          }
          if (!cv[k]) continue;
          if (tb[k]) {
            ++n_big;
            continue;
          }
          if (fr && n_new == free_rank) c = k;
          ++n_new;
        }
        if (live) ina = refreshed ? 0 : ina + 1;

        // 3. allocate free slots in index order
        const int n_alloc = min(n_new, n_free);
        dropped += (n_new - n_alloc) + n_big;
        got = c >= 0;
        if (got) {
          a = 1;
          ds = cs[c];
          de = ce[c];
          xs = es[c];
          wl = wl2[c];
          pi = esr[c];
          ina = 0;
          ord = alloc + free_rank;
        }
        alloc += n_alloc;
        block_sync();  // firstkey is reset by the next busy block
      } else if (live) {
        ina += 1;  // no candidate: nothing matches or allocates
      }

      // 4. retire / process flags and phase bookkeeping
      const bool live2 = mine && a && !t;
      const bool emit = live2 && !got && ina > delay;
      if (emit) t = 1;
      const bool proc = live2 && !emit;
      if (mine) {
        const int pused = got ? pi : ph;
        ph = got ? mod_pos(2 * pi, r) : (proc ? mod_pos(ph + pi, r) : ph);
        const int i = s * chunk_blocks + j;
        fl_buf[i] = got;
        fl_buf[fl_stride + i] = proc;
        fl_buf[2 * fl_stride + i] = emit;
        pu_buf[i] = pused;
      }
    }
    __syncthreads();
    // the chunk's flags, slot-major [S, B] rows, in coalesced stores
    for (int i = threadIdx.x; i < S * n_blk; i += blockDim.x) {
      const int sl = i / n_blk;
      const int j = i - sl * n_blk;
      const size_t o = static_cast<size_t>(sl) * nb + b0 + j;
      const int k = sl * chunk_blocks + j;
      fl[o] = fl_buf[k];
      fl[sb + o] = fl_buf[fl_stride + k];
      fl[2 * sb + o] = fl_buf[2 * fl_stride + k];
      pu[o] = pu_buf[k];
    }
  }

  // free the tombstones at step end
  a = a && !t;
  t = 0;
  if (mine) {
    int* so = st_out + tab.state_off[g];
    so[0 * S + s] = a;
    so[1 * S + s] = t;
    so[2 * S + s] = ds;
    so[3 * S + s] = de;
    so[4 * S + s] = xs;
    so[5 * S + s] = wl;
    so[6 * S + s] = ph;
    so[7 * S + s] = pi;
    so[8 * S + s] = ina;
    so[9 * S + s] = ord;
  }
  if (threadIdx.x == 0) {
    ctr_out[2 * g] = alloc;
    ctr_out[2 * g + 1] = dropped;
  }
}

}  // namespace

// seg_tab: HOST int32 [n_seg, 8] rows (k, r, delay, s, pack_off,
// state_off, flag_off, pu_off). Segment buffers are flat concatenations
// at those offsets; counters are int32 [n_seg, 2] (alloc_counter,
// dropped). n_pa == 0 runs no burst chain. threads: a multiple of 32
// >= every segment's slot count.
extern "C" int fdc_slot_lifecycle(
    int n_seg, const void* seg_tab, int nb, const void* packs,
    const void* state_in, const void* ctr_in, void* state_out, void* ctr_out,
    void* bflags, void* pu, int kmax, int n_pa, const void* pa_powers,
    const void* pa_lastpower, const void* pa_active, const void* pa_phase,
    const void* pa_delta, float pa_thresh, int pa_r, void* pa_state_out,
    void* pa_lastpower_out, void* pa_bflags, void* pa_pu, int threads,
    void* stream) {
  if (n_seg > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  SegTab tab{};
  tab.n = n_seg;
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
  }
  PaArgs pa{};
  pa.c = n_pa;
  pa.powers = static_cast<const float*>(pa_powers);
  pa.lastpower = static_cast<const float*>(pa_lastpower);
  pa.active = static_cast<const int*>(pa_active);
  pa.phase = static_cast<const int*>(pa_phase);
  pa.delta = static_cast<const int*>(pa_delta);
  pa.thresh = pa_thresh;
  pa.r = pa_r;
  pa.state_out = static_cast<int*>(pa_state_out);
  pa.lastpower_out = static_cast<float*>(pa_lastpower_out);
  pa.bflags = static_cast<uint8_t*>(pa_bflags);
  pa.pu = static_cast<int*>(pa_pu);
  const int blocks = n_seg + (n_pa > 0 ? 1 : 0);
  // per chunk of blocks: staged candidate rows (7 K ints), a busy flag,
  // and the flag buffers (3 bytes + 1 int per thread), within 44 KB of
  // shared memory (the default limit is 48 KB)
  const int per_block = 7 * 4 * max(kmax, 1) + 4 + 7 * threads;
  const int key_bytes = (kmax + 1) / 2 * 2 * 8;
  const int budget = 44 * 1024 - key_bytes - 32 * 4;
  const int chunk_blocks = max(1, min(32, budget / per_block));
  const size_t smem = static_cast<size_t>(key_bytes) + 32 * 4 +
                      static_cast<size_t>(chunk_blocks) * per_block;
  lifecycle_kernel<<<blocks, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      tab, nb, static_cast<const int*>(packs),
      static_cast<const int*>(state_in), static_cast<const int*>(ctr_in),
      static_cast<int*>(state_out), static_cast<int*>(ctr_out),
      static_cast<uint8_t*>(bflags), static_cast<int*>(pu), kmax,
      chunk_blocks, pa);
  return static_cast<int>(cudaGetLastError());
}
