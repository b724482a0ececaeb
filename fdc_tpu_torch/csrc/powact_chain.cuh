// The burst hysteresis chain of one channel, walked by one warp as a
// scan: the one CUDA form of PowerActivationBank.scan_flags
// (fdc_tpu/models/power_activation.py:184-212). Kernel D (powact.cu) runs
// it for a burst bank alone, kernel C (lifecycle.cu) beside the segments;
// both are held bit-exactly to ops/powact.py's plain version.
//
// Per block b, with lastpower the previous block's power (the carried one
// entering block 0):
//
//   rise = !active && pwr / lastpower >= thr
//   fall =  active && lastpower / pwr >= thr
//   processed = rise || active;  phase_used = rise ? delta : phase
//   phase = rise ? 2 delta % R : processed ? (phase + delta) % R : phase
//   active = (active || rise) && !fall
//
// Flags are bit-exact: the ratios are IEEE fp32 divisions, as on the host
// (no source including this may be built with fast math or use
// __fdividef), and the threshold arrives already rounded to fp32.
//
// What bounds it on the H100: latency. The bytes are tiny (BASELINE
// config 3: [512, 32] powers in, four [32, 512] flag planes out, ~0.2 MB,
// 0.06 us at 3.35 TB/s), and walked block by block every block depends on
// the one before: 512 dependent steps.
//
// What the design does about it: the chain's state is (active, phase mod
// R), and lastpower is the previous block's power whatever the state, so
// the two ratio bits up = pwr / lastpower >= thr and dn = lastpower / pwr
// >= thr are data alone, and one block acts on the state as a map of a
// closed form: from active 0, up ? (1, set 2 delta) : (0, keep); from
// active 1, (!dn, add delta). The phase operations {keep, add k, set c}
// are closed under composition (set after anything is set; add k after
// add j is add j + k; add k after set c is set c + k), so a map is two
// (bit, operation) entries and maps compose associatively. A super-chunk
// of up to 32 x LMAX blocks then takes three short passes instead of a
// chain over its blocks: each lane composes the maps of its own
// contiguous run of ceil(n / 32) blocks (reading its powers, the ratio
// bits kept as two bit masks), a warp inclusive scan of the lanes' maps
// (5 shuffle steps) gives every lane the state entering its run, and
// each lane replays its run to produce the flags, staged in shared memory
// and stored by the warp row by row, coalesced. About 16 + 5 + 16
// dependent steps at B = 512 against 512. R is a power of two (the
// configuration rounds relinvovl up to one), so every modulo is a mask.
// The TPU kernel's closed-form quiet chunks were a TPU device and are not
// reproduced.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

struct PowactArgs {
  const float* powers;     // [nb, n_chan]
  int nb;
  int n_chan;
  const float* lastpower;  // [n_chan]
  const uint8_t* active;   // [n_chan] bool
  const int* phase;        // [n_chan]
  const int* delta;        // [n_chan]
  float thresh;            // linear, rounded to fp32
  int r_mask;              // relinvovl - 1, relinvovl a power of two
  uint8_t* rise;           // [n_chan, nb] bool
  uint8_t* fall;           // [n_chan, nb] bool
  uint8_t* processed;      // [n_chan, nb] bool
  int* phase_used;         // [n_chan, nb]
  uint8_t* active_out;     // [n_chan] bool
  int* phase_out;          // [n_chan]
  float* lastpower_out;    // [n_chan]
};

namespace powact_scan {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LMAX = 16;          // blocks a lane's run
constexpr int SC = 32 * LMAX;     // blocks a super-chunk
// An operation entry: the active bit it leads to (OUT), the phase
// operation (SET c, ADD k, or neither: keep) and its value c or k < R.
constexpr unsigned OUT = 1u << 31, SET = 1u << 30, ADD = 1u << 29;
constexpr unsigned VAL = ADD - 1u;

}  // namespace powact_scan

// a warp's staging: rise / fall / processed bytes, then phase_used ints,
// one super-chunk's blocks each
constexpr int POWACT_STAGE_BYTES = 7 * powact_scan::SC;

// A block's map (or a run's): m[a] is the entry taken from active a.
struct BurstMap {
  unsigned m0, m1;
};

// op2 after op1; the result leads where op2 does
__device__ __forceinline__ unsigned compose_op(unsigned e2, unsigned e1,
                                               int r_mask) {
  using namespace powact_scan;
  if (e2 & SET) return e2;
  if (!(e2 & ADD)) return (e2 & OUT) | (e1 & ~OUT);  // keep: op1's
  if (!(e1 & (SET | ADD))) return e2;                // add after keep
  return (e2 & OUT) | (e1 & (SET | ADD)) | ((e1 + e2) & r_mask);
}

// the map g after f (f's block first)
__device__ __forceinline__ BurstMap compose(const BurstMap& g,
                                            const BurstMap& f, int r_mask) {
  using namespace powact_scan;
  return {compose_op((f.m0 & OUT) ? g.m1 : g.m0, f.m0, r_mask),
          compose_op((f.m1 & OUT) ? g.m1 : g.m0, f.m1, r_mask)};
}

// one block's map from its ratio bits; dm = delta mod R, d2 = 2 delta
// mod R
__device__ __forceinline__ BurstMap block_map(bool up, bool dn, int dm,
                                              int d2) {
  using namespace powact_scan;
  return {up ? (OUT | SET | static_cast<unsigned>(d2)) : 0u,
          (dn ? 0u : OUT) | ADD | static_cast<unsigned>(dm)};
}

// the state (a, ph) after a map
__device__ __forceinline__ void apply(const BurstMap& m, bool& a, int& ph,
                                      int r_mask) {
  using namespace powact_scan;
  const unsigned e = a ? m.m1 : m.m0;
  a = (e & OUT) != 0u;
  const int v = static_cast<int>(e & VAL);
  ph = (e & SET) ? v : (e & ADD) ? (ph + v) & r_mask : ph;
}

// Channel c's chain over the nb blocks; called by all 32 lanes of a warp,
// `stage` its POWACT_STAGE_BYTES of shared memory.
__device__ __forceinline__ void powact_channel(const PowactArgs& pa, int c,
                                               unsigned char* stage) {
  using namespace powact_scan;
  const int lane = threadIdx.x & 31;
  const int nb = pa.nb;
  const int nc = pa.n_chan;
  const int rm = pa.r_mask;
  const int d = pa.delta[c];
  // floor moduli by the power of two R, as jnp / torch %
  const int dm = d & rm;
  const int d2 = (2 * d) & rm;
  bool a = pa.active[c] != 0;  // the state entering the super-chunk
  int ph = pa.phase[c];
  const float* col = pa.powers + c;  // block b at col[b * nc]
  uint8_t* f_st = stage;             // [3][SC] rise, fall, processed
  int* pu_st = reinterpret_cast<int*>(stage + 3 * SC);
  const size_t row = static_cast<size_t>(c) * nb;
  for (int base = 0; base < nb; base += SC) {
    const int n = min(SC, nb - base);
    const int len = (n + 31) / 32;
    // the lane's run: blocks j0 ... j0 + nl - 1 of the super-chunk
    const int j0 = lane * len;
    const int nl = max(0, min(len, n - j0));
    // 1. the run's ratio bits and map (its powers loaded first, all in
    // flight at once)
    const int b0 = base + j0;
    float pw[LMAX];
#pragma unroll
    for (int t = 0; t < LMAX; ++t)
      pw[t] = t < nl ? col[static_cast<size_t>(b0 + t) * nc] : 1.0f;
    float prev = nl == 0   ? 1.0f
                 : b0 == 0 ? pa.lastpower[c]
                           : col[static_cast<size_t>(b0 - 1) * nc];
    unsigned up = 0u, dn = 0u;
    BurstMap m = {0u, OUT};  // identity: keep, active unchanged
#pragma unroll
    for (int t = 0; t < LMAX; ++t) {
      if (t < nl) {
        const bool u = __fdiv_rn(pw[t], prev) >= pa.thresh;
        const bool w = __fdiv_rn(prev, pw[t]) >= pa.thresh;
        up |= static_cast<unsigned>(u) << t;
        dn |= static_cast<unsigned>(w) << t;
        m = compose(block_map(u, w, dm, d2), m, rm);
        prev = pw[t];
      }
    }
    // 2. inclusive scan of the runs' maps: lane l's covers runs 0 ... l
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const BurstMap o = {__shfl_up_sync(FULL, m.m0, off),
                          __shfl_up_sync(FULL, m.m1, off)};
      if (lane >= off) m = compose(m, o, rm);
    }
    // the state after this lane's run; the one entering it is the
    // previous lane's (the super-chunk's own for lane 0)
    bool a_out = a;
    int ph_out = ph;
    apply(m, a_out, ph_out, rm);
    const bool a_prev =
        __shfl_up_sync(FULL, static_cast<int>(a_out), 1) != 0;
    const int ph_prev = __shfl_up_sync(FULL, ph_out, 1);
    bool ar = lane == 0 ? a : a_prev;
    int pr = lane == 0 ? ph : ph_prev;
    // 3. replay the run into the staging
#pragma unroll
    for (int t = 0; t < LMAX; ++t) {
      if (t < nl) {
        const bool rise = !ar && ((up >> t) & 1u);
        const bool fall = ar && ((dn >> t) & 1u);
        const bool proc = rise || ar;
        pu_st[j0 + t] = rise ? d : pr;
        pr = rise ? d2 : (proc ? (pr + d) & rm : pr);
        ar = (ar || rise) && !fall;
        f_st[j0 + t] = rise;
        f_st[SC + j0 + t] = fall;
        f_st[2 * SC + j0 + t] = proc;
      }
    }
    a = __shfl_sync(FULL, static_cast<int>(a_out), 31) != 0;
    ph = __shfl_sync(FULL, ph_out, 31);
    __syncwarp();
    // 4. the super-chunk's flags, row by row, coalesced
    for (int i = lane; i < n; i += 32) {
      const size_t o = row + base + i;
      pa.rise[o] = f_st[i];
      pa.fall[o] = f_st[SC + i];
      pa.processed[o] = f_st[2 * SC + i];
      pa.phase_used[o] = pu_st[i];
    }
    __syncwarp();
  }
  if (lane == 0) {
    pa.active_out[c] = a;
    pa.phase_out[c] = ph;
    pa.lastpower_out[c] = col[static_cast<size_t>(nb - 1) * nc];
  }
}

// PowactArgs from the C entry points' arguments; false unless r is a
// power of two.
inline bool powact_args(PowactArgs* pa, const void* powers, int nb,
                        int n_chan, const void* lastpower, const void* active,
                        const void* phase, const void* delta, float thresh,
                        int r, void* rise, void* fall, void* processed,
                        void* phase_used, void* active_out, void* phase_out,
                        void* lastpower_out) {
  if (r < 1 || (r & (r - 1)) != 0) return false;
  pa->powers = static_cast<const float*>(powers);
  pa->nb = nb;
  pa->n_chan = n_chan;
  pa->lastpower = static_cast<const float*>(lastpower);
  pa->active = static_cast<const uint8_t*>(active);
  pa->phase = static_cast<const int*>(phase);
  pa->delta = static_cast<const int*>(delta);
  pa->thresh = thresh;
  pa->r_mask = r - 1;
  pa->rise = static_cast<uint8_t*>(rise);
  pa->fall = static_cast<uint8_t*>(fall);
  pa->processed = static_cast<uint8_t*>(processed);
  pa->phase_used = static_cast<int*>(phase_used);
  pa->active_out = static_cast<uint8_t*>(active_out);
  pa->phase_out = static_cast<int*>(phase_out);
  pa->lastpower_out = static_cast<float*>(lastpower_out);
  return true;
}
