// The burst hysteresis chain of one channel, walked by one warp: the one
// CUDA form of PowerActivationBank.scan_flags
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
// What bounds it on the H100: latency. Every block depends on the one
// before, and the bytes are tiny. lastpower is always the previous
// block's power whatever the state, so the two ratio tests leave the
// serial chain: lane j divides for block b0 + j (its previous power by
// shuffle), and two ballots turn the 32 outcomes into bit masks. The
// chain itself is then 32 steps of register-only integer logic, which
// every lane runs alike, keeping the results of its own block for one
// coalesced store per plane; R is a power of two (the configuration
// rounds relinvovl up to one), so the phase modulo is a mask, not an
// integer division. The TPU kernel's closed-form quiet chunks were a TPU
// device and are not reproduced.

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

// Channel c's chain over the nb blocks; called by all 32 lanes of a warp.
__device__ __forceinline__ void powact_channel(const PowactArgs& pa, int c) {
  const int lane = threadIdx.x & 31;
  const int nb = pa.nb;
  bool a = pa.active[c] != 0;
  int ph = pa.phase[c];
  const int d = pa.delta[c];
  // floor modulo by the power of two R, as jnp / torch %
  const int d2 = (2 * d) & pa.r_mask;
  float lp = pa.lastpower[c];
  const size_t row = static_cast<size_t>(c) * nb;
  for (int b0 = 0; b0 < nb; b0 += 32) {
    const int bl = b0 + lane;
    const bool in = bl < nb;
    const float p =
        in ? pa.powers[static_cast<size_t>(bl) * pa.n_chan + c] : 1.0f;
    float prev = __shfl_up_sync(0xffffffffu, p, 1);
    if (lane == 0) prev = lp;
    const unsigned up = __ballot_sync(0xffffffffu, in && p / prev >= pa.thresh);
    const unsigned dn = __ballot_sync(0xffffffffu, in && prev / p >= pa.thresh);
    const int n = min(32, nb - b0);
    bool rise_l = false, fall_l = false, proc_l = false;
    int pu_l = 0;
    for (int j = 0; j < n; ++j) {
      const bool rise = !a && ((up >> j) & 1u);
      const bool fall = a && ((dn >> j) & 1u);
      const bool proc = rise || a;
      const int pused = rise ? d : ph;
      ph = rise ? d2 : (proc ? (ph + d) & pa.r_mask : ph);
      a = (a || rise) && !fall;
      if (lane == j) {
        rise_l = rise;
        fall_l = fall;
        proc_l = proc;
        pu_l = pused;
      }
    }
    if (in) {
      pa.rise[row + bl] = rise_l;
      pa.fall[row + bl] = fall_l;
      pa.processed[row + bl] = proc_l;
      pa.phase_used[row + bl] = pu_l;
    }
    lp = __shfl_sync(0xffffffffu, p, n - 1);
  }
  if (lane == 0) {
    pa.active_out[c] = a;
    pa.phase_out[c] = ph;
    pa.lastpower_out[c] = lp;
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
