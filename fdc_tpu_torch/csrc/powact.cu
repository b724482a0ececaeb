// Burst-channel hysteresis automaton (kernel D).
//
// Replaces the Pallas kernel fdc_tpu/ops/lifecycle_pallas.py
// _powact_kernel (powact_flags), which the JAX package runs for a burst
// bank without detection segments (beside segments the chain rides the
// slot-lifecycle launch, lifecycle.cu).
//
// What it computes, what bounds it and the design: powact_chain.cuh, the
// chain this kernel shares with lifecycle.cu (a warp scan over the
// blocks' maps). Here one warp takes each channel, WARPS channels per CUDA
// block, each warp with its own staging in shared memory. On BASELINE
// config 3 the bytes are [512, 32] powers in and four [32, 512] flag
// planes out, ~0.2 MB, 0.06 us at 3.35 TB/s.

#include "powact_chain.cuh"

namespace {

constexpr int WARPS = 4;  // channels per CUDA block

__global__ void __launch_bounds__(WARPS * 32) powact_kernel(PowactArgs pa) {
  __shared__ __align__(16) unsigned char stage[WARPS][POWACT_STAGE_BYTES];
  const int w = threadIdx.x >> 5;
  const int c = blockIdx.x * WARPS + w;
  if (c < pa.n_chan) powact_channel(pa, c, stage[w]);  // a warp a channel
}

}  // namespace

// powers: float32 [nb, n_chan]; lastpower float32 / active bool(uint8) /
// phase int32 / delta int32: [n_chan]; thresh: the linear threshold
// rounded to fp32; r: relinvovl, a power of two. Outputs: rise / fall /
// processed bool [n_chan, nb], phase_used int32 [n_chan, nb], and the new
// active / phase / lastpower [n_chan].
extern "C" int fdc_powact(
    const void* powers, int nb, int n_chan, const void* lastpower,
    const void* active, const void* phase, const void* delta, float thresh,
    int r, void* rise, void* fall, void* processed, void* phase_used,
    void* active_out, void* phase_out, void* lastpower_out, void* stream) {
  PowactArgs pa;
  if (!powact_args(&pa, powers, nb, n_chan, lastpower, active, phase, delta,
                   thresh, r, rise, fall, processed, phase_used, active_out,
                   phase_out, lastpower_out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_chan + WARPS - 1) / WARPS;
  powact_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      pa);
  return static_cast<int>(cudaGetLastError());
}
