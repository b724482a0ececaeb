"""fft_roofline_pct: the forward FFT's (kernel F, ``csrc/forward_fft.cu``,
and its large-N forms) share of its roofline: the least time the card
could take for the function, [B, N] complex64 blocks to their spectrum,
over the time its kernels took a step in the profiled sub-window.

The function's work: each input read and each output written once
(16 B N bytes) and 5 N log2 N operations a block. Device trace."""

import math

from benchmark import peaks

KERNELS = ("radix_fft", "cluster_fft", "cols_pass", "rows_pass")


def bound_s(b, n, peak):
    return max(16.0 * b * n / peak["bytes_per_s"],
               5.0 * n * math.log2(n) * b / peak["fp32_per_s"])


def read(ctx):
    t, peak = ctx.trace, peaks.of(ctx.device_kind)
    if t is None or peak is None:
        return None
    ks = t.kernels(lambda name: any(k in name for k in KERNELS))
    if len(ks) < t.calls:
        return None
    took = sum(e - s for _, _, s, e in ks) * 1e-6 / t.calls
    cfg = ctx.cfg
    return 100.0 * bound_s(int(cfg["batch_blocks"]), int(cfg["blocksize"]),
                           peak) / took
