"""slot_roofline_pct: the slot transform's (``ops/fft.
interp_subband_ifft_mxu``, one fp32 product a bucket on the library's
GEMM) share of its roofline, over every detection segment's buckets: the
wide one ([extract_budget, B + 1, max_extract_width]) and, with
``extract_width_split``, the narrow one ([extract_budget_narrow, B + 1,
extract_width_split]).

The function's work, not the product's: a W-point inverse DFT of every
row, 5 W log2 W operations, its input read and its output written once
(16 W bytes a row); a faster transform reads against the same bound.
The time: the library's GEMM kernels in the profiled sub-window (the
port's own kernels are named otherwise), a step. Device trace."""

import math
import re

from benchmark import peaks

GEMM = re.compile(r"gemm|gemv|splitK", re.IGNORECASE)


def buckets(cfg):
    """(rows, width) of every slot-transform product a step."""
    b = int(cfg["batch_blocks"])
    slots = int(cfg["max_slots"])
    w_cap = min(int(cfg["max_extract_width"]) or int(cfg["blocksize"]),
                int(cfg["blocksize"]))
    wide = min(int(cfg["extract_budget"]) or slots, slots)
    out = []
    for _ in cfg.get("activity_detection_segments", ()):
        out.append((wide * (b + 1), w_cap))
        if int(cfg.get("extract_width_split", 0)):
            out.append((min(int(cfg["extract_budget_narrow"]), slots)
                        * (b + 1), int(cfg["extract_width_split"])))
    return out


def bound_s(cfg, peak):
    return sum(max(16.0 * rows * w / peak["bytes_per_s"],
                   5.0 * w * math.log2(w) * rows / peak["fp32_per_s"])
               for rows, w in buckets(cfg))


def read(ctx):
    t, peak = ctx.trace, peaks.of(ctx.device_kind)
    if t is None or peak is None or not buckets(ctx.cfg):
        return None
    ks = t.kernels(lambda n: GEMM.search(n) and "gather_gemm" not in n)
    if len(ks) < t.calls * len(buckets(ctx.cfg)):
        return None
    took = sum(e - s for _, _, s, e in ks) * 1e-6 / t.calls
    return 100.0 * bound_s(ctx.cfg, peak) / took
