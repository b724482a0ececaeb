"""Detection primitives and kernel B (greedy candidate acceptance).

Port of ``fdc_tpu.ops.detect``:

- ``band_power`` / ``cell_power``: in-band and decimated-cell power sums
  (reference: lib/PowerActivationChannel_impl.cc:286-306,
  lib/SegmentDetection_impl.cc:178-193);
- ``detect_edges``: strength-ordered rising/falling edge pairing
  (reference: lib/SegmentDetection_impl.cc:195-230);
- ``greedy_accept_batch`` (kernel B, ``csrc/greedy_accept.cu``, replacing
  the Pallas ``_greedy_accept_kernel``) and ``detect_candidates_batch``;
- ``candidate_geometry`` (reference: lib/SegmentDetection_impl.cc:290-344)
  and ``match_candidates`` (reference: lib/SegmentDetection_impl.cc:246-288).

Integer results are computed with integer ops (sort, cumsum, gather);
the JAX package's f32 one-hot matmuls were TPU devices for the same exact
values.
"""

from __future__ import annotations

import numpy as np
import torch

from fdc_tpu_torch import kernels

__all__ = [
    "band_power",
    "cell_power",
    "detect_edges",
    "greedy_accept_batch",
    "greedy_accept_batch_plain",
    "detect_candidates_batch",
    "candidate_geometry",
    "match_candidates",
    "ceil_log2",
]

_BIG = 2**30
_FLT_MIN = float(np.float32(1.1754944e-38))


def band_power(spectrum_sq: torch.Tensor, band_masks: torch.Tensor):
    """[B, N] |X|^2 x [N, C] 0/1 masks -> [B, C] per-band powers."""
    return torch.matmul(spectrum_sq, band_masks)


def cell_power(spectrum_sq: torch.Tensor, start: int, n_cells: int,
               decimation: int) -> torch.Tensor:
    """[B, N] |X|^2 -> [B, n_cells], cell i = sum of bins
    [start + i*dec, start + (i+1)*dec)."""
    seg = spectrum_sq[:, start:start + n_cells * decimation]
    return seg.reshape(spectrum_sq.shape[0], n_cells, decimation).sum(-1)


def ceil_log2(v: torch.Tensor, max_log2: int) -> torch.Tensor:
    """ceil(log2(v)) for positive int32 v: counts powers of two below v."""
    acc = torch.zeros_like(v)
    for j in range(max_log2 + 1):
        acc = acc + (v > (1 << j)).to(v.dtype)
    return acc


def detect_edges(power: torch.Tensor, thresh: float, max_candidates: int,
                 zero_floor: bool = False):
    """[B, n_cells] powers -> (cand_s, cand_e, has_pair), each [B, K]:
    rising edges strongest first (ties to the lower index), each paired
    with the nearest following falling edge, in CELL coordinates. No
    greedy overlap rejection here (see :func:`detect_candidates_batch`).
    An infinite ratio next to a zero cell is a valid (strongest) rise.
    ``zero_floor`` (the multi-segment block, reference:
    lib/activity_detection_channelizer_vcm_impl.cc:701-705) divides by
    FLT_MIN where the denominator is zero, so 0/0 is a falling edge
    rather than NaN."""
    b, n_cells = power.shape
    n_r = n_cells - 1
    k = max_candidates
    k_eff = min(k, n_r)
    den = power[:, :-1]
    if zero_floor:
        den = torch.where(den == 0.0, _FLT_MIN, den)
    # python-float scalars compare in the tensor's fp32 (exact casts of
    # the f32-rounded thresholds, as jnp's weak-typed scalars)
    ratio = power[:, 1:] / den  # [B, n_r]
    rise = ratio > float(np.float32(thresh))
    fall = ratio < float(np.float32(1.0 / thresh))
    idx = torch.arange(n_r, dtype=torch.int32, device=power.device)
    fall_idx = torch.where(fall, idx, _BIG)
    # nearest fall at or after each position: reversed cumulative min
    next_fall = torch.flip(
        torch.cummin(torch.flip(fall_idx, dims=[1]), dim=1).values, dims=[1]
    )
    strength = torch.where(rise, ratio, -torch.inf)
    # stable descending sort == lax.top_k's order (ties by lower index)
    order = torch.sort(strength, dim=1, descending=True, stable=True).indices
    top_i = order[:, :k_eff]
    has_rise = torch.gather(rise, 1, top_i)
    nf = torch.gather(torch.clamp(next_fall, max=n_r), 1, top_i)
    has_pair = has_rise & (nf < n_r)
    cand_s = top_i.to(torch.int32)
    cand_e = (nf + 1).to(torch.int32)
    if k_eff < k:  # pad back to the static candidate count
        pad = (0, k - k_eff)
        cand_s = torch.nn.functional.pad(cand_s, pad)
        cand_e = torch.nn.functional.pad(cand_e, pad)
        has_pair = torch.nn.functional.pad(has_pair, pad)
    return cand_s, cand_e, has_pair


def greedy_accept_batch_plain(cand_s, cand_e, has_pair):
    """Plain PyTorch version of :func:`greedy_accept_batch` (the unrolled
    form of ``fdc_tpu.ops.detect.greedy_accept_batch``)."""
    b, k = cand_s.shape
    ov = (cand_s[:, :, None] < cand_e[:, None, :]) & (
        cand_e[:, :, None] >= cand_s[:, None, :]
    )  # [B, K(j), K(i)]
    acc = torch.zeros((b, k), dtype=torch.bool, device=cand_s.device)
    for j in range(k):
        overlap = torch.any(acc & ov[:, j, :], dim=1)
        acc[:, j] = has_pair[:, j] & ~overlap
    return acc


def greedy_accept_batch(cand_s, cand_e, has_pair):
    """Greedy non-overlap acceptance: [B, K] int32 candidate intervals in
    strength order + [B, K] bool pairing -> [B, K] bool accepted mask
    (candidate j is accepted iff paired and overlapping no earlier
    accepted one, test s_j < e_i && e_j >= s_i). CPU tensors take the
    plain version; CUDA tensors launch kernel B."""
    if cand_s.device.type == "cpu":
        return greedy_accept_batch_plain(cand_s, cand_e, has_pair)
    b, k = cand_s.shape
    if (cand_s.dtype != torch.int32 or cand_e.dtype != torch.int32
            or has_pair.dtype != torch.bool):
        raise TypeError("greedy_accept_batch: int32 intervals and a bool "
                        "pairing mask expected")
    cand_s, cand_e, has_pair = (
        t.contiguous() for t in (cand_s, cand_e, has_pair)
    )
    if cand_e.shape != (b, k) or has_pair.shape != (b, k):
        raise ValueError("greedy_accept_batch: [B, K] inputs expected")
    out = torch.empty((b, k), dtype=torch.bool, device=cand_s.device)
    rc = kernels.library().fdc_greedy_accept(
        cand_s.data_ptr(), cand_e.data_ptr(), has_pair.data_ptr(),
        out.data_ptr(), b, k, kernels.stream_ptr(cand_s.device),
    )
    kernels.check(rc, "fdc_greedy_accept")
    greedy_accept_batch.launches += 1
    return out


greedy_accept_batch.launches = 0


def detect_candidates_batch(power: torch.Tensor, thresh: float,
                            max_candidates: int, zero_floor: bool = False):
    """[B, n_cells] powers -> ([B, K] cand_s, cand_e, valid): the accepted
    candidates in strength order, CELL coordinates, rejected ones 0
    (``zero_floor``: see :func:`detect_edges`)."""
    cand_s, cand_e, has_pair = detect_edges(power, thresh, max_candidates,
                                            zero_floor)
    acc = greedy_accept_batch(cand_s, cand_e, has_pair)
    zero = torch.zeros((), dtype=torch.int32, device=power.device)
    return (
        torch.where(acc, cand_s, zero),
        torch.where(acc, cand_e, zero),
        acc,
    )


def candidate_geometry(cand_s, cand_e, *, puffer: float, w_cap: int,
                       w_cap_log2: int, n: int):
    """New-channel geometry of candidate intervals in bin coordinates
    (elementwise): (wlog2, ext_start, too_big)."""
    det_w = cand_e - cand_s
    grow = float(np.float32(1.0 + 2.0 * puffer))
    ext_w_raw = torch.ceil(det_w.to(torch.float32) * grow).to(torch.int32)
    wl2 = ceil_log2(torch.clamp(ext_w_raw, min=1), w_cap_log2 + 1)
    ext_w = torch.bitwise_left_shift(torch.ones_like(wl2), wl2)
    too_big = ext_w > w_cap
    mid = cand_s + torch.div(det_w, 2, rounding_mode="floor")
    half = torch.div(ext_w, 2, rounding_mode="floor")
    es = mid - half
    ee = mid + half
    neg = es < 0
    es = torch.where(neg, torch.zeros_like(es), es)
    ee = torch.where(neg, ext_w, ee)
    es = torch.where(ee > n, n - ext_w, es)
    return wl2, es, too_big


def match_candidates(cand_start, cand_end, cand_valid, slot_active,
                     slot_det_start, slot_det_stop, slot_order):
    """Candidates vs the live slot table with first-match-consumes
    semantics: a slot is refreshed iff it is some candidate's
    earliest-activated overlapping slot (ties to the lower slot index).
    Returns (refreshed [S] bool, consumed [K] bool)."""
    m = (
        slot_active[:, None]
        & cand_valid[None, :]
        & (cand_start[None, :] < slot_det_stop[:, None])
        & (cand_end[None, :] >= slot_det_start[:, None])
    )  # [S, K]
    big = torch.full_like(slot_order, _BIG)
    order = torch.where(slot_active, slot_order, big)
    order_m = torch.where(m, order[:, None], _BIG)
    first = torch.argmin(order_m, dim=0)  # [K]
    consumed = torch.any(m, dim=0)
    s_idx = torch.arange(slot_active.shape[0], device=slot_active.device)
    refreshed = torch.any(
        m & (first[None, :] == s_idx[:, None]) & consumed[None, :], dim=1
    )
    return refreshed, consumed
