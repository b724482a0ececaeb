"""Detection primitives and kernel B (the candidate packs).

Port of ``fdc_tpu.ops.detect``:

- ``band_power`` / ``cell_power``: in-band and decimated-cell power sums
  (reference: lib/PowerActivationChannel_impl.cc:286-306,
  lib/SegmentDetection_impl.cc:178-193);
- ``detect_edges``: strength-ordered rising/falling edge pairing
  (reference: lib/SegmentDetection_impl.cc:195-230);
- ``greedy_accept_batch``: the greedy acceptance alone (the Pallas
  ``_greedy_accept_kernel``'s function, on kernel B's acceptance chain);
- ``candidate_geometry`` (reference: lib/SegmentDetection_impl.cc:290-344)
  and ``match_candidates`` (reference: lib/SegmentDetection_impl.cc:246-288);
- ``candidate_packs`` (kernel B, ``csrc/candidate_packs.cu``, replacing
  ``_greedy_accept_kernel`` and the candidate stage around it): every
  detection segment's cell powers to the [B, 7K] candidate packs kernel C
  reads, in one launch a step.

Integer results are computed with integer ops (sort, cumsum, gather);
the JAX package's f32 one-hot matmuls were TPU devices for the same exact
values.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from fdc_tpu_torch import kernels

__all__ = [
    "PackSpec",
    "band_power",
    "cell_power",
    "detect_edges",
    "greedy_accept_batch",
    "greedy_accept_batch_plain",
    "candidate_packs",
    "candidate_packs_plain",
    "pack_offsets",
    "candidate_geometry",
    "match_candidates",
    "ceil_log2",
]

_BIG = 2**30
_FLT_MIN = float(np.float32(1.1754944e-38))
MAX_PACK_CELLS = 2048    # csrc/candidate_packs.cu MAX_CELLS
_MAX_PACK_SEGMENTS = 32  # csrc/candidate_packs.cu MAXG


class PackSpec(NamedTuple):
    """One detection segment's candidate-pack parameters
    (``SegmentDetector.pack_spec``)."""

    thresh: float     # linear edge threshold, >= 1
    k_detect: int     # rises ranked (lax.top_k's k)
    k_pack: int       # pack columns K
    zero_floor: bool  # FLT_MIN for a zero denominator (vcm)
    start: int        # the segment's first bin
    decimation: int   # bins a cell
    puffer: float     # window flank puffer
    w_cap: int        # widest extraction
    w_cap_log2: int
    n: int            # blocksize
    r: int            # relinvovl


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
    greedy overlap rejection here (see :func:`greedy_accept_batch`).
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
    plain version; CUDA tensors launch kernel B's acceptance chain, which
    takes paired intervals within cells 0 <= s < e < 2048 (a check that
    synchronises: this form is off the step path)."""
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
    bad = has_pair & ((cand_s < 0) | (cand_e <= cand_s)
                      | (cand_e >= MAX_PACK_CELLS))
    if bool(bad.any()):
        raise ValueError(f"greedy_accept_batch: paired intervals must lie "
                         f"in cells 0 <= s < e < {MAX_PACK_CELLS}")
    out = torch.empty((b, k), dtype=torch.bool, device=cand_s.device)
    rc = kernels.library().fdc_greedy_accept(
        cand_s.data_ptr(), cand_e.data_ptr(), has_pair.data_ptr(),
        out.data_ptr(), b, k, kernels.stream_ptr(cand_s.device),
    )
    kernels.check(rc, "fdc_greedy_accept")
    greedy_accept_batch.launches += 1
    return out


greedy_accept_batch.launches = 0


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


def pack_offsets(nb: int, k_packs):
    """Each segment's offset of its [nb, 7K] pack in the flat int32 buffer
    (kernel C's layout, ``ops.lifecycle``), and the buffer's length."""
    offs, total = [], 0
    for k in k_packs:
        offs.append(total)
        total += nb * 7 * k
    return offs, total


def _pack_plain(power, spec: PackSpec):
    """One segment's [B, n_cells] powers -> its [B, 7K] pack (K =
    k_pack): detect_edges, the greedy acceptance, the accepted candidates
    compacted to the front in acceptance order (empty columns 0 before
    the bin conversion), bins and geometry."""
    cand_s, cand_e, has_pair = detect_edges(
        power, spec.thresh, spec.k_detect, spec.zero_floor)
    cand_v = greedy_accept_batch_plain(cand_s, cand_e, has_pair)
    b = power.shape[0]
    kp = spec.k_pack
    rank = torch.cumsum(cand_v.to(torch.int32), 1, dtype=torch.int32) - 1
    # column kp is a discard slot (never hit: at most kp candidates
    # survive the acceptance, SegmentDetector.__init__)
    dest = torch.where(cand_v & (rank < kp), rank, kp).long()
    taken = torch.zeros((3, b, kp + 1), dtype=torch.int32,
                        device=power.device)
    for i, v in enumerate((cand_s, cand_e, cand_v.to(torch.int32))):
        taken[i].scatter_(1, dest, v)
    cand_s = taken[0, :, :kp] * spec.decimation + spec.start  # -> bins
    cand_e = taken[1, :, :kp] * spec.decimation + spec.start
    valid = taken[2, :, :kp]
    wl2, es, too_big = candidate_geometry(
        cand_s, cand_e, puffer=spec.puffer, w_cap=spec.w_cap,
        w_cap_log2=spec.w_cap_log2, n=spec.n,
    )
    return torch.cat(
        [cand_s, cand_e, valid, wl2, es, es % spec.r,
         too_big.to(torch.int32)],
        dim=1,
    )


def _pack_views(flat, nb, specs, offs):
    return [flat.as_strided((nb, 7 * s.k_pack), (7 * s.k_pack, 1), o)
            for o, s in zip(offs, specs)]


def candidate_packs_plain(powers, specs):
    """Plain PyTorch version of :func:`candidate_packs`."""
    nb = powers[0].shape[0]
    offs, total = pack_offsets(nb, [s.k_pack for s in specs])
    flat = torch.empty(total, dtype=torch.int32, device=powers[0].device)
    views = _pack_views(flat, nb, specs, offs)
    for v, p, spec in zip(views, powers, specs):
        v.copy_(_pack_plain(p, spec))
    return views


@functools.lru_cache(maxsize=64)
def _pack_tables(specs, n_cells, nb):
    """The launch's static segment table rows (csrc/candidate_packs.cu
    fdc_candidate_packs): int32 [G, 11] and float32 [G, 3]; the packs'
    offsets and the flat buffer's length."""
    offs, total = pack_offsets(nb, [s.k_pack for s in specs])
    ints = np.array([
        (nc, s.k_detect, s.k_pack, s.start, s.decimation, s.w_cap,
         s.w_cap_log2, s.n, s.r, int(s.zero_floor), o)
        for s, nc, o in zip(specs, n_cells, offs)
    ], np.int32)
    # each rounded to fp32 once, as detect_edges and candidate_geometry do
    floats = np.array([
        (s.thresh, 1.0 / s.thresh, 1.0 + 2.0 * s.puffer) for s in specs
    ], np.float64).astype(np.float32)
    return ints, floats, offs, total


def candidate_packs(powers, specs):
    """Every detection segment's candidate pack of one batch.

    Args:
      powers: G [B, n_cells_g] float32 cell powers, a common B; any row
        stride (views of a wider measure matrix are read in place).
      specs: G :class:`PackSpec`.

    Returns G [B, 7K_g] int32 packs (groups start bin, end bin, valid,
    wlog2, ext_start, ext_start % R, too_big; accepted candidates
    compacted to the front in acceptance order, empty columns 0 before
    the bin conversion), views of one flat buffer at
    :func:`pack_offsets`, the layout kernel C reads without a copy. CPU
    tensors take the plain version; CUDA tensors launch kernel B once for
    all segments (2 ... 2048 cells a segment, at most 32 segments).
    """
    specs = tuple(specs)
    dev = powers[0].device
    if dev.type == "cpu":
        return candidate_packs_plain(powers, specs)
    g_n = len(powers)
    if not 1 <= g_n <= _MAX_PACK_SEGMENTS or len(specs) != g_n:
        raise ValueError(f"candidate_packs: 1..{_MAX_PACK_SEGMENTS} "
                         f"segments, one spec each")
    nb = powers[0].shape[0]
    for p in powers:
        if p.dtype != torch.float32:
            raise TypeError("candidate_packs: float32 powers expected")
        if (p.dim() != 2 or p.shape[0] != nb or p.device != dev
                or p.stride(1) != 1):
            raise ValueError("candidate_packs: [B, n_cells] powers with "
                             "unit column stride on one device expected")
        if not 2 <= p.shape[1] <= MAX_PACK_CELLS:
            raise ValueError(f"candidate_packs: 2..{MAX_PACK_CELLS} cells "
                             f"a segment supported, got {p.shape[1]}")
    ints, floats, offs, total = _pack_tables(
        specs, tuple(p.shape[1] for p in powers), nb)
    if total >= 2**31:
        raise ValueError("candidate_packs: packs too large")
    ptrs = np.array([(p.data_ptr(), p.stride(0)) for p in powers], np.int64)
    flat = torch.empty(total, dtype=torch.int32, device=dev)
    rc = kernels.library().fdc_candidate_packs(
        g_n, ptrs.ctypes.data, ints.ctypes.data, floats.ctypes.data, nb,
        flat.data_ptr(), kernels.stream_ptr(dev),
    )
    kernels.check(rc, "fdc_candidate_packs")
    candidate_packs.launches += 1
    return _pack_views(flat, nb, specs, offs)


candidate_packs.launches = 0
