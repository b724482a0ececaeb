"""Kernels A and E: static-bucket extraction, with in-kernel power measures.

Kernel A (:func:`extract_shared`) replaces the Pallas kernels
``_kernel_shared_measured`` and ``_kernel_shared`` of
``fdc_tpu/ops/extract_pallas.py`` (``fused_extract_shared``); kernel E
(:func:`extract_static`) replaces its ``_kernel``
(``fused_extract_static``). For C static bin slices of width l:

    A: out[c, r] = pairs(spec[r, s_c : s_c + l]) @ M     -> [C, R, k, 2]
       powers[r] = |spec[r]|^2 @ masks                   -> [R, Cm]
    E: out[c, r] = pairs(spec[r, s_c : s_c + l]) @ M_c   -> [C, R, k, 2]

``M`` (one for the bucket, equal windows) and ``M_c`` (one per channel)
are folded window * gain * trim * IDFT matrices with their rows in (re,
im) interleaved order (``fft.interleave_rows``) and their columns
interleaved pairs, so the extraction reads the complex64 spectrum as raw
float pairs and writes the float-pair output layout directly. The
overlap-save phase compensation of a throughput bucket without measures
and with R in {1, 2, 4} is :func:`extract_shared_fold`, kernel A's
quarter-turn fold (the ``fold_phase_r`` branch of ``_kernel_shared``):
the phase of row r of channel c is an exact quarter turn, applied in
kernel A's store epilogue. Elsewhere (measured buckets, per-channel
tables, R = 8) it stays outside (``extract.apply_phase_pairs``). The CUDA
sources are ``csrc/extract_shared.cu`` (on the pipelined GEMM of
``csrc/gather_gemm.cuh``, its tiles and k splits chosen per call by
:func:`gemm_plan` and :func:`measure_plan`) and ``csrc/extract_static.cu``
(on the same GEMM body with a matrix per channel, its plan from
:func:`static_plan`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fdc_tpu_torch import kernels

__all__ = [
    "extract_shared",
    "extract_shared_plain",
    "extract_shared_fold",
    "extract_shared_fold_plain",
    "fold_quarter_turns",
    "gather_pairs",
    "gemm_plan",
    "mask_extent",
    "measure_plan",
    "static_plan",
    "extract_static",
    "extract_static_plain",
]

# kernel A's GEMM (csrc/gather_gemm.cuh): the SMs, k a pipeline stage,
# the CTA tile's height and its widths in order of preference (8 x 8 a
# thread). Two 128 x 96 CTAs (192 threads at ~168 registers each) reside
# on an SM, so a grid of up to WAVE of them runs in one wave.
SMS = 132
BK = 16
TILE_M = 128
TILE_N = (96, 128, 64)
WAVE = 2 * SMS
# a k split keeps at least this many stages (one is all pipeline fill)
MIN_SPLIT_STAGES = 2
# the measures' tile (power mode), rows x mask columns; their k splits
# aim at four CTAs an SM (a 64 x 64 tile is two warps) of at least four
# stages each
MEASURE_TILE = (64, 64)
MEASURE_CTAS = 4 * SMS
MEASURE_MIN_STAGES = 4
# kernel E: rows past a channel's whole tiles that its last tile computes
# (csrc/extract_static.cu TAIL)
STATIC_TAIL = 2


@functools.lru_cache(maxsize=None)
def gemm_plan(m: int, nout: int, k: int):
    """Kernel A's extraction tiles for an [m, k] x [k, nout] product:
    (bm, bn, splits, k_chunk).

    One tile height, TILE_M; the first width of TILE_N that pads nout by
    at most an eighth (else the one that pads least); and the most k
    splits, each of at least MIN_SPLIT_STAGES stages, whose grid still
    runs in one wave of WAVE CTAs. A grid of a wave or more is not split.
    The splits' partial sums are added in split order (no atomics)."""
    bn = _tile_width(nout)
    tiles = -(-m // TILE_M) * -(-nout // bn)
    splits, chunk = _wave_splits(tiles, k)
    return TILE_M, bn, splits, chunk


def _tile_width(nout: int) -> int:
    """The first width of TILE_N that pads nout by at most an eighth, else
    the one that pads least."""
    def pad(bn):
        return -(-nout // bn) * bn - nout

    return next((w for w in TILE_N if 8 * pad(w) <= nout),
                min(TILE_N, key=pad))


def _wave_splits(tiles: int, k: int):
    """(splits, k_chunk): the most k splits, each of at least
    MIN_SPLIT_STAGES stages, whose grid of ``tiles`` tiles a split still
    runs in one wave of WAVE CTAs; none for a grid of a wave or more."""
    stages = -(-k // BK)
    want = max(1, min(WAVE // tiles, stages // MIN_SPLIT_STAGES))
    chunk = -(-stages // want)
    return -(-stages // chunk), chunk * BK


@functools.lru_cache(maxsize=None)
def static_plan(c: int, rows: int, k: int, nout: int):
    """Kernel E's plan for C channels of [rows, k] x [k, nout]: (bm, bn,
    splits, k_chunk, tail).

    A row tile never straddles two channels (their matrices differ), so
    each channel's rows are tiled alone: TILE_M rows a tile, and where a
    channel ends at most STATIC_TAIL rows past its last whole tile (R =
    513 = 4 * 128 + 1 on every path), that tile also computes them
    (``tail``) instead of a whole tile's FFMAs for a row or two. Where
    the grid of the widest tile, whose CTA takes an SM alone, fills 3/4
    to all of the SMs, that tile unsplit (w512: 120 CTAs); else width and
    k splits by kernel A's rule over the C * row tiles * column tiles of
    the grid."""
    tail = rows % TILE_M
    if rows < TILE_M or tail > STATIC_TAIL:
        tail = 0
    row_tiles = rows // TILE_M if tail else -(-rows // TILE_M)
    # one CTA of the widest tile takes an SM alone (256 threads at ~170
    # registers): where its grid fills 3/4 to all of the SMs, it is one
    # even wave without partial sums
    wide = max(TILE_N)
    tiles = c * row_tiles * -(-nout // wide)
    if 8 * (-(-nout // wide) * wide - nout) <= nout and (
            4 * tiles >= 3 * SMS and tiles <= SMS):
        return TILE_M, wide, 1, -(-k // BK) * BK, tail
    bn = _tile_width(nout)
    splits, chunk = _wave_splits(c * row_tiles * -(-nout // bn), k)
    return TILE_M, bn, splits, chunk, tail


@functools.lru_cache(maxsize=None)
def measure_plan(rows: int, cols: int, k_lo: int, k_hi: int):
    """The measures' k splits over mask rows [k_lo, k_hi) (k_lo a multiple
    of BK) for ``cols`` mask columns in use: (splits, k_chunk), ranges of
    equal whole stages, the longest that still bring the grid to
    MEASURE_CTAS CTAs, but no shorter than MEASURE_MIN_STAGES stages."""
    bm, bn = MEASURE_TILE
    tiles = -(-rows // bm) * -(-cols // bn)
    need = -(-MEASURE_CTAS // tiles)
    stages = -(-(k_hi - k_lo) // BK)
    chunk = max(MEASURE_MIN_STAGES, stages // need) * BK
    return -(-(k_hi - k_lo) // chunk), chunk


def mask_extent(masks: np.ndarray):
    """(cols, k_lo, k_hi) of [N, Cm] measure masks (host memory): the
    columns up to the last non-zero one, and the rows [k_lo, k_hi) holding
    their non-zero entries (k_lo rounded down to a multiple of BK).
    Everything outside is exact zeros, which kernel A skips when it is
    given this extent. The channelizer computes it where it builds its
    masks."""
    nz = np.asarray(masks) != 0
    used = np.flatnonzero(nz.any(0))
    if not used.size:
        return (0, 0, 0)
    cols = int(used[-1]) + 1
    rows = np.flatnonzero(nz[:, :cols].any(1))
    return (cols, int(rows[0]) // BK * BK, int(rows[-1]) + 1)


def gather_pairs(spec, starts, l: int):
    """[C, R, 2l] float pairs of the C bin slices of [R, N] complex64
    spectra (the operand the kernels gather in place)."""
    sf = torch.view_as_real(spec)  # [R, N, 2]
    idx = starts.long()[:, None] + torch.arange(l, device=spec.device)
    return sf[:, idx].permute(1, 0, 2, 3).reshape(len(starts), len(spec),
                                                  2 * l)


def extract_shared_plain(spec, starts, mat, masks=None, extent=None):
    """Plain PyTorch version of :func:`extract_shared` (same arguments and
    results; the whole of ``masks`` is multiplied, ``extent`` unused)."""
    z = gather_pairs(spec, starts, mat.shape[0] // 2)
    out = torch.matmul(z, mat).reshape(*z.shape[:2], -1, 2)
    if masks is None:
        return out
    sf = torch.view_as_real(spec)
    sq = sf[..., 0] * sf[..., 0] + sf[..., 1] * sf[..., 1]
    return out, torch.matmul(sq, masks)


def extract_shared(spec, starts, mat, masks=None, extent=None):
    """Extract C equal-window channels from [R, N] complex64 spectra.

    Args:
      spec: [R, N] complex64, contiguous.
      starts: [C] int32 slice starts, each in [0, N - l] (the callers'
        tables are validated where they are built).
      mat: [2l, 2k] float32 folded matrix, rows interleaved (re, im).
      masks: optional [N, Cm] float32 measure columns.
      extent: optional :func:`mask_extent` of ``masks``: the kernel then
        multiplies only the columns and rows it names (the rest must be
        zeros); without it, the whole of ``masks``.

    Returns out [C, R, k, 2] float32, and with ``masks`` the tuple
    (out, powers [R, Cm]). CPU tensors take the plain version; CUDA
    tensors launch the kernel.
    """
    if spec.device.type == "cpu":
        return extract_shared_plain(spec, starts, mat, masks)
    out = _launch_shared(spec, starts, mat, masks, 0, extent)
    extract_shared.launches += 1
    return out


extract_shared.launches = 0


def fold_quarter_turns(y, starts, r: int):
    """Rotate the [C, rows, k, 2] pairs of row b of channel c by
    ``q = ((b % r) * (s_c % r)) % r * (4 // r)`` quarter turns (``r`` =
    relinvovl in {1, 2, 4}): (re, im) -> (-im, re), (-re, -im), (im, -re)
    as selects, no trigonometry."""
    rows = torch.arange(y.shape[1], dtype=torch.int32, device=y.device)
    q = ((rows[None, :] % r) * (starts[:, None] % r)) % r * (4 // r)
    q = q[..., None, None]
    jy = torch.stack([-y[..., 1], y[..., 0]], dim=-1)
    return torch.where(q == 0, y, torch.where(
        q == 1, jy, torch.where(q == 2, -y, -jy)))


def extract_shared_fold_plain(spec, starts, mat, r: int):
    """Plain PyTorch version of :func:`extract_shared_fold` (same
    arguments and results)."""
    return fold_quarter_turns(extract_shared_plain(spec, starts, mat),
                              starts, r)


def extract_shared_fold(spec, starts, mat, r: int):
    """:func:`extract_shared` (no measures) with the overlap-save phase
    compensation folded in, for a bucket whose row 0 has a global block
    index that is a multiple of ``r`` (= relinvovl, in {1, 2, 4}): the
    phase of row b of channel c, e^{j 2 pi ((b * s_c) % r) / r}, is the
    exact quarter-turn rotation of :func:`fold_quarter_turns`. CPU tensors
    take the plain version; CUDA tensors launch kernel A with its fold."""
    if r not in (1, 2, 4):
        raise ValueError(f"extract_shared_fold: R must be 1, 2 or 4, got {r}")
    if spec.device.type == "cpu":
        return extract_shared_fold_plain(spec, starts, mat, r)
    out = _launch_shared(spec, starts, mat, None, r)
    extract_shared_fold.launches += 1
    return out


extract_shared_fold.launches = 0


def _launch_shared(spec, starts, mat, masks, fold_r: int, extent=None):
    """Check the inputs of kernel A and launch it (the C entry point
    ``fdc_extract_shared``); returns out or (out, powers)."""
    rows, n = spec.shape
    l2, k2 = mat.shape
    c = starts.shape[0]
    if (spec.dtype != torch.complex64 or starts.dtype != torch.int32
            or mat.dtype != torch.float32 or l2 % 2 or k2 % 2):
        raise TypeError("extract_shared: complex64 spec, int32 starts, "
                        "float32 [2l, 2k] matrix expected")
    where = spec.get_device()
    for t in (spec, starts, mat) + ((masks,) if masks is not None else ()):
        if t.get_device() != where or not t.is_contiguous():
            raise ValueError("extract_shared: contiguous tensors on one "
                             "device expected")
    if spec.data_ptr() % 8 or mat.data_ptr() % 8:
        raise ValueError("extract_shared: 8-byte aligned tensors expected")
    dev = spec.device
    m = c * rows
    out = torch.empty((c, rows, k2 // 2, 2), dtype=torch.float32,
                      device=dev)
    bm, bn, splits, k_chunk = gemm_plan(m, k2, l2)
    cm = cols = k_lo = k_hi = m_splits = m_chunk = 0
    if masks is not None:
        if (masks.dtype != torch.float32 or masks.dim() != 2
                or masks.shape[0] != n or masks.shape[1] % 2
                or masks.data_ptr() % 8):
            raise ValueError("extract_shared: masks must be float32 [N, Cm], "
                             "Cm even, 8-byte aligned")
        cm = masks.shape[1]
        cols, k_lo, k_hi = extent or (cm, 0, n)
        if not (0 <= cols <= cm and 0 <= k_lo <= k_hi <= n
                and k_lo % BK == 0):
            raise ValueError(f"extract_shared: bad mask extent {extent}")
        if cols:
            m_splits, m_chunk = measure_plan(rows, cols, k_lo, k_hi)
    # one allocation: powers [rows, cm], the extraction's split partial
    # sums [splits, m, k2] (splits > 1), the measures' [m_splits, rows,
    # cols], each from a 16-byte boundary
    sizes = [-(-v // 4) * 4 for v in (
        rows * cm, splits * m * k2 if splits > 1 else 0,
        m_splits * rows * cols)]
    scratch = (torch.empty(sum(sizes), dtype=torch.float32, device=dev)
               if any(sizes) else None)
    base = scratch.data_ptr() if scratch is not None else 0
    part = base + 4 * sizes[0] if sizes[1] else None
    m_part = base + 4 * (sizes[0] + sizes[1]) if sizes[2] else None
    powers = (scratch[:rows * cm].view(rows, cm) if masks is not None
              else None)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    rc = kernels.library().fdc_extract_shared(
        spec.data_ptr(), rows, n, starts.data_ptr(), c, mat.data_ptr(), l2,
        k2, out.data_ptr(), bm, bn, splits, k_chunk, part, fold_r,
        ptr(masks), cm, cols, k_lo, k_hi, m_splits, m_chunk, m_part,
        ptr(powers), kernels.stream_ptr(dev),
    )
    kernels.check(rc, "fdc_extract_shared")
    if masks is None:
        return out
    return out, powers


def extract_static_plain(spec, starts, mats):
    """Plain PyTorch version of :func:`extract_static` (same arguments and
    results)."""
    z = gather_pairs(spec, starts, mats.shape[1] // 2)
    return torch.bmm(z, mats).reshape(*z.shape[:2], -1, 2)


def extract_static(spec, starts, mats):
    """Extract C channels with a matrix each from [R, N] complex64 spectra.

    Args:
      spec: [R, N] complex64, contiguous.
      starts: [C] int32 slice starts, each in [0, N - l] (the callers'
        tables are validated where they are built).
      mats: [C, 2l, 2k] float32 folded matrices, rows interleaved (re, im).

    Returns out [C, R, k, 2] float32. CPU tensors take the plain version;
    CUDA tensors launch the kernel.
    """
    if spec.device.type == "cpu":
        return extract_static_plain(spec, starts, mats)
    rows, n = spec.shape
    c, l2, k2 = mats.shape
    if (spec.dtype != torch.complex64 or starts.dtype != torch.int32
            or mats.dtype != torch.float32 or l2 % 2 or k2 % 2):
        raise TypeError("extract_static: complex64 spec, int32 starts, "
                        "float32 [C, 2l, 2k] matrices expected")
    if starts.shape != (c,):
        raise ValueError("extract_static: one start per matrix expected")
    for t in (spec, starts, mats):
        if t.device != spec.device or not t.is_contiguous():
            raise ValueError("extract_static: contiguous tensors on one "
                             "device expected")
    if spec.data_ptr() % 8 or mats.data_ptr() % 8:
        raise ValueError("extract_static: 8-byte aligned tensors expected")
    out = torch.empty((c, rows, k2 // 2, 2), dtype=torch.float32,
                      device=spec.device)
    bm, bn, splits, k_chunk, tail = static_plan(c, rows, l2, k2)
    part = (torch.empty(splits * c * rows * k2, dtype=torch.float32,
                        device=spec.device) if splits > 1 else None)
    rc = kernels.library().fdc_extract_static(
        spec.data_ptr(), rows, n, starts.data_ptr(), c, mats.data_ptr(),
        l2, k2, out.data_ptr(), bm, bn, splits, k_chunk, tail,
        part.data_ptr() if part is not None else None,
        kernels.stream_ptr(spec.device),
    )
    kernels.check(rc, "fdc_extract_static")
    extract_static.launches += 1
    return out


extract_static.launches = 0
