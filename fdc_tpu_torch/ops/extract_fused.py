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
sources are ``csrc/extract_shared.cu`` and ``csrc/extract_static.cu``
(one GEMM, ``csrc/tile_gemm.cuh``).
"""

from __future__ import annotations

import torch

from fdc_tpu_torch import kernels

__all__ = [
    "extract_shared",
    "extract_shared_plain",
    "extract_shared_fold",
    "extract_shared_fold_plain",
    "fold_quarter_turns",
    "gather_pairs",
    "extract_static",
    "extract_static_plain",
]

# k-split of the measures' N-long contraction (csrc/extract_shared.cu)
_POWER_SPLITS = 16


def gather_pairs(spec, starts, l: int):
    """[C, R, 2l] float pairs of the C bin slices of [R, N] complex64
    spectra (the operand the kernels gather in place)."""
    sf = torch.view_as_real(spec)  # [R, N, 2]
    idx = starts.long()[:, None] + torch.arange(l, device=spec.device)
    return sf[:, idx].permute(1, 0, 2, 3).reshape(len(starts), len(spec),
                                                  2 * l)


def extract_shared_plain(spec, starts, mat, masks=None):
    """Plain PyTorch version of :func:`extract_shared` (same arguments and
    results)."""
    z = gather_pairs(spec, starts, mat.shape[0] // 2)
    out = torch.matmul(z, mat).reshape(*z.shape[:2], -1, 2)
    if masks is None:
        return out
    sf = torch.view_as_real(spec)
    sq = sf[..., 0] * sf[..., 0] + sf[..., 1] * sf[..., 1]
    return out, torch.matmul(sq, masks)


def extract_shared(spec, starts, mat, masks=None):
    """Extract C equal-window channels from [R, N] complex64 spectra.

    Args:
      spec: [R, N] complex64, contiguous.
      starts: [C] int32 slice starts, each in [0, N - l] (the callers'
        tables are validated where they are built).
      mat: [2l, 2k] float32 folded matrix, rows interleaved (re, im).
      masks: optional [N, Cm] float32 measure columns.

    Returns out [C, R, k, 2] float32, and with ``masks`` the tuple
    (out, powers [R, Cm]). CPU tensors take the plain version; CUDA
    tensors launch the kernel.
    """
    if spec.device.type == "cpu":
        return extract_shared_plain(spec, starts, mat, masks)
    out = _launch_shared(spec, starts, mat, masks, 0)
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


def _launch_shared(spec, starts, mat, masks, fold_r: int):
    """Check the inputs of kernel A and launch it (the C entry point
    ``fdc_extract_shared``); returns out or (out, powers)."""
    rows, n = spec.shape
    l2, k2 = mat.shape
    c = starts.shape[0]
    if (spec.dtype != torch.complex64 or starts.dtype != torch.int32
            or mat.dtype != torch.float32 or l2 % 2 or k2 % 2):
        raise TypeError("extract_shared: complex64 spec, int32 starts, "
                        "float32 [2l, 2k] matrix expected")
    for t in (spec, starts, mat) + ((masks,) if masks is not None else ()):
        if t.device != spec.device or not t.is_contiguous():
            raise ValueError("extract_shared: contiguous tensors on one "
                             "device expected")
    out = torch.empty((c, rows, k2 // 2, 2), dtype=torch.float32,
                      device=spec.device)
    powers = partial = None
    cm = 0
    if masks is not None:
        if masks.dtype != torch.float32 or masks.shape[0] != n:
            raise ValueError("extract_shared: masks must be float32 [N, Cm]")
        cm = masks.shape[1]
        powers = torch.empty((rows, cm), dtype=torch.float32,
                             device=spec.device)
        partial = torch.empty((_POWER_SPLITS, rows, cm),
                              dtype=torch.float32, device=spec.device)
    rc = kernels.library().fdc_extract_shared(
        spec.data_ptr(), rows, n, starts.data_ptr(), c,
        mat.data_ptr(), l2, k2, out.data_ptr(),
        masks.data_ptr() if masks is not None else None, cm,
        partial.data_ptr() if partial is not None else None,
        _POWER_SPLITS,
        powers.data_ptr() if powers is not None else None,
        fold_r, kernels.stream_ptr(spec.device),
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
    out = torch.empty((c, rows, k2 // 2, 2), dtype=torch.float32,
                      device=spec.device)
    rc = kernels.library().fdc_extract_static(
        spec.data_ptr(), rows, n, starts.data_ptr(), c, mats.data_ptr(),
        l2, k2, out.data_ptr(), kernels.stream_ptr(spec.device),
    )
    kernels.check(rc, "fdc_extract_static")
    extract_static.launches += 1
    return out


extract_static.launches = 0
