"""Kernel A: shared-matrix bucket extraction with in-kernel power measures.

Replaces the Pallas kernels ``_kernel_shared_measured`` and
``_kernel_shared`` of ``fdc_tpu/ops/extract_pallas.py``
(``fused_extract_shared``). For C static bin slices of width l:

    out[c, r] = pairs(spec[r, s_c : s_c + l]) @ M       -> [C, R, k, 2]
    powers[r] = |spec[r]|^2 @ masks                     -> [R, Cm]

``M`` is the folded window * gain * trim * IDFT matrix with its rows in
(re, im) interleaved order (``fft.interleave_rows``) and its columns
interleaved pairs, so the extraction reads the complex64 spectrum as raw
float pairs and writes the float-pair output layout directly. The
overlap-save phase compensation stays outside (``extract.apply_phase_pairs``),
as on the TPU. The CUDA source is ``csrc/extract_shared.cu``.
"""

from __future__ import annotations

import torch

from fdc_tpu_torch import kernels

__all__ = ["extract_shared", "extract_shared_plain"]

# k-split of the measures' N-long contraction (csrc/extract_shared.cu)
_POWER_SPLITS = 16


def extract_shared_plain(spec, starts, mat, masks=None):
    """Plain PyTorch version of :func:`extract_shared` (same arguments and
    results)."""
    l = mat.shape[0] // 2
    c = starts.shape[0]
    rows = spec.shape[0]
    sf = torch.view_as_real(spec)  # [R, N, 2]
    idx = starts.long()[:, None] + torch.arange(l, device=spec.device)
    z = sf[:, idx].permute(1, 0, 2, 3).reshape(c, rows, 2 * l)
    out = torch.matmul(z, mat).reshape(c, rows, -1, 2)
    if masks is None:
        return out
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
        kernels.stream_ptr(spec.device),
    )
    kernels.check(rc, "fdc_extract_shared")
    extract_shared.launches += 1
    if masks is None:
        return out
    return out, powers


extract_shared.launches = 0
