"""Channel extraction: bin-slice gather + window + subband IDFT.

Port of the flagship parts of ``fdc_tpu.ops.extract`` (reference:
python/FrequencyDomainChannelizer.py:218-231,
lib/PowerActivationChannel_impl.cc:260-284,
lib/SegmentDetection_impl.cc:399-429). Every phase copy of the
reference's window banks is the base window times e^{j*2pi*p/R}, so the
overlap-save phase compensation factors out of the transform and is
applied as a per-row scalar rotation (:func:`apply_phase_pairs`).

Static buckets always extract through kernel A (``extract_fused``): the
JAX package's TPU-only engagement gates and VMEM budgets do not apply on
the card, and its XLA fallbacks compute the same values. All extraction
outputs use the float32 ``[..., k, 2]`` pair layout of the step-output
contract.
"""

from __future__ import annotations

import numpy as np
import torch

from fdc_tpu_torch.ops import extract_fused
from fdc_tpu_torch.ops.fft import (
    _rr_idft_matrix,
    interleave_rows,
    interp_subband_ifft_mxu,
)

__all__ = [
    "apply_phase_pairs",
    "gather_slices",
    "shared_folded_matrix",
    "extract_bucket_phased",
    "extract_bucket_measured",
    "extract_dynamic",
]


def apply_phase_pairs(y: torch.Tensor, phase_idx: torch.Tensor,
                      relinvovl: int) -> torch.Tensor:
    """Rotate ``[..., L, 2]`` pair rows by e^{j*2pi*p/R}, p = phase_idx
    (broadcast against y's leading dims): ``c*y + d*(j*y)`` in pair form."""
    ang = (2.0 * np.pi / relinvovl) * torch.arange(
        relinvovl, dtype=torch.float32, device=y.device
    )
    idx = phase_idx.long()
    re = torch.cos(ang)[idx][..., None, None]
    im = torch.sin(ang)[idx][..., None, None]
    rot = torch.stack([-y[..., 1], y[..., 0]], dim=-1)  # j * y
    return y * re + rot * im


def gather_slices(spectrum: torch.Tensor, starts: torch.Tensor,
                  width: int) -> torch.Tensor:
    """[C] bin slices of length ``width`` out of [B, N] spectra -> [C, B,
    width] (reference: lib/vector_cut_vxx_impl.cc:59-72)."""
    idx = starts.long()[:, None] + torch.arange(width,
                                                device=spectrum.device)
    return spectrum[:, idx].permute(1, 0, 2)


def shared_folded_matrix(n: int, starts: np.ndarray,
                         base_windows: np.ndarray, keep_from: int,
                         gain: float) -> np.ndarray:
    """The shared [2l, 2k] window * gain * trim * IDFT matrix of an
    equal-window static bucket, rows interleaved for kernel A.

    The TPU engagement gates and VMEM budgets of
    ``fdc_tpu.ops.extract._shared_fused_matrix`` / ``measured_folded_matrix``
    do not apply here, so the two functions are one. A bucket whose channels
    have different windows would need the per-channel kernel
    (``fused_extract_static``), which is not ported yet.
    """
    l = base_windows.shape[-1]
    if not (base_windows == base_windows[:1]).all():
        raise NotImplementedError(
            "static bucket with per-channel windows: needs the "
            "fused_extract_static kernel, not ported yet"
        )
    starts = np.asarray(starts)
    if starts.min() < 0 or starts.max() + l > n:
        raise ValueError(f"bucket slices out of the {n}-bin spectrum")
    m = _rr_idft_matrix(l, keep_from, True, float(gain), pairs=True)
    folded = (
        np.concatenate([base_windows[0], base_windows[0]])[:, None] * m
    ).astype(np.float32)
    return interleave_rows(folded)


def _row_phases(starts: torch.Tensor, b: int, relinvovl: int):
    """Phase index (b * start) % R of each (channel, row) when the global
    index of row 0 is a multiple of R (batch_blocks % R == 0)."""
    rows = torch.arange(b, dtype=torch.int32, device=starts.device)
    return (rows[None, :] * starts[:, None]) % relinvovl


def extract_bucket_phased(spectrum, starts, folded, relinvovl: int):
    """[C, B, k, 2] extraction of an equal-window static bucket
    (``folded`` from :func:`shared_folded_matrix`) with the phase
    compensation applied, under the static contract that the global index
    of row 0 is ≡ 0 (mod R)."""
    y = extract_fused.extract_shared(spectrum, starts, folded)
    return apply_phase_pairs(y, _row_phases(starts, y.shape[1], relinvovl),
                             relinvovl)


def extract_bucket_measured(spectrum, starts, folded, relinvovl: int,
                            power_masks):
    """:func:`extract_bucket_phased` + the detection power measures
    ``powers = |spectrum|^2 @ power_masks`` [B, Cm] from the same kernel
    launch (reference measures: lib/PowerActivationChannel_impl.cc:286-306,
    lib/SegmentDetection_impl.cc:178-193)."""
    y, powers = extract_fused.extract_shared(spectrum, starts, folded,
                                             power_masks)
    y = apply_phase_pairs(y, _row_phases(starts, y.shape[1], relinvovl),
                          relinvovl)
    return y, powers


def extract_dynamic(spectrum, starts, windows_pad, idft_mat):
    """Variable-width slot extraction at one static width W.

    spectrum [B, N] complex64; starts [E] int32; windows_pad [E, W]
    float32 zero-padded past each slot's width; idft_mat [2W, 2W] the
    interleaved-row unnormalized W-point IDFT (pairs columns). Returns
    [E, B, W, 2] phase-0 interpolated outputs: sample m*q of a slot of
    width w = W/q is its w-point unnormalized IFFT at m, without the
    fftshift signs (see ``fdc_tpu.ops.fft.interp_subband_ifft``).
    """
    w_max = windows_pad.shape[-1]
    # zero-pad the tail so a W-long slice starting anywhere in [0, N)
    # never runs off the spectrum (the zero window drops those bins)
    spectrum = torch.nn.functional.pad(spectrum, (0, w_max))
    slices = torch.view_as_real(gather_slices(spectrum, starts, w_max))
    z = slices * windows_pad[:, None, :, None]  # [E, B, W, 2]
    return interp_subband_ifft_mxu(z, idft_mat)
