"""Channel extraction: bin-slice gather + window + subband IDFT.

Port of the flagship parts of ``fdc_tpu.ops.extract`` (reference:
python/FrequencyDomainChannelizer.py:218-231,
lib/PowerActivationChannel_impl.cc:260-284,
lib/SegmentDetection_impl.cc:399-429). Every phase copy of the
reference's window banks is the base window times e^{j*2pi*p/R}, so the
overlap-save phase compensation factors out of the transform and is
applied as a per-row scalar rotation (:func:`apply_phase_pairs`).

Static buckets always extract through a kernel (``extract_fused``):
kernel A when the bucket's channels share one window, kernel E when each
has its own. The JAX package's TPU-only engagement gates and VMEM
budgets do not apply on the card, and its XLA fallbacks compute the same
values. All extraction outputs use the float32 ``[..., k, 2]`` pair
layout of the step-output contract.
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
    "static_folded_matrices",
    "bucket_folded",
    "extract_bucket",
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


def _check_slices(n: int, starts, l: int) -> None:
    starts = np.asarray(starts)
    if starts.min() < 0 or starts.max() + l > n:
        raise ValueError(f"bucket slices out of the {n}-bin spectrum")


def shared_folded_matrix(n: int, starts: np.ndarray,
                         base_windows: np.ndarray, keep_from: int,
                         gain: float) -> np.ndarray:
    """The [2l, 2k] window * gain * trim * IDFT matrix shared by the
    channels of an equal-window static bucket (``base_windows`` [C, l],
    every row the same; row 0 is folded), rows interleaved for kernel A.
    The TPU engagement gates and VMEM budgets of
    ``fdc_tpu.ops.extract._shared_fused_matrix`` /
    ``measured_folded_matrix`` do not apply here."""
    l = base_windows.shape[-1]
    _check_slices(n, starts, l)
    m = _rr_idft_matrix(l, keep_from, True, float(gain), pairs=True)
    folded = (
        np.concatenate([base_windows[0], base_windows[0]])[:, None] * m
    ).astype(np.float32)
    return interleave_rows(folded)


def static_folded_matrices(n: int, starts: np.ndarray, windows: np.ndarray,
                           keep_from: int, gain: float) -> np.ndarray:
    """The per-channel [C, 2l, 2k] folded matrices of a static bucket
    whose channels have different windows (``windows`` [C, l]), rows
    interleaved for kernel E — the fold of
    ``fdc_tpu.ops.extract.extract_bucket`` (its ``fused_extract_static``
    tables and their XLA twin)."""
    l = windows.shape[-1]
    _check_slices(n, starts, l)
    m = _rr_idft_matrix(l, keep_from, True, float(gain), pairs=True)
    folded = (np.concatenate([windows, windows], axis=1)[:, :, None]
              * m[None]).astype(np.float32)
    return np.stack([interleave_rows(f) for f in folded])


def bucket_folded(n: int, starts: np.ndarray, windows: np.ndarray,
                  keep_from: int, gain: float) -> np.ndarray:
    """A static bucket's extraction table: the shared [2l, 2k] matrix
    (kernel A) when every channel has the same window, else the
    per-channel [C, 2l, 2k] matrices (kernel E)."""
    if (windows == windows[:1]).all():
        return shared_folded_matrix(n, starts, windows, keep_from, gain)
    return static_folded_matrices(n, starts, windows, keep_from, gain)


def extract_bucket(spectrum, starts, folded):
    """[C, R, k, 2] phase-0 extraction of a static bucket through its
    table from :func:`bucket_folded`: kernel A for a shared matrix,
    kernel E for per-channel matrices."""
    if folded.dim() == 2:
        return extract_fused.extract_shared(spectrum, starts, folded)
    return extract_fused.extract_static(spectrum, starts, folded)


def _row_phases(starts: torch.Tensor, b: int, relinvovl: int):
    """Phase index (b * start) % R of each (channel, row) when the global
    index of row 0 is a multiple of R (batch_blocks % R == 0)."""
    rows = torch.arange(b, dtype=torch.int32, device=starts.device)
    return (rows[None, :] * starts[:, None]) % relinvovl


def extract_bucket_phased(spectrum, starts, folded, relinvovl: int):
    """:func:`extract_bucket` with the phase compensation applied, under
    the static contract that the global index of row 0 is ≡ 0 (mod R).

    With a shared-matrix table and R in {1, 2, 4}, every phase factor is a
    quarter turn and kernel A applies it in its store epilogue
    (``extract_fused.extract_shared_fold``, exact). R = 8 and per-channel
    tables have no such fold: kernel A or E extracts and
    :func:`apply_phase_pairs` rotates (cos/sin of the angles)."""
    if relinvovl in (1, 2, 4) and folded.dim() == 2:
        return extract_fused.extract_shared_fold(spectrum, starts, folded,
                                                 relinvovl)
    y = extract_bucket(spectrum, starts, folded)
    return apply_phase_pairs(y, _row_phases(starts, y.shape[1], relinvovl),
                             relinvovl)


def extract_bucket_measured(spectrum, starts, folded, relinvovl: int,
                            power_masks, extent=None):
    """:func:`extract_bucket_phased` of an equal-window bucket (a shared
    ``folded`` matrix) + the detection power measures
    ``powers = |spectrum|^2 @ power_masks`` [B, Cm] from the same kernel A
    launch (reference measures: lib/PowerActivationChannel_impl.cc:286-306,
    lib/SegmentDetection_impl.cc:178-193). ``extent``: the masks'
    ``extract_fused.mask_extent``, the part kernel A multiplies."""
    y, powers = extract_fused.extract_shared(spectrum, starts, folded,
                                             power_masks, extent)
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
