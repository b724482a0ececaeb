"""FFT front-end and the matmul-DFT subband transforms.

Port of the parts of ``fdc_tpu.ops.fft`` on the flagship path:

- :func:`forward_spectrum`: the batched forward FFT, fftshifted and scaled
  by 1/N (reference: python/FrequencyDomainChannelizer.py:206,214-216),
  on ``torch.fft`` (cuFFT on the card). The JAX package's four-step MXU
  form was a TPU device and is not ported.
- :func:`_rr_idft_matrix`: the numpy real-representation IDFT matrices
  (copied; the extraction kernels fold windows into them).
- :func:`interp_subband_ifft_mxu`: the variable-width slot transform as
  one fp32 ``torch.matmul`` (a plain large product, as the JAX package
  leaves it to XLA).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "forward_spectrum",
    "interleave_rows",
    "interp_subband_ifft_mxu",
]


def forward_spectrum(blocks: torch.Tensor) -> torch.Tensor:
    """[..., N] complex blocks -> [..., N] spectrum, DC at bin N/2, 1/N
    scaled (reference: python/FrequencyDomainChannelizer.py:206,214-216)."""
    n = blocks.shape[-1]
    spec = torch.fft.fftshift(torch.fft.fft(blocks, dim=-1), dim=-1)
    return spec * (1.0 / n)


@functools.lru_cache(maxsize=None)
def _rr_idft_matrix(
    l: int, keep_from: int, signs: bool, gain: float, pairs: bool = False
):
    """[2l, 2(l-keep_from)] float32 real-representation IDFT matrix.

    ``[zr zi] @ M == [yr yi]`` for ``y[m] = gain * l * ifft(z)[m]``
    (times ``(-1)^m`` when ``signs``), output columns restricted to
    ``m in [keep_from, l)``. ``pairs`` interleaves the output columns
    (re0, im0, re1, im1, ...) so the product is the float32 ``[..., k, 2]``
    pair layout directly. (Copied from ``fdc_tpu.ops.fft``.)
    """
    k = np.arange(l)[:, None].astype(np.float64)
    m = np.arange(keep_from, l)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * (k * m % l) / l
    e_re = np.cos(ang) * gain
    e_im = np.sin(ang) * gain
    if signs:
        s = np.where(np.arange(keep_from, l) % 2 == 0, 1.0, -1.0)[None, :]
        e_re = e_re * s
        e_im = e_im * s
    top = np.concatenate([e_re, e_im], axis=1)
    bot = np.concatenate([-e_im, e_re], axis=1)
    mat = np.concatenate([top, bot], axis=0).astype(np.float32)
    if pairs:
        kept = mat.shape[1] // 2
        mat = np.stack([mat[:, :kept], mat[:, kept:]], axis=2).reshape(
            mat.shape[0], 2 * kept
        )
    return mat


def interleave_rows(mat: np.ndarray) -> np.ndarray:
    """Reorder a [2l, X] real-representation matrix's rows from
    (re0..re_{l-1}, im0..im_{l-1}) to (re0, im0, re1, im1, ...), so it
    contracts against the raw interleaved float pairs of a complex64
    slice (``torch.view_as_real``) — no planar copy of the operand."""
    l = mat.shape[0] // 2
    return np.ascontiguousarray(
        np.stack([mat[:l], mat[l:]], axis=1).reshape(mat.shape)
    )


def interp_subband_ifft_mxu(z_pairs: torch.Tensor,
                            mat: torch.Tensor) -> torch.Tensor:
    """Variable-width slot transform (``fdc_tpu.ops.fft.
    interp_subband_ifft_mxu`` with ``pairs=True``): [..., W, 2] windowed
    slices in pair layout times the interleaved-row W-point unnormalized
    IDFT matrix ``mat`` [2W, 2W] -> [..., W, 2] pairs. One fp32 matmul
    (TF32 off, see the channelizer)."""
    w = z_pairs.shape[-2]
    y = torch.matmul(z_pairs.reshape(*z_pairs.shape[:-2], 2 * w), mat)
    return y.reshape(*y.shape[:-1], w, 2)
