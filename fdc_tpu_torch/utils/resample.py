"""Rational resampling conveniences for per-channel output streams.

Port of ``fdc_tpu.utils.resample``. The reference emits each channel at
its own fixed rate fs*width/blocksize (reference:
python/FrequencyDomainChannelizer.py:218-231 — the decimation is the
bin-slice width); downstream consumers usually want one common rate.
The polyphase up/down structure is one ``torch.nn.functional.conv1d``
over the zero-stuffed input (interpolation) with stride ``down``
(decimation), on the input tensor's device. No Pallas kernel is
involved in the JAX package (one ``lax.conv_general_dilated``), so the
library convolution is the port.

No reference analog (gr-FDC leaves resampling to downstream GNU Radio
blocks); the filter is a Kaiser-windowed sinc like GNU Radio's
``rational_resampler`` default design.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

__all__ = ["design_kaiser_lowpass", "rational_resample", "common_rate"]


def design_kaiser_lowpass(num_taps: int, cutoff: float,
                          beta: float = 8.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, unit DC gain.

    Args:
      num_taps: filter length (odd recommended for symmetric delay).
      cutoff: normalized cutoff in cycles/sample of the target rate
        (0 < cutoff <= 0.5).
      beta: Kaiser shape parameter.
    """
    if not 0.0 < cutoff <= 0.5:
        raise ValueError(f"cutoff must be in (0, 0.5], got {cutoff}")
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * n)
    h *= np.kaiser(num_taps, beta)
    return (h / h.sum()).astype(np.float32)


def rational_resample(x, up: int, down: int, taps_per_phase: int = 16,
                      beta: float = 8.0) -> torch.Tensor:
    """Resample complex streams by up/down with a polyphase lowpass.

    Args:
      x: [T] or [C, T] complex64 streams, a tensor (its device is used)
        or a numpy array (the CPU); a batch resamples as one convolution.
      up/down: interpolation / decimation factors (coprime not required;
        the fraction is reduced internally).
      taps_per_phase: filter taps per polyphase branch.
      beta: Kaiser window shape.

    Returns [ceil(T*up/down)] (or [C, ...]) complex64, group delay
    compensated — y[m] tracks x(m*down/up). The convolution runs in fp32
    with cuDNN's TF32 off for the call.
    """
    x = torch.as_tensor(x)
    frac = Fraction(int(up), int(down))
    up, down = frac.numerator, frac.denominator
    if up == 1 and down == 1:
        return x
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    c, t = x.shape

    # anti-alias/anti-image cutoff at the tighter of the two Nyquists,
    # relative to the UPSAMPLED rate; gain `up` restores amplitude
    num_taps = taps_per_phase * up + 1
    h = design_kaiser_lowpass(num_taps, 0.5 / max(up, down), beta) \
        * np.float32(up)
    weight = torch.from_numpy(h).to(x.device)[None, None, :]  # [1, 1, L]
    pad = (num_taps - 1) // 2  # center the group delay

    # real and imaginary rows as one batch, zero-stuffed by `up` (the
    # JAX package's lhs_dilation); the kernel is symmetric, so conv1d's
    # correlation is the convolution
    parts = torch.cat([x.real, x.imag]).to(torch.float32)  # [2C, T]
    stuffed = parts.new_zeros((2 * c, 1, (t - 1) * up + 1))
    stuffed[:, 0, ::up] = parts
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = torch.nn.functional.conv1d(stuffed, weight, stride=down,
                                       padding=pad)[:, 0]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    y = torch.complex(y[:c], y[c:])
    return y[0] if squeeze else y


def common_rate(streams, widths, target_width: int, blocksize: int = None,
                **kw):
    """Bring per-channel streams (rate ∝ their slice widths) to one rate.

    Args:
      streams: list of [T_i] complex arrays (ProcessResult.throughput).
      widths: each stream's extraction width (channel geometry `.width`).
      target_width: the width whose rate to resample everything to.

    Returns list of streams all at rate fs * target_width / blocksize.
    """
    del blocksize  # rates are proportional to widths; blocksize cancels
    return [rational_resample(s, target_width, w, **kw)
            for s, w in zip(streams, widths)]
