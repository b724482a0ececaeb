# Copied from fdc_tpu/ops/windows.py; only the import paths differ.
"""Window factories.

Numpy (host, build-time) implementations of the three window families used by
the channelizer. Windows are built once at trace/setup time and baked into
the jitted step functions as constants, so there is no need for a JAX
implementation here — the hot path only ever multiplies by them.

Semantics follow the reference exactly (integer flank arithmetic included):
- generic pass/stop-band windows with a bank of ``relinvovl`` phase-rotated
  copies (reference: lib/windows.h:34-124),
- all-power-of-2-width cosine-flank banks for dynamic detection channels
  (reference: lib/SegmentDetection_impl.cc:551-583),
- sine-flank rectangular windows for power-activated channels
  (reference: lib/PowerActivationChannel_impl.cc:357-375).

The phase bank implements overlap-save phase-rotation compensation: block t
of the overlap-save front-end is time-shifted by t*(N - N/R) samples, so a
subband slice starting at bin f picks up a per-block phase of
-2*pi*f*t/R which is undone by cycling through R pre-phased window copies
(reference: lib/phase_shifting_windowing_vcc_impl.cc:55-83).
"""

from __future__ import annotations

import numpy as np

from fdc_tpu_torch.config import WindowType

__all__ = [
    "base_window",
    "window_bank",
    "flank_window_bank",
    "sine_flank_window_bank",
]


def _rect_window(blocksize: int, lowsamps: int, rampsamps: int, v: float) -> np.ndarray:
    """Rectangular window: zero edges of lowsamps + rampsamps//2 samples
    (reference: lib/windows.h:80-90)."""
    w = np.full(blocksize, v, dtype=np.float64)
    edge = lowsamps + rampsamps // 2
    if edge > 0:
        w[:edge] = 0.0
        w[blocksize - edge:] = 0.0
    return w


def _ramp_window(blocksize: int, lowsamps: int, rampsamps: int, v: float) -> np.ndarray:
    """Linear-flank window (reference: lib/windows.h:92-106)."""
    w = np.full(blocksize, v, dtype=np.float64)
    if lowsamps > 0:
        w[:lowsamps] = 0.0
        w[blocksize - lowsamps:] = 0.0
    for i in range(rampsamps):
        val = v * (i + 1) / (rampsamps + 1)
        w[lowsamps + i] = val
        w[blocksize - lowsamps - 1 - i] = val
    return w


def _hann_window(blocksize: int, lowsamps: int, rampsamps: int, v: float) -> np.ndarray:
    """Hann-flank window (reference: lib/windows.h:108-124)."""
    w = np.full(blocksize, v, dtype=np.float64)
    if lowsamps > 0:
        w[:lowsamps] = 0.0
        w[blocksize - lowsamps:] = 0.0
    for i in range(rampsamps):
        phi = (i + 1) / (rampsamps + 1) * np.pi
        val = v * (-np.cos(phi) / 2.0 + 0.5)
        w[lowsamps + i] = val
        w[blocksize - lowsamps - 1 - i] = val
    return w


def base_window(
    wintype: WindowType,
    blocksize: int,
    passbw: float,
    stopbw: float,
    normalize: bool = False,
) -> np.ndarray:
    """Real-valued base window from pass/stop bandwidth fractions.

    ``normalize=False`` scales the window by 1/blocksize (the reference's
    inverted naming, lib/windows.h:81) so that the later unnormalized IFFT
    chain has unit gain.

    (reference: lib/windows.h:41-55)
    """
    wintype = WindowType(wintype)
    if passbw >= 1.0:
        passbw = 1.0
        stopbw = 1.0
        wintype = WindowType.RECTANGULAR
    elif stopbw >= 1.0:
        stopbw = 1.0

    lowsamps = int((1.0 - stopbw) * blocksize) // 2
    highsamps = int(passbw * blocksize)
    rampsamps = (blocksize - 2 * lowsamps - highsamps) // 2

    v = 1.0 if normalize else 1.0 / blocksize
    if wintype == WindowType.HANN:
        return _hann_window(blocksize, lowsamps, rampsamps, v)
    if wintype == WindowType.RAMP:
        return _ramp_window(blocksize, lowsamps, rampsamps, v)
    return _rect_window(blocksize, lowsamps, rampsamps, v)


def _phase_bank(w_d: np.ndarray, relinvovl: int, step: int) -> np.ndarray:
    """Stack of relinvovl phase-rotated copies: bank[i] = w_d * e^{j*2pi*((i*step)%R)/R}
    (reference: lib/windows.h:57-78)."""
    step = step % relinvovl
    counts = (np.arange(relinvovl) * step) % relinvovl
    phases = np.exp(2j * np.pi * counts / relinvovl)
    return (phases[:, None] * w_d[None, :]).astype(np.complex64)


def window_bank(
    wintype: WindowType,
    blocksize: int,
    passbw: float,
    stopbw: float,
    relinvovl: int,
    step: int = 1,
    normalize: bool = False,
) -> np.ndarray:
    """[relinvovl, blocksize] complex64 phased window bank for the
    throughput-channel path (reference: lib/windows.h:34,41-78)."""
    w_d = base_window(wintype, blocksize, passbw, stopbw, normalize)
    return _phase_bank(w_d, relinvovl, step)


def flank_window_bank(
    width: int, relinvovl: int, flank_puffer: float
) -> np.ndarray:
    """[relinvovl, width] cosine-flank window bank for dynamic detection
    channels: unit amplitude with raised-cosine flanks over
    int(flank_puffer*width) samples on each edge, times the R phase states
    (reference: lib/SegmentDetection_impl.cc:551-583)."""
    puffersamples = int(flank_puffer * width)
    w_d = np.ones(width, dtype=np.float64)
    for k in range(puffersamples):
        flank = 0.5 - 0.5 * np.cos(np.pi * k / puffersamples)
        w_d[k] *= flank
        w_d[width - 1 - k] *= flank
    phases = np.exp(2j * np.pi * np.arange(relinvovl) / relinvovl)
    return (phases[:, None] * w_d[None, :]).astype(np.complex64)


def all_width_flank_banks(
    blocksize: int, relinvovl: int, flank_puffer: float
) -> list:
    """One cosine-flank bank per power-of-2 width 1..blocksize; index by
    log2(width) (reference: lib/SegmentDetection_impl.cc:551-583)."""
    n_sizes = int(np.log2(blocksize)) + 1
    return [
        flank_window_bank(1 << s, relinvovl, flank_puffer)
        for s in range(n_sizes)
    ]


def sine_flank_window_bank(
    extract_width: int,
    measure_width: int,
    relinvovl: int,
) -> np.ndarray:
    """[relinvovl, extract_width] sine-flank rectangular bank for
    power-activated channels. The out-of-measurement-band samples are split in
    thirds: one third rising flank, one third falling flank, one third
    guard (reference: lib/PowerActivationChannel_impl.cc:357-375).

    Deviation from the reference: the reference writes the falling flank at
    index ``blocklen-1-i`` of a blocklen-long buffer while only the first
    ``extract_width`` samples are ever used
    (lib/PowerActivationChannel_impl.cc:365,371 vs :267), so its right flank
    is silently lost unless extract_width == blocklen. We apply the intended
    symmetric flank at ``extract_width-1-i``.
    """
    rampsamps = (extract_width - measure_width) // 3
    w_d = np.ones(extract_width, dtype=np.float64)
    for i in range(rampsamps):
        v = np.sin(0.5 * np.pi * i / (rampsamps + 1))
        w_d[i] *= v
        w_d[extract_width - 1 - i] = w_d[i]
    phases = np.exp(2j * np.pi * np.arange(relinvovl) / relinvovl)
    return (phases[:, None] * w_d[None, :]).astype(np.complex64)
