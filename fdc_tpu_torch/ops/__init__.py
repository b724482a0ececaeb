"""Compute primitives of the port: framing, FFTs, extraction, detection,
and the wrappers of the hand-written kernels. Exports what
``fdc_tpu.ops`` exports, but ``comb_subband_ifft`` (the gather form that
``interp_subband_ifft`` superseded, not ported)."""

from fdc_tpu_torch.ops.windows import (
    window_bank,
    flank_window_bank,
    sine_flank_window_bank,
    base_window,
)
from fdc_tpu_torch.ops.framing import frame_blocks
from fdc_tpu_torch.ops.fft import forward_spectrum, subband_ifft

__all__ = [
    "window_bank",
    "flank_window_bank",
    "sine_flank_window_bank",
    "base_window",
    "frame_blocks",
    "forward_spectrum",
    "subband_ifft",
]
