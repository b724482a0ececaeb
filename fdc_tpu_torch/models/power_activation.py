"""Power-activated burst channels (fixed positions, hysteresis on/off).

Port of ``fdc_tpu.models.power_activation`` (reference:
lib/PowerActivationChannel_impl.cc): C configured channels share one
power measure pass, one hysteresis automaton over the block axis (kernel
D, ``ops.powact``, or beside detection segments kernel C's burst chain,
``ops.lifecycle``), and one width-bucketed extraction over the [B+1]-row
spectrum batch (row 0 is the previous batch's last block, reference:
lib/PowerActivationChannel_impl.cc:198-210).
Extraction runs for every channel every block; the flags select what the
host emitter appends to burst buffers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from fdc_tpu_torch.config import solve_power_channel
from fdc_tpu_torch.ops.detect import band_power
from fdc_tpu_torch.ops import powact
from fdc_tpu_torch.ops.extract import bucket_folded
from fdc_tpu_torch.ops.windows import sine_flank_window_bank

__all__ = ["PowerActivationBank"]

# std::numeric_limits<float>::min()/max() — the reference's zero-power
# floor and initial lastpower (reference:
# lib/PowerActivationChannel_impl.cc:92,293-294)
_FLOAT_MIN = np.float32(1.1754944e-38)
_FLOAT_MAX = np.float32(3.4028235e38)


@dataclass(frozen=True)
class _Bucket:
    width: int
    out_len: int
    channel_ids: tuple
    starts: np.ndarray  # [C] int32 extract starts
    windows: np.ndarray  # [C, width] float32 phase-0 sine-flank windows
    name: str  # buffer prefix of the bucket's device tables


class PowerActivationBank(nn.Module):
    """Bank of C power-activated channels. Buffers: ``measure_masks``
    [N, C], ``delta`` [C] int32, and per bucket ``{name}_starts`` /
    ``{name}_folded`` (gain 1; a shared matrix for kernel A, per-channel
    matrices for kernel E when the windows differ)."""

    def __init__(self, blocksize: int, relinvovl: int, channels,
                 thresh_db: float):
        super().__init__()
        if thresh_db <= 0.0:
            raise ValueError("Threshold is dB and must be > 0")
        self.blocksize = blocksize
        self.relinvovl = relinvovl
        # linear threshold (reference: lib/PowerActivationChannel_impl.cc:377-381)
        self.thresh = float(10.0 ** (thresh_db / 10.0))
        self.geometry = [
            solve_power_channel(blocksize, relinvovl, f, bw)
            for f, bw in channels
        ]
        masks = np.zeros((blocksize, len(self.geometry)), np.float32)
        for i, g in enumerate(self.geometry):
            masks[g.measure_start:g.measure_stop, i] = 1.0
        self.register_buffer("measure_masks", torch.from_numpy(masks))
        self.register_buffer("delta", torch.tensor(
            [g.delta_phase for g in self.geometry], dtype=torch.int32
        ))

        by_width = {}
        for i, g in enumerate(self.geometry):
            by_width.setdefault(g.extract_width, []).append(i)
        self.buckets = []
        for width in sorted(by_width):
            ids = by_width[width]
            starts = np.array(
                [self.geometry[i].extract_start for i in ids], np.int32
            )
            wins = np.stack([
                sine_flank_window_bank(
                    width,
                    self.geometry[i].measure_stop
                    - self.geometry[i].measure_start,
                    relinvovl,
                )[0].real
                for i in ids
            ]).astype(np.float32)
            bucket = _Bucket(
                width=width, out_len=width - width // relinvovl,
                channel_ids=tuple(ids), starts=starts, windows=wins,
                name=f"w{width}",
            )
            self.buckets.append(bucket)
            self.register_buffer(f"{bucket.name}_starts",
                                 torch.from_numpy(starts))
            self.register_buffer(f"{bucket.name}_folded", torch.from_numpy(
                bucket_folded(
                    blocksize, starts, wins,
                    keep_from=width - bucket.out_len, gain=1.0,
                )
            ))

    @property
    def num_channels(self) -> int:
        return len(self.geometry)

    def tables(self, bucket: _Bucket):
        """(starts, folded) device tables of a bucket."""
        return (getattr(self, f"{bucket.name}_starts"),
                getattr(self, f"{bucket.name}_folded"))

    def init_state(self, device):
        """Per-channel carry: active flag, last-block power (float max
        suppresses an initial activation, reference:
        lib/PowerActivationChannel_impl.cc:92), window phase."""
        c = self.num_channels
        return {
            "active": torch.zeros(c, dtype=torch.bool, device=device),
            "lastpower": torch.full((c,), float(_FLOAT_MAX),
                                    dtype=torch.float32, device=device),
            "phase": torch.zeros(c, dtype=torch.int32, device=device),
        }

    def measure(self, sq: torch.Tensor) -> torch.Tensor:
        """[B, N] |X|^2 -> [B, C] floored in-band powers."""
        return torch.clamp(band_power(sq, self.measure_masks),
                           min=float(_FLOAT_MIN))

    def scan_flags(self, powers: torch.Tensor, state):
        """The hysteresis automaton over [B, C] powers (kernel D; the
        contract of ``fdc_tpu.models.power_activation.PowerActivationBank.
        scan_flags``). Returns (new_state, (rise, fall, processed,
        phase_used)), flags [C, B]."""
        return powact.powact_flags(powers, state, self.delta,
                                   r=self.relinvovl, thresh=self.thresh)
