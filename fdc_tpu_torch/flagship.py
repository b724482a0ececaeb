"""The flagship configuration (the main path of the system).

Same parameters as ``_flagship`` in the repository's ``__graft_entry__.py``:
64 equally spaced throughput channels across 80% of the band, one burst
channel and one detection segment with 16 slots, exact all-edges
detection, slot extraction width 512 with an 8-row budget.
"""

from __future__ import annotations

from fdc_tpu_torch.config import ChannelizerConfig

__all__ = ["_flagship"]


def _flagship(blocksize=4096, batch_blocks=8, n_channels=64, **overrides):
    chans = [
        (-0.4 + 0.8 * (i + 0.5) / n_channels, 0.8 / n_channels * 0.9)
        for i in range(n_channels)
    ]
    kw = dict(
        blocksize=blocksize,
        relinvovl=4,
        throughput_channels=chans,
        activity_controlled_channels=[(-0.45, 0.02)],
        activity_detection_segments=[(0.41, 0.49)],
        freqmode="normalized",
        batch_blocks=batch_blocks,
        max_slots=16,
        max_candidates=0,
        max_extract_width=512,
        extract_budget=8,
    )
    kw.update(overrides)
    return ChannelizerConfig(**kw)
