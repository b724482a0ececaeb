"""The configurations the port's main paths run.

- :func:`_flagship`: same parameters as ``_flagship`` in the repository's
  ``__graft_entry__.py``: 64 equally spaced throughput channels across
  80% of the band, one burst channel and one detection segment with 16
  slots, exact all-edges detection, slot extraction width 512 with an
  8-row budget.
- :func:`reference_example`: the upstream project's example flowgraph.
- :func:`powact32`: BASELINE config 3, a bank of 32 burst channels.
"""

from __future__ import annotations

from fdc_tpu_torch.config import ChannelizerConfig

__all__ = ["_flagship", "reference_example", "powact32", "EXAMPLE_CHANNELS"]

# the example's four channels (normalized baseband), each both a
# throughput and a burst channel
EXAMPLE_CHANNELS = ((0.12, 0.05), (0.22, 0.1), (-0.14, 0.12), (0.0, 0.081))


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


def reference_example(**overrides):
    """The reference's example flowgraph, as ``examples/fdc_example.py:27,
    69-82`` ports it: the same four channels as throughput and burst
    channels, one detection segment. Changed from the demo: the flagship's
    batch (512 blocks, not 32), no debug spectrum, and slot extraction
    width 1024 — exact for this segment, whose widest detection (500 bins,
    times the 1.4 flank margin = 700) rounds to 1024."""
    kw = dict(
        blocksize=4096,
        relinvovl=4,
        throughput_channels=EXAMPLE_CHANNELS,
        activity_controlled_channels=EXAMPLE_CHANNELS,
        activity_detection_segments=[(0.30, 0.42)],
        act_contr_threshold=10.0,
        act_det_threshold=6.0,
        minchandist=0.005,
        minchanflankpuffer=0.2,
        freqmode="normalized",
        batch_blocks=512,
        debug=False,
        max_extract_width=1024,
    )
    kw.update(overrides)
    return ChannelizerConfig(**kw)


def powact32(**overrides):
    """BASELINE config 3 (``tools/bench_configs.py:62-67``, "cfg3_powact32"):
    32 equally spaced power-activation channels at 10 dB, no throughput
    channels and no detection segments, B=512."""
    chans = [(-0.4 + 0.8 * (i + 0.5) / 32, 0.8 / 32 * 0.9)
             for i in range(32)]
    kw = dict(
        blocksize=4096,
        relinvovl=4,
        activity_controlled_channels=chans,
        act_contr_threshold=10.0,
        freqmode="normalized",
        batch_blocks=512,
    )
    kw.update(overrides)
    return ChannelizerConfig(**kw)
