"""The configurations the port's main paths run.

- :func:`_flagship`: same parameters as ``_flagship`` in the repository's
  ``__graft_entry__.py``: 64 equally spaced throughput channels across
  80% of the band, one burst channel and one detection segment with 16
  slots, exact all-edges detection, slot extraction width 512 with an
  8-row budget.
- :func:`reference_example`: the upstream project's example flowgraph.
- :func:`powact32`: BASELINE config 3, a bank of 32 burst channels.
- :func:`cfg1_single_static`, :func:`cfg2_dama16`, :func:`cfg4_segdet`,
  :func:`cfg5_burst_hunter512`, :func:`cfg5b_burst_hunter_4seg`: the
  other BASELINE configurations, with ``tools/bench_configs.py``'s
  parameters.
- :func:`cfg5s_burst_hunter_split4`: config 5's band as one segment split
  into 4 parts (``tools/ablate35_tpu.py``'s split configuration).
"""

from __future__ import annotations

from fdc_tpu_torch.config import ChannelizerConfig

__all__ = [
    "_flagship", "reference_example", "powact32", "cfg1_single_static",
    "cfg2_dama16", "cfg4_segdet", "cfg5_burst_hunter512",
    "cfg5b_burst_hunter_4seg", "cfg5s_burst_hunter_split4",
    "EXAMPLE_CHANNELS",
]

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


def _equal_channels(n):
    """n equally spaced channels across 80% of the band, 90% filled."""
    return [(-0.4 + 0.8 * (i + 0.5) / n, 0.8 / n * 0.9) for i in range(n)]


def _baseline(overrides, **kw):
    kw = dict(blocksize=4096, relinvovl=4, freqmode="normalized",
              batch_blocks=512, **kw)
    kw.update(overrides)
    return ChannelizerConfig(**kw)


def cfg1_single_static(**overrides):
    """BASELINE config 1 (``tools/bench_configs.py:50-54``): one static
    throughput channel."""
    return _baseline(overrides, throughput_channels=[(-0.2, 0.02)])


def cfg2_dama16(**overrides):
    """BASELINE config 2 (``tools/bench_configs.py:55-60``): 16 equally
    spaced static throughput channels, one shared-matrix bucket."""
    return _baseline(overrides, throughput_channels=_equal_channels(16))


def powact32(**overrides):
    """BASELINE config 3 (``tools/bench_configs.py:62-67``, "cfg3_powact32"):
    32 equally spaced power-activation channels at 10 dB, no throughput
    channels and no detection segments, B=512."""
    return _baseline(overrides,
                     activity_controlled_channels=_equal_channels(32),
                     act_contr_threshold=10.0)


def cfg4_segdet(**overrides):
    """BASELINE config 4 (``tools/bench_configs.py:70-78``): one detection
    segment over 90% of the band, 32 slots, bounded detection (16
    candidates), two-tier extraction (4 rows at w_cap 512, 16 at 64)."""
    return _baseline(
        overrides, activity_detection_segments=[(-0.45, 0.45)],
        act_det_threshold=6.0, minchandist=0.005, max_slots=32,
        max_candidates=16, max_extract_width=512, extract_budget=4,
        extract_width_split=64, extract_budget_narrow=16)


def cfg5_burst_hunter512(**overrides):
    """BASELINE config 5 (``tools/bench_configs.py:82-90``): config 4's
    band with 512 slots, 32 candidates, 8 wide + 32 narrow rows."""
    return _baseline(
        overrides, activity_detection_segments=[(-0.45, 0.45)],
        act_det_threshold=6.0, minchandist=0.005, max_slots=512,
        max_candidates=32, max_extract_width=512, extract_budget=8,
        extract_width_split=64, extract_budget_narrow=32)


def cfg5b_burst_hunter_4seg(**overrides):
    """BASELINE config 5b (``tools/bench_configs.py:97-108``): config 5's
    band as 4 segments of 128 slots, 2 wide + 8 narrow rows each."""
    return _baseline(
        overrides,
        activity_detection_segments=[(-0.45, -0.225), (-0.225, 0.0),
                                     (0.0, 0.225), (0.225, 0.45)],
        act_det_threshold=6.0, minchandist=0.005, max_slots=128,
        max_candidates=32, max_extract_width=512, extract_budget=2,
        extract_width_split=64, extract_budget_narrow=8)


def cfg5s_burst_hunter_split4(**overrides):
    """Config 5 split (``tools/ablate35_tpu.py:60-73``): config 5's band
    as ONE segment split into 4 parts with 2 cells of overlap, each part
    128 slots with config 5b's per-segment budgets (2 wide + 8 narrow
    rows)."""
    return _baseline(
        overrides, activity_detection_segments=[(-0.45, 0.45)],
        act_det_threshold=6.0, minchandist=0.005, max_slots=128,
        max_candidates=32, max_extract_width=512, extract_budget=2,
        extract_width_split=64, extract_budget_narrow=8,
        segment_splits=[(0, 4, 2)])
