"""A seeded fuzz of fdc_tpu_torch against fdc_tpu over the parameter space.

``tests/test_config_fuzz.py``'s ``random_config`` draws blocksizes 128 to
2048, relinvovl 2, 4 and 8, 0-3 throughput channels, 0-2 burst channels,
0-2 detection segments (sometimes split), random thresholds, flank
margins, budgets and two-tier extraction. Each draw runs in both packages
with both settings of ``use_mxu_fft`` on the same seeded capture (noise
and tones in the first channels, as that test feeds), step outputs key
by key over two steps, then process + flush: events, streams and powers.
Blocksizes below 256 take the ``torch.fft`` front end either way.

Tolerances (ROADMAP "How a part is held"): flags, tables, plans,
counters and event metadata exact; streams rtol 2e-4 / atol 2e-5 of the
max; powers 1e-5 of the max.
"""

import numpy as np
import pytest
import torch

from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu_torch import ChannelizerConfig, FrequencyDomainChannelizer

from test_config_fuzz import random_config
from test_torch_pipeline import stream
from test_torch_slice import (
    ATOL,
    PRTOL,
    RTOL,
    assert_close_to_max,
    assert_events_match,
    assert_outputs_match,
    jax_step,
)

DRAWS = range(2000, 2006)


def draw_config(draw):
    rng = np.random.default_rng(draw)
    cfg = random_config(rng)
    if not (cfg.throughput_channels or cfg.activity_controlled_channels
            or cfg.activity_detection_segments):
        cfg = cfg.replace(throughput_channels=[(0.1, 0.05)])
    return cfg.replace(native_emission=False), rng


def draw_capture(cfg, rng):
    n = 3 * cfg.batch_blocks * cfg.inplen + int(rng.integers(1, cfg.inplen))
    t = np.arange(n)
    x = (0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    for f, _ in (list(cfg.throughput_channels)
                 + list(cfg.activity_controlled_channels))[:3]:
        x += np.exp(2j * np.pi * f * t).astype(np.complex64)
    return x


def test_draws_cover_the_space():
    """The draws reach small and large blocksizes, every relinvovl and
    every kind of bank, so both front ends and both knob routes run."""
    cfgs = [draw_config(d)[0] for d in DRAWS]
    assert min(c.blocksize for c in cfgs) < 256 <= max(c.blocksize
                                                       for c in cfgs)
    assert {c.relinvovl for c in cfgs} == {2, 4, 8}
    assert any(c.activity_detection_segments for c in cfgs)
    assert any(c.activity_controlled_channels for c in cfgs)
    assert any(c.segment_splits for c in cfgs)


@pytest.mark.parametrize("use_mxu", [True, False])
@pytest.mark.parametrize("draw", DRAWS)
def test_random_config_matches_jax(draw, use_mxu):
    jcfg, rng = draw_config(draw)
    jcfg = jcfg.replace(use_mxu_fft=use_mxu)
    x = draw_capture(jcfg, rng)
    pcfg = ChannelizerConfig.from_dict(jcfg.to_dict())
    jf = JaxFDC(jcfg)
    tf = FrequencyDomainChannelizer(pcfg, device="cpu")
    bs = tf.batch_samples
    jc, tc = jf._jit_init(), tf._device_init()
    for step in range(2):
        chunk = x[step * bs:(step + 1) * bs]
        t0 = step * pcfg.batch_blocks
        jc, jo = jax_step(jf, jc, chunk, t0)
        tc, to = tf._device_step(tc, torch.from_numpy(chunk), t0)
        assert_outputs_match(to, jo, f"draw {draw} step {step}")
    jf.reset()
    (ev, tp, pw), (ev_j, tp_j, pw_j) = (stream(tf, x, len(x)),
                                        stream(jf, x, len(x)))
    if ev_j:
        assert_events_match(ev, ev_j)
    else:
        assert not ev
    for a, b in zip(tp, tp_j):
        assert a.shape == b.shape
        assert_close_to_max(a, b, RTOL, ATOL, "throughput stream")
    for a, b in zip(pw, pw_j):
        assert a.shape == b.shape
        assert_close_to_max(a, b, 0.0, PRTOL, "segment power")
