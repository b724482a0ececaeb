"""The traffic generator: the same ring for the same seed, a ring that
replays seamlessly across its end, and a bursty mix that opens and
retires detection channels in every batch (on the plain reference)."""

import numpy as np
import pytest

from bench_small import small
from benchmark import harness
from benchmark.reference import channelizer as ref
from benchmark.traffic import generator

CELLS = ("flagship.mixed", "hunter4seg.bursty")


def cell(workload):
    _, config, mix = harness.cell_of(harness.bench_file(), workload)
    co, mo = small(workload)
    return dict(config["channelizer"], **co), dict(mix, **mo)


@pytest.mark.parametrize("workload", CELLS)
def test_same_seed_same_ring(workload):
    cfg, mix = cell(workload)
    a = generator.ring(cfg, mix, 2**31 + 5)
    b = generator.ring(cfg, mix, 2**31 + 5)
    c = generator.ring(cfg, mix, 2**31 + 6)
    assert a.dtype == np.complex64
    assert len(a) == mix["ring_batches"] * cfg["batch_blocks"] * 3072
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("seed", [3, -7, 2**40 + 1])
def test_seeds_beyond_32_bits(seed):
    cfg, mix = cell("hunter4seg.bursty")
    sch = generator.schedule(cfg, mix, seed)
    again = generator.schedule(cfg, mix, seed)
    assert sch and [(c["first"], c["blocks"]) for c in sch] == [
        (c["first"], c["blocks"]) for c in again]


@pytest.mark.parametrize("workload", CELLS)
def test_ring_replays_seamlessly(workload):
    """Over two periods of the ring, the second period detects every
    scheduled carrier once, as one channel: a carrier across the ring's
    end (there is one in each mix) is not cut in two."""
    cfg, mix = cell(workload)
    seed = 11
    x = generator.ring(cfg, mix, seed)
    p = mix["ring_batches"]
    bs = len(x) // p
    sch = generator.schedule(cfg, mix, seed)
    ring_blocks = p * cfg["batch_blocks"]
    assert any(c["first"] + c["blocks"] > ring_blocks for c in sch)
    outs = ref.run(cfg, lambda j: x[(j % p) * bs:(j % p + 1) * bs],
                      3 * p)
    for kind, source in (("segment", "DETECTED"), ("burst", "PowActChan")):
        want = sorted((c["unit"], c["first"] % ring_blocks)
                      for c in sch if c["kind"] == kind)
        got = []
        for o in outs:
            for e in o.events:
                if e["source"] == source and e["finalized"]:
                    got.append((e["unit"], e["blockstart"] + 1))
        # channels that opened in the second period, by their first block
        second = sorted((u, b % ring_blocks) for u, b in got
                        if ring_blocks <= b < 2 * ring_blocks)
        assert second == want, kind


def test_bursty_opens_and_retires_every_batch():
    cfg, mix = cell("hunter4seg.bursty")
    x = generator.ring(cfg, mix, 2024)
    p = mix["ring_batches"]
    bs = len(x) // p
    outs = ref.run(cfg, lambda j: x[(j % p) * bs:(j % p + 1) * bs], 2 * p)
    for o in outs[1:]:
        assert min(o.opened) >= 5 and min(o.retired) >= 5, (o.opened,
                                                              o.retired)


def test_capacity_is_checked():
    """Traffic past the extraction budget raises; the program would lose
    the samples of the slots beyond it."""
    cfg, mix = cell("hunter4seg.bursty")
    lanes = mix["segments"]["lanes"]
    mix = dict(mix, segments=dict(mix["segments"], lanes=[
        dict(lanes[0], widths=[4])] * 3 + lanes[1:4]))
    x = generator.ring(cfg, mix, 5)
    bs = len(x) // mix["ring_batches"]
    with pytest.raises(ref.CapacityError):
        ref.run(cfg, lambda j: x[j * bs:(j + 1) * bs], 2)
