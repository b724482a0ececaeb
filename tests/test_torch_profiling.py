"""Timing-utility contracts of fdc_tpu_torch.utils.profiling, on the CPU.

The semantics of ``tests/test_profiling.py`` (fields, estimator plumbing,
rounds aligned across specs, checksum cover), not absolute times; plus
what the port adds: the timer each stats dict names, each step reading a
fresh perturbed input, and ``measure_samples_per_sec`` on a port
channelizer. On the CPU the timer is the host clock; the card's CUDA
graph / CUDA event timers run in ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from fdc_tpu_torch import FrequencyDomainChannelizer
from fdc_tpu_torch.flagship import _flagship
from fdc_tpu_torch.utils.profiling import (
    checksum,
    measure_samples_per_sec,
    time_scanned,
    time_scanned_paired,
    time_scanned_stats,
)

FIELDS = ("median", "q25", "q75", "min", "max", "n")


def _step_mul(c, x, t):
    nc = c * 1.0000001
    return nc, x * nc


def test_time_scanned_stats_fields():
    st = time_scanned_stats(_step_mul, torch.tensor(1.0), torch.ones(64),
                            k=4, repeats=5)
    for f in FIELDS:
        assert f in st
    assert st["n"] >= 5
    assert st["q25"] <= st["median"] <= st["q75"]
    assert st["min"] <= st["q25"] and st["q75"] <= st["max"]
    assert st["median"] > 0
    assert st["timer"] == "host clock"


def test_time_scanned_paired_rounds_aligned():
    """Each spec gets one diff per round, index-aligned across specs,
    and the per-spec stats match their own rounds."""

    def step_b(c, x, t):
        nc = c + 1.0
        return nc, x.sum() + nc

    stats = time_scanned_paired(
        [(_step_mul, torch.tensor(1.0), (torch.ones(64),), 4, 0),
         (step_b, torch.tensor(0.0), (torch.ones(32),), 8, 0)],
        repeats=6,
    )
    assert len(stats) == 2
    a, b = stats
    assert a["n"] == b["n"] == 6
    assert len(a["rounds"]) == len(b["rounds"]) == 6
    for st in stats:
        assert sorted(st["rounds"])[st["n"] // 2] == st["median"]
        assert st["median"] > 0
        assert [len(p) for p in st["pair_rounds"]] == [1] * 6


def test_time_scanned_paired_pairs_per_round():
    stats = time_scanned_paired(
        [(_step_mul, torch.tensor(1.0), (torch.ones(8),), 2, None)],
        repeats=5, pairs_per_round=3)
    st = stats[0]
    assert [len(p) for p in st["pair_rounds"]] == [3] * 5
    for r, p in zip(st["rounds"], st["pair_rounds"]):
        assert r == sorted(p)[1]  # each round's value: its pairs' median


def test_checksum_covers_all_leaves():
    tree = {"a": torch.ones(3), "b": [torch.full((2,), 2.0),
                                      torch.zeros(())],
            "c": (torch.tensor([True, False]),
                  torch.tensor([3 + 4j], dtype=torch.complex64),
                  torch.tensor([-2], dtype=torch.int32)),
            "d": "not a tensor"}
    v = checksum(tree)
    assert v.dtype == torch.float32 and v.shape == ()
    assert float(v) == 3.0 + 4.0 + 0.0 + 1.0 + 5.0 + 2.0
    assert float(checksum({})) == 0.0


def test_time_scanned_matches_stats_median():
    t1 = time_scanned(_step_mul, torch.tensor(1.0), torch.ones(16), k=4,
                      repeats=5)
    assert t1 > 0


@pytest.mark.parametrize("perturb_arg", [0, None])
def test_each_step_reads_a_fresh_input(perturb_arg):
    """With ``perturb_arg`` every step gets a new tensor made from the
    previous outputs' checksum (equal in value to the buffer: the 1e-38
    perturbation rounds away); without it, the buffer itself."""
    x = torch.ones(16)
    seen = []

    def step(c, xin, t):
        seen.append((t, xin))
        return c + 1.0, xin * 2.0

    time_scanned_stats(step, torch.tensor(0.0), x, k=3, repeats=5,
                       perturb_arg=perturb_arg)
    assert sorted({t for t, _ in seen}) == list(range(6))  # K and 2K
    for _, xin in seen:
        assert torch.equal(xin, x)
        assert (xin is x) == (perturb_arg is None)


def test_measure_samples_per_sec_on_a_port_channelizer():
    fdc = FrequencyDomainChannelizer(
        _flagship(blocksize=256, batch_blocks=4, n_channels=4,
                  max_extract_width=64, extract_budget=2), device="cpu")
    rate = measure_samples_per_sec(fdc, k=2)
    assert np.isfinite(rate) and rate > 0
