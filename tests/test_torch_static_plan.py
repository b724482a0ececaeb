"""Kernel E's plan rule (``extract_fused.static_plan``), on the CPU.

Kernel E (``csrc/extract_static.cu``) runs kernel A's GEMM body with a
matrix per channel, so a row tile never straddles two channels; a
channel's last tile also computes the rows past its whole tiles when
there are at most ``STATIC_TAIL`` of them (R = 513 on every path). The
rule is held on every kernel E call that the paths of ``chip_smoke.py``
make (recorded from one step at 8 blocks a batch; the bucket rows 8 / 9
become 512 / 513) and on the prototype's bucket: the tiles cover each
channel's rows and the output columns exactly, the k splits cover K,
and no CTA is a whole tile for one or two rows.
"""

import pytest
import torch

from fdc_tpu_torch.ops import extract_fused

from test_torch_radix import path_configs

ROWS = {8: 512, 9: 513}


def e_calls(cfg):
    """(C, rows, K, nout) of every kernel E call of one step at B = 512."""
    from fdc_tpu_torch import FrequencyDomainChannelizer

    calls = []
    fdc = FrequencyDomainChannelizer(cfg, device="cpu")
    saved = extract_fused.extract_static

    def rec(spec, starts, mats):
        calls.append((starts.numel(), ROWS[spec.shape[0]],
                      mats.shape[1], mats.shape[2]))
        return saved(spec, starts, mats)

    try:
        extract_fused.extract_static = rec
        x = torch.zeros(fdc.batch_samples, dtype=torch.complex64)
        fdc._device_step(fdc._device_init(), x, 0)
    finally:
        extract_fused.extract_static = saved
    return calls


@pytest.fixture(scope="module")
def buckets():
    out = {name: e_calls(cfg) for name, cfg in path_configs().items()}
    # only the example fuses throughput and burst channels into buckets
    assert {n for n, c in out.items() if c} == {"example"}
    # the prototype's function: the flagship's bucket 0, a matrix each
    out["prototype"] = [(64, 512, 128, 96)]
    return out


def test_static_plan_on_every_path_bucket(buckets):
    seen = set()
    for name, calls in buckets.items():
        for c, rows, k, nout in calls:
            seen.add((name, c, rows, k, nout))
            bm, bn, splits, k_chunk, tail = extract_fused.static_plan(
                c, rows, k, nout)
            row_tiles = rows // bm if tail else -(-rows // bm)
            # each channel's rows: whole tiles and at most two tail rows,
            # or a ragged last tile
            if tail:
                assert 0 < tail <= extract_fused.STATIC_TAIL
                assert row_tiles * bm + tail == rows
            else:
                assert (row_tiles - 1) * bm < rows <= row_tiles * bm
                assert rows % bm == 0 or (rows % bm > extract_fused.STATIC_TAIL
                                          or rows < bm)
            cols = -(-nout // bn)
            assert (cols - 1) * bn < nout <= cols * bn
            assert 8 * (cols * bn - nout) <= nout, (name, nout, bn)
            assert (splits - 1) * k_chunk < k <= splits * k_chunk
            assert k_chunk % extract_fused.BK == 0
            assert k_chunk >= extract_fused.MIN_SPLIT_STAGES * extract_fused.BK
    # the buckets the kernel table names: w256, w512 and the prototype's
    assert ("example", 2, 513, 512, 384) in seen
    assert ("example", 5, 513, 1024, 768) in seen
    assert ("prototype", 64, 512, 128, 96) in seen


def test_static_plan_folds_the_513th_row(buckets):
    """R = 513 = 4 * 128 + 1: four tiles a channel, the fourth with the
    last row (a fifth tile would be a whole tile's FFMAs for one row)."""
    for c, rows, k, nout in buckets["example"]:
        bm, _, _, _, tail = extract_fused.static_plan(c, rows, k, nout)
        assert (bm, tail) == (128, 1)
    assert extract_fused.static_plan(64, 512, 128, 96)[4] == 0
    # three rows past the whole tiles: a ragged fifth tile instead
    assert extract_fused.static_plan(5, 515, 1024, 768)[4] == 0
    # fewer rows than a tile: one ragged tile
    assert extract_fused.static_plan(5, 2, 128, 96)[4] == 0


@pytest.mark.parametrize("shape, plan", [
    ((5, 513, 1024, 768), (128, 128, 1, 1024, 1)),  # w512: 120 CTAs
    ((2, 513, 512, 384), (128, 96, 8, 64, 1)),      # w256: 32 tiles
    ((64, 512, 128, 96), (128, 96, 1, 128, 0)),     # prototype: 256
    ((16, 513, 512, 384), (128, 96, 1, 512, 1)),    # 192 wide tiles
    ((5, 13, 128, 96), (128, 96, 4, 32, 0)),        # one ragged tile
])
def test_static_plan_rule(shape, plan):
    """The widest tile unsplit where its grid (one CTA an SM) fills 3/4
    to all of the SMs; else kernel A's width and k split rule."""
    assert extract_fused.static_plan(*shape) == plan
