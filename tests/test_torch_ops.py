"""fdc_tpu_torch's front end, extraction and kernel A against fdc_tpu.

Inputs are made with numpy from a seed and fed to both packages. Kernel
A's plain version is held against the Pallas kernel in interpret mode
(as tests/test_extract_pallas.py runs it); the CUDA kernel is held
against its plain version in tests/test_torch_kernels.py.

Tolerances: streams and extractions rtol 2e-4 / atol 2e-5 of each
tensor's max magnitude; power measures on a common spectrum rtol 1e-5
(another accumulation order); constant tables exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from __graft_entry__ import _flagship as jax_flagship
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.models.segment_detection import SegmentDetector as JaxSD
from fdc_tpu.ops import extract as jx_extract
from fdc_tpu.ops.extract_pallas import fused_extract_shared
from fdc_tpu.ops.fft import _rr_idft_matrix, forward_spectrum as jx_fwd
from fdc_tpu.ops.framing import frame_blocks as jx_frame
from fdc_tpu_torch import FrequencyDomainChannelizer
from fdc_tpu_torch.flagship import _flagship
from fdc_tpu_torch.models.segment_detection import SegmentDetector
from fdc_tpu_torch.ops import extract, extract_fused
from fdc_tpu_torch.ops.fft import forward_spectrum, interleave_rows
from fdc_tpu_torch.ops.framing import frame_blocks

RTOL, ATOL, PRTOL = 2e-4, 2e-5, 1e-5
SMALL = dict(blocksize=1024, batch_blocks=8, n_channels=16)


def assert_close_to_max(got, ref, rtol=RTOL, atol=ATOL):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    err = np.abs(got - ref)
    bound = atol * np.max(np.abs(ref)) + rtol * np.abs(ref)
    assert np.all(err <= bound), f"max abs err {err.max()}"


def cspec(rng, b, n):
    return (rng.standard_normal((b, n))
            + 1j * rng.standard_normal((b, n))).astype(np.complex64)


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_frame_and_spectrum_match_jax(seed):
    rng = np.random.default_rng(seed)
    n, b = 256, 6
    x = cspec(rng, 1, b * 192)[0]
    hist = cspec(rng, 1, 64)[0]
    jb, jh = jx_frame(jnp.asarray(x), jnp.asarray(hist), n)
    tb, th = frame_blocks(torch.from_numpy(x), torch.from_numpy(hist), n)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    # the JAX default (use_mxu_fft) is the four-step matmul DFT
    assert_close_to_max(forward_spectrum(tb).numpy(),
                        np.asarray(jx_fwd(jb, use_mxu=True)))


def test_constant_tables_match_jax(monkeypatch):
    """Bucket starts/windows, folded matrices, measure masks and columns,
    and the slot window table are the JAX package's, exactly."""
    monkeypatch.setenv("FDC_TPU_FUSED_INTERPRET", "1")  # engage the gates
    jf = JaxFDC(jax_flagship(**SMALL, native_emission=False))
    tf = FrequencyDomainChannelizer(_flagship(**SMALL), device="cpu")
    n = tf.config.blocksize
    pairs = [(jf.throughput, tf.throughput, True),
             (jf.power_bank, tf.power_bank, False)]
    for jm, tm, is_tp in pairs:
        assert len(jm.buckets) == len(tm.buckets)
        for jb, tb in zip(jm.buckets, tm.buckets):
            np.testing.assert_array_equal(tb.starts, jb.starts)
            np.testing.assert_array_equal(tb.windows, jb.windows)
            assert (tb.width, tb.out_len, tb.channel_ids) == (
                jb.width, jb.out_len, jb.channel_ids)
            starts, folded = tm.tables(tb)
            np.testing.assert_array_equal(starts.numpy(), jb.starts)
            keep = jb.width - jb.out_len
            gain = float(jb.width) if is_tp else 1.0
            ref = jx_extract._shared_fused_matrix(
                n, jb.starts, jb.windows, jb.width, keep, gain)
            np.testing.assert_array_equal(folded.numpy(),
                                          interleave_rows(ref))
            if is_tp:
                ref_m = jx_extract.measured_folded_matrix(
                    n, jb.starts, jb.windows, jb.width, keep, gain,
                    jf._measure_masks.shape[1])
                np.testing.assert_array_equal(folded.numpy(),
                                              interleave_rows(ref_m))
    np.testing.assert_array_equal(tf.measure_masks.numpy(),
                                  jf._measure_masks)
    assert tf._measure_cols == jf._measure_cols
    for jsd, tsd in zip(jf.segments, tf.segments):
        np.testing.assert_array_equal(tsd.window_table.numpy(),
                                      jsd.window_table)
        assert (tsd.k_detect, tsd.k_pack, tsd.w_cap, tsd.extract_budget) == (
            jsd.k_detect, jsd.k_pack, jsd.w_cap, jsd.extract_budget)
        assert vars(tsd.geometry) == vars(jsd.geometry)


def _bucket(rng, n, l, c, keep_from, gain):
    starts = np.sort(rng.choice(n - l, size=c, replace=False)).astype(
        np.int32)
    win = rng.random(l).astype(np.float32) + 0.1
    m = _rr_idft_matrix(l, keep_from, True, float(gain), pairs=True)
    folded = (np.concatenate([win, win])[:, None] * m).astype(np.float32)
    return starts, np.tile(win, (c, 1)), folded


@pytest.mark.parametrize("seed", [0, 3])
def test_extract_shared_plain_matches_pallas(seed):
    """Kernel A's plain version == fused_extract_shared(power_masks=...)
    in Pallas interpret mode."""
    b, n, l, c, keep_from, gain = 13, 512, 64, 5, 16, 64.0
    rng = np.random.default_rng(seed)
    spec = cspec(rng, b, n)
    starts, _, folded = _bucket(rng, n, l, c, keep_from, gain)
    masks = np.zeros((n, 128), np.float32)
    masks[40:90, 0] = 1.0
    masks[300:310, 1] = 1.0
    for cc in range(16):
        masks[100 + cc * 8:100 + (cc + 1) * 8, 2 + cc] = 1.0
    ref_y, ref_p = fused_extract_shared(
        jnp.asarray(spec), starts, folded, pairs=True, tb=8,
        power_masks=masks, interpret=True,
    )
    got_y, got_p = extract_fused.extract_shared(
        torch.from_numpy(spec), t32(starts),
        torch.from_numpy(interleave_rows(folded)), torch.from_numpy(masks),
    )
    assert got_y.shape == ref_y.shape and got_p.shape == ref_p.shape
    assert_close_to_max(got_y.numpy(), np.asarray(ref_y))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=PRTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_shared_burst_bucket_matches_pallas(seed):
    """The unmeasured form over a [B+1]-row batch (the burst bucket)."""
    b, n, l, keep_from = 9, 512, 32, 8
    rng = np.random.default_rng(seed)
    spec = cspec(rng, b, n)
    starts, _, folded = _bucket(rng, n, l, 1, keep_from, 1.0)
    ref = fused_extract_shared(jnp.asarray(spec), starts, folded,
                               pairs=True, tb=8, interpret=True)
    got = extract_fused.extract_shared(
        torch.from_numpy(spec), t32(starts),
        torch.from_numpy(interleave_rows(folded)))
    assert_close_to_max(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("measured", [False, True])
def test_extract_bucket_phased_matches_jax(measured):
    """Phase-compensated bucket extraction (and the measured form) ==
    fdc_tpu's extract_bucket_phased on its CPU path; measures == the
    band/cell reduces on the same spectrum (rtol 1e-5)."""
    from fdc_tpu.ops.detect import band_power

    b, n, l, c, r = 12, 256, 32, 3, 4
    rng = np.random.default_rng(1)
    spec = cspec(rng, b, n)
    starts, wins, _ = _bucket(rng, n, l, c, l // r, float(l))
    ref = jx_extract.extract_bucket_phased(
        jnp.asarray(spec), starts, wins, r, gain=float(l), use_mxu=True,
        keep_from=l // r)
    folded = torch.from_numpy(extract.shared_folded_matrix(
        n, starts, wins, keep_from=l // r, gain=float(l)))
    if measured:
        masks = np.zeros((n, 128), np.float32)
        masks[20:40, 0] = 1.0
        masks[100:110, 1] = 1.0
        got, powers = extract.extract_bucket_measured(
            torch.from_numpy(spec), t32(starts), folded, r,
            torch.from_numpy(masks))
        sq = jnp.abs(jnp.asarray(spec)) ** 2
        np.testing.assert_allclose(
            powers.numpy(), np.asarray(band_power(sq, jnp.asarray(masks))),
            rtol=PRTOL)
    else:
        got = extract.extract_bucket_phased(torch.from_numpy(spec),
                                            t32(starts), folded, r)
    assert_close_to_max(got.numpy(), np.asarray(ref))


def test_unequal_windows_take_per_channel_tables():
    """A bucket whose channels have different windows gets per-channel
    matrices (kernel E); its phased extraction == fdc_tpu's."""
    b, n, l, r = 12, 256, 32, 4
    rng = np.random.default_rng(0)
    spec = cspec(rng, b, n)
    starts = np.array([0, 20, 150], np.int32)
    wins = rng.random((3, l)).astype(np.float32)
    folded = extract.bucket_folded(n, starts, wins, l // r, float(l))
    assert folded.shape == (3, 2 * l, 2 * (l - l // r))
    ref = jx_extract.extract_bucket_phased(
        jnp.asarray(spec), starts, wins, r, gain=float(l), use_mxu=True,
        keep_from=l // r)
    got = extract.extract_bucket_phased(torch.from_numpy(spec), t32(starts),
                                        torch.from_numpy(folded), r)
    assert_close_to_max(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("use_mxu", [True, False])
def test_extract_slots_matches_jax(use_mxu):
    """Variable-width slot extraction (one fp32 matmul, or torch.fft on
    the FFT route) == fdc_tpu's extract_slots on random slot geometry."""
    args = (0, 1024, 4, 0.55, 0.8, 6.0, 0.02, 0.2)
    kw = dict(max_slots=8, max_extract_width=128, extract_budget=5,
              use_mxu=use_mxu)
    jsd, tsd = JaxSD(*args, **kw), SegmentDetector(*args, **kw)
    rng = np.random.default_rng(4)
    spec = cspec(rng, 9, 1024)
    st = {k: np.asarray(v) for k, v in jsd.init_state().items()}
    st["wlog2"] = rng.integers(0, 8, 8).astype(np.int32)
    st["ext_start"] = rng.integers(0, 1024 - 4, 8).astype(np.int32)
    ids = np.array([6, 1, 7, 0, 3], np.int32)
    ref = jsd.extract_slots(jnp.asarray(spec),
                            {k: jnp.asarray(v) for k, v in st.items()},
                            jnp.asarray(ids), pairs=True)
    got = tsd.extract_slots(torch.from_numpy(spec),
                            {k: torch.from_numpy(np.array(v))
                             for k, v in st.items()},
                            t32(ids))
    assert_close_to_max(got.numpy(), np.asarray(ref))
