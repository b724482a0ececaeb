"""The burst paths of fdc_tpu_torch against fdc_tpu.

Kernel-level parity on the CPU (the port through its plain versions, the
JAX package through its Pallas kernels in interpret mode or its
``lax.scan`` path), then whole-slice parity for the configurations that
run kernels D (``ops.powact``) and E (``extract_fused.extract_static``):
the upstream example (fused throughput + burst buckets whose channels
have different windows), the example without its segment (the
standalone burst chain), BASELINE config 3 (32 burst channels) and a
throughput bucket of two bandwidths. Inputs are made with numpy from a
seed.

Tolerances (ROADMAP "How a part is held"): flags, slot tables, counters
and event metadata exact; streams and extractions rtol 2e-4 / atol 2e-5
of each tensor's max; powers 1e-5 of each tensor's max.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fdc_tpu.config import ChannelizerConfig as JaxConfig
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.models.power_activation import PowerActivationBank as JaxBank
from fdc_tpu.ops.extract_pallas import fused_extract_static
from fdc_tpu.ops.fft import _rr_idft_matrix as jax_rr_idft_matrix
from fdc_tpu_torch import FrequencyDomainChannelizer
from fdc_tpu_torch.config import ChannelizerConfig
from fdc_tpu_torch.flagship import EXAMPLE_CHANNELS, powact32, reference_example
from fdc_tpu_torch.ops import extract, extract_fused, powact
from fdc_tpu_torch.ops.fft import interleave_rows
from test_torch_slice import (
    ATOL,
    RTOL,
    assert_close_to_max,
    assert_events_match,
    assert_outputs_match,
    jax_step,
    meta,
)

FLT_MIN = np.float32(1.1754944e-38)
FLT_MAX = np.float32(3.4028235e38)
SMALL = dict(blocksize=1024, batch_blocks=8)


def jax_twin(cfg):
    """The JAX package's channelizer on the same configuration."""
    return JaxFDC(JaxConfig.from_dict(cfg.replace(native_emission=False)
                                      .to_dict()))


def capture(cfg, n_batches, tail, seed=0):
    """Noise; an exact-bin tone at the centre of every throughput channel
    (amplitude 0.05, ~25 dB under the burst carriers); a multi-tone
    carrier gated on and off in every burst channel, at staggered times;
    band-limited carriers appearing and vanishing in every detection
    segment. Power ratios sit far from the thresholds except at edges."""
    rng = np.random.default_rng(seed)
    n = cfg.blocksize
    blk = cfg.batch_blocks * cfg.inplen
    n_samples = n_batches * blk + tail

    def periodic(bins, amps):
        spec = np.zeros(n, np.complex128)
        spec[np.asarray(bins) % n] = amps
        return np.resize(np.fft.ifft(spec) * n, n_samples)

    def gate(a, b):
        g = np.zeros(n_samples)
        g[int(a * blk):int(b * blk)] = 1.0
        return g

    x = 0.01 * (rng.standard_normal(n_samples)
                + 1j * rng.standard_normal(n_samples))
    for f, _ in cfg.throughput_channels:
        x += periodic([round(f * n)], [0.05])
    for i, (f, bw) in enumerate(cfg.activity_controlled_channels):
        k = max(2, int(bw * n / 4))
        a = 0.3 + 0.45 * (i % 5)
        ph = np.exp(1j * rng.uniform(0, 2 * np.pi, k))
        x += gate(a, a + 1.2 + 0.3 * (i % 3)) * periodic(
            round(f * n) - k // 2 + np.arange(k), 0.5 * ph)
    for lo, hi in cfg.activity_detection_segments:
        for frac, a, b in ((0.1, 0.3, 1.7), (0.45, 1.2, 3.6),
                           (0.75, 3.1, 4.4)):
            ph = np.exp(1j * rng.uniform(0, 2 * np.pi, 12))
            x += gate(a, b) * periodic(
                round((lo + frac * (hi - lo)) * n) + np.arange(12), 0.3 * ph)
    return x.astype(np.complex64)


# -- kernel D's plain version against the JAX automaton ---------------------


@pytest.mark.parametrize("nb", [64, 37], ids=["B=64", "B=37"])
def test_powact_plain_matches_jax(nb):
    """powact_flags_plain == PowerActivationBank.scan_flags on the Pallas
    (interpret) and lax.scan backends, exactly, with the init edge
    (lastpower = FLT_MAX) and the zero-power floor (FLT_MIN)."""
    chans = [(0.2, 0.03), (0.45, 0.05), (0.7, 0.02), (0.85, 0.04),
             (0.3, 0.01)]
    scan = JaxBank(1024, 4, chans, 10.0, "scan")
    pallas = JaxBank(1024, 4, chans, 10.0, "pallas_interpret")
    c = scan.num_channels
    rng = np.random.default_rng(11)
    powers = np.exp(rng.normal(0, 2.0, (nb, c))).astype(np.float32)
    powers[3:5, 1] = FLT_MIN  # floored silence: lastpower / pwr = inf
    powers[9, 2] = FLT_MIN
    powers[0, 3] = FLT_MIN
    state = {
        "active": rng.random(c) < 0.5,
        "lastpower": np.exp(rng.normal(0, 2.0, c)).astype(np.float32),
        "phase": rng.integers(0, 4, c).astype(np.int32),
    }
    state["lastpower"][[0, 3]] = FLT_MAX  # a freshly initialised channel
    state["active"][3] = True
    delta = np.array([g.delta_phase for g in scan.geometry], np.int32)

    got_state, got = powact.powact_flags_plain(
        torch.from_numpy(powers),
        {k: torch.from_numpy(v) for k, v in state.items()},
        torch.from_numpy(delta), r=4, thresh=scan.thresh)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    for bank in (scan, pallas):
        ref_state, ref = bank.scan_flags(jnp.asarray(powers), jstate)
        for k in ref_state:
            np.testing.assert_array_equal(got_state[k].numpy(),
                                          np.asarray(ref_state[k]), err_msg=k)
        for nm, a, b in zip(("rise", "fall", "processed", "phase_used"),
                            got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=nm)
    rise, fall = got[0].numpy(), got[1].numpy()
    assert rise.any() and fall.any()
    assert not rise[0, 0]  # pwr / FLT_MAX never rises
    assert fall[3, 0]  # FLT_MAX / FLT_MIN = inf falls


# -- kernel E's plain version and tables against the JAX fold ----------------


def jax_fold(windows, l, keep_from, gain):
    """The JAX package's [C, 2l, 2k] per-channel fold (rows planar)."""
    m = jax_rr_idft_matrix(l, keep_from, True, float(gain), pairs=True)
    return (np.concatenate([windows, windows], axis=1)[:, :, None]
            * m[None]).astype(np.float32)


@pytest.mark.parametrize("b,n,l,c,keep_from,gain", [
    (13, 512, 64, 5, 16, 64.0),   # odd row count: ragged tiles
    (33, 1024, 128, 3, 32, 1.0),
    (9, 256, 32, 2, 8, 32.0),
])
def test_extract_static_plain_matches_jax(b, n, l, c, keep_from, gain):
    """extract_static_plain on the port's tables == fused_extract_static
    (Pallas, interpret mode) on the JAX fold."""
    rng = np.random.default_rng(5)
    spec = (rng.standard_normal((b, n))
            + 1j * rng.standard_normal((b, n))).astype(np.complex64)
    starts = np.sort(rng.choice(n - l, c, replace=False)).astype(np.int32)
    wins = rng.random((c, l)).astype(np.float32) + 0.1
    ref = fused_extract_static(jnp.asarray(spec), starts,
                               jax_fold(wins, l, keep_from, gain),
                               pairs=True, tb=8, interpret=True)
    mats = extract.static_folded_matrices(n, starts, wins, keep_from, gain)
    got = extract_fused.extract_static_plain(
        torch.from_numpy(spec), torch.from_numpy(starts),
        torch.from_numpy(mats))
    assert got.shape == ref.shape
    assert_close_to_max(got.numpy(), np.asarray(ref), RTOL, ATOL,
                        "extract_static")


def test_static_folded_matrices_match_jax_fold():
    """The per-channel tables are the JAX fold with kernel A's row
    interleave; bucket_folded picks the shared matrix only for equal
    windows."""
    rng = np.random.default_rng(6)
    n, l, keep_from = 256, 32, 8
    starts = np.array([3, 40, 100], np.int32)
    wins = rng.random((3, l)).astype(np.float32)
    mats = extract.static_folded_matrices(n, starts, wins, keep_from, 32.0)
    ref = jax_fold(wins, l, keep_from, 32.0)
    assert mats.shape == ref.shape == (3, 2 * l, 2 * (l - keep_from))
    for c in range(3):
        np.testing.assert_array_equal(mats[c], interleave_rows(ref[c]))
    assert extract.bucket_folded(n, starts, wins, keep_from, 32.0).ndim == 3
    same = np.repeat(wins[:1], 3, axis=0)
    shared = extract.bucket_folded(n, starts, same, keep_from, 32.0)
    np.testing.assert_array_equal(shared, mats[0])
    with pytest.raises(ValueError):
        extract.static_folded_matrices(n, starts + 230, wins, keep_from, 1.0)


# -- the configurations ------------------------------------------------------


def test_full_size_bucket_plans():
    """At full width the port builds the JAX package's fused plan: the
    example's fused buckets 256 (C=2) and 512 (C=5) with per-channel
    tables, a shared-matrix 1024 throughput bucket; config 3's one
    shared 128-wide bucket of 32 channels."""
    ex = reference_example()
    tf = FrequencyDomainChannelizer(ex, device="cpu")
    jf = jax_twin(ex)
    assert set(tf._fused) == set(jf._fused_widths) == {256, 512}
    for w, (name, tb) in tf._fused.items():
        starts, _, n_tp, _, _ = jf._fused_widths[w]
        folded = getattr(tf, f"{name}_folded")
        assert len(tb.channel_ids) == n_tp and tb.width == w
        assert folded.dim() == 3 and folded.shape[0] == len(starts)
        np.testing.assert_array_equal(getattr(tf, f"{name}_starts").numpy(),
                                      starts)
    assert [tf._fused[w][1].channel_ids for w in (256, 512)] == [(0,), (1, 3)]
    assert [b.width for b in tf.throughput.buckets] == [256, 512, 1024]
    assert tf.throughput.tables(tf.throughput.buckets[2])[1].dim() == 2
    assert tf.segments[0].w_cap == 1024
    pa = FrequencyDomainChannelizer(powact32(), device="cpu").power_bank
    (bucket,) = pa.buckets
    assert bucket.width == 128 and len(bucket.channel_ids) == 32
    assert pa.tables(bucket)[1].shape == (256, 192)


CONFIGS = {
    # fused buckets 64 (C=2) and 128 (C=5), a non-fused 256 bucket with
    # the measures, one detection segment with the burst chain in kernel C
    "example": reference_example(**SMALL),
    # the same without the segment: the burst chain in kernel D
    "example-no-segment": reference_example(**SMALL,
                                            activity_detection_segments=[]),
    # 32 burst channels; at blocksize 1024 their windows differ (kernel E)
    "powact32": powact32(**SMALL),
    # two bandwidths in one 128-wide throughput bucket (kernel E)
    "tp-mixed-windows": ChannelizerConfig(
        **SMALL, relinvovl=4, freqmode="normalized",
        throughput_channels=[EXAMPLE_CHANNELS[1], EXAMPLE_CHANNELS[3]]),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_burst_configs_match_jax(name):
    """Step outputs key by key over 3 steps, then process + flush: events
    (metadata exact, samples as one stream) and throughput streams."""
    cfg = CONFIGS[name]
    jf = jax_twin(cfg)
    tf = FrequencyDomainChannelizer(cfg, device="cpu")
    x = capture(cfg, n_batches=4, tail=700)
    bs = tf.batch_samples
    jc, tc = jf._jit_init(), tf._device_init()
    rises = 0
    for step in range(3):
        chunk = x[step * bs:(step + 1) * bs]
        t0 = step * cfg.batch_blocks
        jc, jo = jax_step(jf, jc, chunk, t0)
        tc, to = tf._device_step(tc, torch.from_numpy(chunk), t0)
        assert_outputs_match(to, jo, f"{name} step {step}")
        if "powact" in jo:
            rises += int(np.asarray(jo["powact"]["rise"]).sum())
    assert rises > 0 or not cfg.activity_controlled_channels
    jf.reset()
    rj = [jf.process(x), jf.flush()]
    rt = [tf.process(x), tf.flush()]
    ej = [e for r in rj for e in r.events]
    et = [e for r in rt for e in r.events]
    kinds = {meta(e)["ID"].split(".")[0] for e in ej}
    expected = set()
    if cfg.activity_controlled_channels:
        expected.add("PowActChan")
        chans = {int(meta(e)["ID"].split(".")[1]) for e in ej
                 if meta(e)["ID"].startswith("PowActChan")}
        assert chans == set(range(len(cfg.activity_controlled_channels)))
    if cfg.activity_detection_segments:
        expected.add("DETECTED")
    assert kinds == expected
    if ej:
        assert_events_match(et, ej)
    for a, b in zip(rt, rj):
        assert a.blocks_processed == b.blocks_processed
        assert len(a.throughput) == len(b.throughput)
        for ca, cb in zip(a.throughput, b.throughput):
            assert ca.shape == cb.shape
            assert_close_to_max(ca, cb, RTOL, ATOL, "throughput stream")
