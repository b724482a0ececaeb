"""The FFT route (``use_mxu_fft=False``) of fdc_tpu_torch against fdc_tpu.

With the knob off, ``fdc_tpu`` computes every subband transform with
``jnp.fft`` (``subband_ifft`` for the static buckets, ``interp_subband_ifft``
for the slots) and the detection measures as a separate |X|^2 pass; the
port does the same on ``torch.fft``. Both run on the CPU here, the port
on its plain path. Inputs are seeded numpy.

Tolerances (ROADMAP "How a part is held"): flags, tables, plans,
counters and event metadata exact; streams and extractions rtol 2e-4 /
atol 2e-5 of each tensor's max; powers 1e-5 of each tensor's max. The
two FFT libraries (pocketfft under both, in other orders) round
differently at ~1e-7 of a transform's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship as jax_flagship
from fdc_tpu.config import ChannelizerConfig as JaxConfig
from fdc_tpu.models.activity_detection import (
    ActivityDetectionChannelizer as JaxADC,
)
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.ops import fft as jfft
from fdc_tpu.parallel.pipeline import PipelineChannelizer as JaxPipe
from fdc_tpu.utils.cplx import c2f_host
from fdc_tpu_torch import (
    ActivityDetectionChannelizer,
    ChannelizerConfig,
    FrequencyDomainChannelizer,
)
from fdc_tpu_torch.flagship import _flagship, cfg4_segdet
from fdc_tpu_torch.ops import extract, extract_fused, fft
from fdc_tpu_torch.parallel import PipelineChannelizer

from test_torch_pipeline import assert_streams_match, configs, signal, stream
from test_torch_sharded import jax_sharded, port_sharded
from test_torch_slice import (
    ATOL,
    RTOL,
    SMALL,
    assert_close_to_max,
    assert_events_match,
    assert_outputs_match,
    capture,
    jax_step,
)
from test_torch_vcm import SCENES, make_spectra


def crand(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 9, 256), (1, 4, 1024)])
def test_subband_ifft_matches_jax(shape):
    z = crand(np.random.default_rng(shape[-1]), *shape)
    got = fft.subband_ifft(torch.from_numpy(z)).numpy()
    ref = np.asarray(jfft.subband_ifft(jnp.asarray(z)))
    assert got.dtype == np.complex64
    assert_close_to_max(got, ref, RTOL, ATOL, "subband_ifft")


@pytest.mark.parametrize("w_max", [64, 128, 512])
def test_interp_subband_ifft_matches_jax(w_max):
    z = crand(np.random.default_rng(w_max + 1), 4, 3, w_max)
    z[..., w_max // 4:] = 0  # a slot of width W / 4, zero-padded
    got = fft.interp_subband_ifft(torch.from_numpy(z), w_max).numpy()
    ref = np.asarray(jfft.interp_subband_ifft(jnp.asarray(z), w_max))
    assert_close_to_max(got, ref, RTOL, ATOL, "interp_subband_ifft")


def no_kernels(monkeypatch):
    """Make kernels A and E and the slot product fail if called."""
    def refuse(*a, **k):
        raise AssertionError("the FFT route called a product route")

    for name in ("extract_shared", "extract_static", "extract_shared_fold"):
        monkeypatch.setattr(extract_fused, name, refuse)
    monkeypatch.setattr(extract, "interp_subband_ifft_mxu", refuse)


def run_pair(jcfg, pcfg, x, n_steps):
    """Step outputs key by key over ``n_steps``, then process + flush
    events, streams and powers over the whole capture."""
    jf = JaxFDC(jcfg)
    tf = FrequencyDomainChannelizer(pcfg, device="cpu")
    bs = tf.batch_samples
    jc, tc = jf._jit_init(), tf._device_init()
    for step in range(n_steps):
        chunk = x[step * bs:(step + 1) * bs]
        t0 = step * pcfg.batch_blocks
        jc, jo = jax_step(jf, jc, chunk, t0)
        tc, to = tf._device_step(tc, torch.from_numpy(chunk), t0)
        assert_outputs_match(to, jo, f"step {step}")
    jf.reset()
    return stream(tf, x, len(x)), stream(jf, x, len(x))


@pytest.mark.parametrize("overrides", [
    {},
    # a burst bank without segments: the burst chain in kernel D
    dict(activity_detection_segments=[]),
    # B % R != 0: the unphased buckets
    dict(activity_controlled_channels=[], activity_detection_segments=[],
         batch_blocks=6),
    # a burst channel as wide as the throughput channels: a fused bucket
    dict(activity_controlled_channels=[(-0.45, 0.045)]),
], ids=["flagship", "powact-only", "unphased", "fused-width"])
def test_flagship_fft_route_matches_jax(monkeypatch, overrides):
    no_kernels(monkeypatch)
    kw = dict(SMALL, use_mxu_fft=False, **overrides)
    pcfg = _flagship(**kw)
    x = capture(pcfg, n_batches=4, tail=900)
    got, ref = run_pair(jax_flagship(**kw, native_emission=False), pcfg, x,
                        3)
    if pcfg.activity_controlled_channels or \
            pcfg.activity_detection_segments:
        assert_streams_match(got, ref)
    else:
        for a, b in zip(got[1], ref[1]):
            assert_close_to_max(a, b, RTOL, ATOL, "throughput stream")


def mxu_fft_config(cls, use_mxu):
    """tests/test_mxu_fft.py::test_use_mxu_fft_end_to_end's config."""
    return cls(
        blocksize=512, relinvovl=4,
        throughput_channels=[(-0.2, 0.05), (0.1, 0.05)],
        activity_controlled_channels=[(0.3, 0.05)],
        activity_detection_segments=[(-0.45, -0.3)],
        act_contr_threshold=10.0, act_det_threshold=8.0, minchandist=0.02,
        freqmode="basebandfs", batch_blocks=8, max_slots=8,
        use_mxu_fft=use_mxu, native_emission=False,
    )


def mxu_fft_signal(cfg):
    n = 24 * cfg.inplen
    t = np.arange(n)
    rng = np.random.default_rng(4)
    x = (0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    for lo, hi, f in ((4, 14, 0.3), (8, 18, -0.38)):
        m = np.zeros(n)
        m[lo * 384: hi * 384] = 1.0
        x += (2.0 * m * np.exp(2j * np.pi * f * t)).astype(np.complex64)
    return x


@pytest.mark.parametrize("use_mxu", [False, True])
def test_mxu_fft_config_matches_jax(monkeypatch, use_mxu):
    """The JAX package's own knob test config, with the knob both ways."""
    if not use_mxu:
        no_kernels(monkeypatch)
    pcfg = mxu_fft_config(ChannelizerConfig, use_mxu)
    x = mxu_fft_signal(pcfg)
    got, ref = run_pair(mxu_fft_config(JaxConfig, use_mxu), pcfg, x, 3)
    assert_streams_match(got, ref)


def test_knob_flips_the_route_not_the_result():
    """The port's two routes on one capture: events exact, streams within
    the stream tolerance (fdc_tpu's own test holds 2e-3)."""
    x = mxu_fft_signal(mxu_fft_config(ChannelizerConfig, True))
    runs = [stream(FrequencyDomainChannelizer(
        mxu_fft_config(ChannelizerConfig, m), device="cpu"), x, len(x))
        for m in (False, True)]
    assert_streams_match(*runs)


def test_two_tier_detection_fft_route_matches_jax(monkeypatch):
    """BASELINE config 4 cut to 1024 points: two-tier slot extraction on
    the FFT route (the wide and the narrow bucket through torch.fft)."""
    no_kernels(monkeypatch)
    kw = dict(blocksize=1024, batch_blocks=8, minchandist=0.02,
              use_mxu_fft=False, native_emission=False)
    pcfg = cfg4_segdet(**kw)
    jcfg = JaxConfig.from_dict(pcfg.to_dict())
    x = capture(pcfg, n_batches=3, tail=300)
    got, ref = run_pair(jcfg, pcfg, x, 3)
    assert_events_match(got[0], ref[0])
    for a, b in zip(got[2], ref[2]):
        assert_close_to_max(a, b, 0.0, 1e-5, "segment power")


@pytest.mark.parametrize("scene", ["two-segments", "two-tier"])
def test_vcm_fft_route_matches_jax(monkeypatch, scene):
    """The vcm detector's slots extract through torch.fft, as
    fdc_tpu's, with no product route on the way."""
    no_kernels(monkeypatch)
    kw, maxblocks, (nb, carriers) = SCENES[scene]
    spectra = make_spectra(nb, kw["blocklen"], kw["relinvovl"], carriers)
    jr = JaxADC(**kw).make_runner(maxblocks=maxblocks, native_emission=False)
    tr = ActivityDetectionChannelizer(**kw, device="cpu").make_runner(
        maxblocks=maxblocks)
    assert not any(sd.use_mxu for sd in tr.adc.segments)
    jc, tc = jr._jit_init(), tr._device_init()
    for lo in range(0, nb, 8):
        chunk = spectra[lo:lo + 8]
        jc, jo = jr._jit_step(jc, jnp.asarray(c2f_host(chunk)))
        tc, to = tr._device_step(tc, torch.from_numpy(chunk))
        assert_outputs_match(to, jax.tree.map(np.asarray, jo), scene)


@pytest.mark.parametrize("n_time,n_chan", [(2, 2)])
def test_sharded_fft_route_matches_jax(monkeypatch, n_time, n_chan):
    """ShardedChannelizer 2x2 with the knob off: the FFT route's windows
    split by chan rank, the measures as a separate pass on chan rank 0."""
    no_kernels(monkeypatch)
    jcfg, pcfg = configs(use_mxu_fft=False)
    x = signal(pcfg, 4, 7)
    chunk = 2 * pcfg.batch_blocks * pcfg.inplen
    got = stream(port_sharded(pcfg, n_time, n_chan), x, chunk)
    assert_streams_match(got, stream(jax_sharded(jcfg, n_time, n_chan), x,
                                     chunk))
    assert_streams_match(got, stream(
        FrequencyDomainChannelizer(pcfg, device="cpu"), x, chunk))


def test_pipeline_fft_route_matches_jax(monkeypatch):
    """PipelineChannelizer on two lanes with the knob off."""
    no_kernels(monkeypatch)
    jcfg, pcfg = configs(use_mxu_fft=False)
    x = signal(pcfg, 6, 7)
    chunk = 2 * pcfg.batch_blocks * pcfg.inplen
    got = stream(PipelineChannelizer(pcfg, devices=["cpu"] * 2), x, chunk)
    assert_streams_match(got, stream(
        JaxPipe(jcfg, devices=jax.devices()[:2]), x, chunk))


def test_fft_route_tables(monkeypatch):
    """The knob decides the tables: folded matrices and IDFT buffers on
    the product route, windows (and no matrix) on the FFT route."""
    on = FrequencyDomainChannelizer(_flagship(**SMALL), device="cpu")
    off = FrequencyDomainChannelizer(_flagship(**SMALL, use_mxu_fft=False),
                                     device="cpu")
    names_on = {n for n, _ in on.named_buffers()}
    names_off = {n for n, _ in off.named_buffers()}
    assert {"throughput.w64_folded", "power_bank.w32_folded",
            "segments.0.idft"} <= names_on
    assert not {n for n in names_off if "folded" in n or "idft" in n}
    assert {"throughput.w64_windows", "power_bank.w32_windows"} <= names_off
    starts, table = off.throughput.tables(off.throughput.buckets[0])
    assert isinstance(table, extract.FftTable)
    assert table.gain == 64.0 and table.keep_from == 16
    _, table = off.power_bank.tables(off.power_bank.buckets[0])
    assert table.gain == 1.0
