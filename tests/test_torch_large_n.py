"""Blocksizes above 16384 points: kernel F's two-pass form and the
channelizer at N = 32768, against fdc_tpu.

- :func:`two_pass_model` repeats ``csrc/forward_fft_2pass.cu`` in numpy
  float32, index for index (a CUDA kernel cannot run here): pass 1's
  tiles of TC columns loaded into a pitched buffer, the Stockham passes
  of ``fft.TWO_PASS_PLANS`` over thread (g, t), the W_N^(k1 n2)
  twiddle, the scratch block, pass 2's tiles of TC rows and the shifted,
  scaled store. Every output is written once (NaN-filled buffers). It
  is held against the plain version (the four-step product form),
  float64 numpy and the JAX package's ``forward_spectrum_mxu``, rel-RMS
  <= 2e-6 and 1e-5 of the max (another order of fp32 sums).
- ``forward_spectrum`` at N = 32768 and 65536 against
  ``fdc_tpu.ops.fft.forward_spectrum_mxu`` and the ``jnp.fft`` route.
- The flagship at ``blocksize=32768`` (4 blocks a batch; both settings
  of ``use_mxu_fft``) and 65536 against fdc_tpu, step outputs key by
  key, and the sharded step (2x2) and the pipeline (two lanes) at 32768,
  events and streams (streams rtol 2e-4 / atol 2e-5 of the max, powers
  1e-5 of the max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship as jax_flagship
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.ops.fft import forward_spectrum as jax_forward
from fdc_tpu_torch import FrequencyDomainChannelizer
from fdc_tpu_torch.flagship import _flagship
from fdc_tpu_torch.ops import fft

from test_torch_slice import assert_outputs_match, jax_step

REL_RMS = 2e-6
MAX_TOL = 1e-5
CPU = torch.device("cpu")


def blocks(n, b, salt=0):
    rng = np.random.default_rng(n + salt)
    return (rng.standard_normal((b, n))
            + 1j * rng.standard_normal((b, n))).astype(np.complex64)


def assert_fft_close(got, ref):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    rms = np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2))
    assert rms <= REL_RMS, rms
    assert np.abs(got - ref).max() <= MAX_TOL * np.abs(ref).max()


def tile(m):
    """Transforms a CTA (the kernel's tile<M>())."""
    return 16 if m <= 1024 else 16384 // m


def pitch(tc):
    return tc + 1 if tc > 1 else 1


def stockham(buf, m, p, cols, tw):
    """``radix_fft.cuh``'s stockham on [B, size] complex64: the transforms
    at offsets ``cols`` (a group q + g), value i of transform g at
    i * p + q + g; thread (g, t) takes butterflies j = t + b T."""
    values, radices = fft.TWO_PASS_PLANS[m]
    t_per = m // values
    g = np.asarray(cols)[:, None, None]
    ns = 1
    for r in radices:
        assert values % r == 0
        nb, span = values // r, m // r
        j = (np.arange(t_per)[None, :]
             + np.arange(nb)[:, None] * t_per).reshape(-1)
        assert sorted(j) == list(range(span))  # every butterfly, once
        k = j % ns
        rr = np.arange(r)
        v = buf[:, (j[:, None] + rr[None] * span)[None] * p + g]
        if ns > 1:
            v = v * tw[rr[None] * k[:, None] * (m // (ns * r))]
        w = np.exp(-2j * np.pi * np.outer(rr, rr) / r).astype(np.complex64)
        v = (v @ w).astype(np.complex64)
        d = (j // ns) * ns * r + j % ns
        nxt = buf.copy()
        nxt[:, (d[:, None] + rr[None] * ns)[None] * p + g] = v
        buf, ns = nxt, ns * r
    return buf


def column_passes(buf, m, tc, tw):
    """The two-pass kernel's Stockham body on [B, m * pitch] complex64:
    tc transforms, value i of transform g at i * pitch + g."""
    return stockham(buf, m, pitch(tc), np.arange(tc), tw)


def two_pass_model(x):
    """The two passes of ``csrc/forward_fft_2pass.cu`` on [B, N]
    complex64 blocks, in numpy float32."""
    b, n = x.shape
    m1, m2 = fft._two_pass_split(n)
    tw1, tw2, twn = (fft._radix_twiddles(m, CPU).numpy()
                     for m in (m1, m2, n))
    y = np.full_like(x, np.nan)
    tc, p = tile(m1), pitch(tile(m1))
    e = np.arange(tc * m1)
    for c0 in range(0, m2, tc):  # pass 1: a CTA a tile of columns
        g, i = e % tc, e // tc
        buf = np.zeros((b, m1 * p), np.complex64)
        buf[:, i * p + g] = x[:, i * m2 + c0 + g]
        buf = column_passes(buf, m1, tc, tw1)
        y[:, i * m2 + c0 + g] = buf[:, i * p + g] * twn[i * (c0 + g)]
    out = np.full_like(x, np.nan)
    tc, p = tile(m2), pitch(tile(m2))
    e = np.arange(tc * m2)
    for r0 in range(0, m1, tc):  # pass 2: a CTA a tile of rows
        g, i = e // m2, e % m2
        buf = np.zeros((b, m2 * p), np.complex64)
        buf[:, i * p + g] = y[:, r0 * m2 + e]
        buf = column_passes(buf, m2, tc, tw2)
        g, k2 = e % tc, e // tc
        out[:, r0 + g + m1 * ((k2 + m2 // 2) & (m2 - 1))] = (
            buf[:, k2 * p + g] * np.float32(1.0 / n))
    return out


@pytest.mark.parametrize("n", [32768, 65536, 131072])
def test_two_pass_model_matches_plain_and_float64(n):
    x = blocks(n, 2)
    got = two_pass_model(x)
    assert not np.isnan(got).any()
    plain = fft.forward_spectrum_four_step_plain(torch.from_numpy(x))
    assert_fft_close(got, plain.numpy())
    assert_fft_close(got, np.fft.fftshift(
        np.fft.fft(x.astype(np.complex128), axis=-1), axes=-1) / n)


def test_two_pass_plans_and_split():
    """Every plan covers its transform, and every N of the two-pass range
    splits into two plans; above it the wrapper refuses."""
    for m, (values, radices) in fft.TWO_PASS_PLANS.items():
        assert int(np.prod(radices)) == m
        assert all(values % r == 0 for r in radices)
        assert tile(m) * m // values <= 1024
        assert m * pitch(tile(m)) * 8 <= 232448  # the card's shared memory
    for log2n in range(15, 29):
        m1, m2 = fft._two_pass_split(1 << log2n)
        assert m1 * m2 == 1 << log2n and m1 in (m2, 2 * m2)
        assert m1 in fft.TWO_PASS_PLANS and m2 in fft.TWO_PASS_PLANS
    assert fft._two_pass_split(1 << 15) == fft._four_step_matrices(1 << 15)[:2]
    assert fft.TWO_PASS_MAX_N == 1 << 28


@pytest.mark.parametrize("n", [32768, 65536])
def test_forward_spectrum_large_n_matches_jax(n):
    x = blocks(n, 3, salt=1)
    got = fft.forward_spectrum(torch.from_numpy(x), use_mxu=True).numpy()
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(jax_forward(jnp.asarray(x), use_mxu=True))
        ref_fft = np.asarray(jax_forward(jnp.asarray(x), use_mxu=False))
    assert_fft_close(got, ref)
    assert_fft_close(two_pass_model(x), ref)
    assert_fft_close(
        fft.forward_spectrum(torch.from_numpy(x), use_mxu=False).numpy(),
        ref_fft)


def large_capture(cfg, n_batches, seed=3):
    """Noise, tones in throughput channels 5 and 40, a gated carrier in
    the burst band and two in the detection segment (~45 dB over the
    noise)."""
    rng = np.random.default_rng(seed)
    n = cfg.blocksize
    n_samples = n_batches * cfg.batch_blocks * cfg.inplen
    t = np.arange(n_samples)
    blk = cfg.batch_blocks * cfg.inplen
    x = 0.01 * (rng.standard_normal(n_samples)
                + 1j * rng.standard_normal(n_samples))
    for f, a, lo, hi in ((-0.4 + 0.8 * 5.5 / 64, 1.0, 0, 9),
                         (-0.4 + 0.8 * 40.5 / 64, 0.7, 0, 9),
                         (-0.45, 0.5, 0.6, 1.7),
                         (0.43, 0.4, 0.3, 1.4),
                         (0.47, 0.3, 1.2, 2.6)):
        m = np.zeros(n_samples)
        m[int(lo * blk):int(hi * blk)] = 1.0
        x = x + a * m * np.exp(2j * np.pi * (round(f * n) / n) * t)
    return x.astype(np.complex64)


@pytest.mark.parametrize("n,use_mxu", [(32768, True), (32768, False),
                                       (65536, True)])
def test_flagship_large_n_matches_jax(n, use_mxu):
    """The flagship at blocksize 32768 and 65536: the plain two-pass
    front end, the buckets and the detection, step by step against
    fdc_tpu."""
    kw = dict(blocksize=n, batch_blocks=4, use_mxu_fft=use_mxu)
    jf = JaxFDC(jax_flagship(**kw, native_emission=False))
    tf = FrequencyDomainChannelizer(_flagship(**kw), device="cpu")
    x = large_capture(tf.config, 3)
    bs = tf.batch_samples
    jc, tc = jf._jit_init(), tf._device_init()
    seen = 0
    for step in range(3):
        chunk = x[step * bs:(step + 1) * bs]
        t0 = step * tf.config.batch_blocks
        jc, jo = jax_step(jf, jc, chunk, t0)
        tc, to = tf._device_step(tc, torch.from_numpy(chunk), t0)
        assert_outputs_match(to, jo, f"N={n} step {step}")
        seen += int(np.asarray(jo["seg0"]["activated"]).sum())
        seen += int(np.asarray(jo["powact"]["rise"]).sum())
    assert seen >= 2  # a burst and a detection happened


@pytest.mark.parametrize("kind,use_mxu", [
    ("sharded-2x2", False), ("sharded-2x2", True), ("pipeline-2", True)])
def test_multi_device_at_32768(kind, use_mxu):
    """ShardedChannelizer 2x2 and PipelineChannelizer on two lanes at
    blocksize 32768 (tests/test_parallel.py's config, the slot width
    capped at 512: the product route's slot matrix is dense), events and
    streams against fdc_tpu's; the sharded step on the product route
    against the port's plain channelizer, which
    :func:`test_flagship_large_n_matches_jax` holds against fdc_tpu (the
    JAX sharded step takes ~1 min to compile its matrices at this N)."""
    from fdc_tpu.parallel.pipeline import PipelineChannelizer as JaxPipe
    from fdc_tpu_torch.parallel import PipelineChannelizer

    from test_torch_pipeline import (
        assert_streams_match,
        configs,
        signal,
        stream,
    )
    from test_torch_sharded import jax_sharded, port_sharded

    jcfg, pcfg = configs(blocksize=32768, batch_blocks=4,
                         max_extract_width=512, use_mxu_fft=use_mxu)
    x = signal(pcfg, 3, 7)
    chunk = pcfg.batch_blocks * pcfg.inplen
    if kind == "pipeline-2":
        port = PipelineChannelizer(pcfg, devices=["cpu"] * 2)
        ref = JaxPipe(jcfg, devices=jax.devices()[:2])
    else:
        port = port_sharded(pcfg, 2, 2)
        ref = (FrequencyDomainChannelizer(pcfg, device="cpu") if use_mxu
               else jax_sharded(jcfg, 2, 2))
    assert_streams_match(stream(port, x, chunk), stream(ref, x, chunk))
