"""Kernel A's quarter-turn phase fold (``extract_fused.extract_shared_fold``)
against fdc_tpu's ``fold_phase_r`` branch of the Pallas ``_kernel_shared``.

The port runs on the CPU, i.e. through the kernel's plain version (the
GEMM, then the quarter turns as selects); the JAX package runs its Pallas
kernel in interpret mode. Inputs are made with numpy from a seed.
Tolerances (ROADMAP "How a part is held"): extractions and streams rtol
2e-4 / atol 2e-5 of each tensor's max; the route choice exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fdc_tpu.config import ChannelizerConfig as JaxConfig
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.ops.extract_pallas import fused_extract_shared
from fdc_tpu.ops.fft import _rr_idft_matrix as jax_rr_idft_matrix
from fdc_tpu.utils.cplx import c2f_host
from fdc_tpu_torch import FrequencyDomainChannelizer
from fdc_tpu_torch.flagship import cfg1_single_static, cfg2_dama16
from fdc_tpu_torch.ops import extract, extract_fused

RTOL, ATOL = 2e-4, 2e-5
SMALL = dict(blocksize=1024, batch_blocks=8)


def assert_close_to_max(got, ref, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    assert np.all(err <= ATOL * np.abs(ref).max() + RTOL * np.abs(ref)), (
        f"{what}: max abs err {err.max()}")


def fold_case(seed, r, b, n=512, l=64, keep_from=16):
    """A bucket whose starts cover every residue mod r twice."""
    rng = np.random.default_rng(seed)
    c = 2 * r
    spec = (rng.standard_normal((b, n))
            + 1j * rng.standard_normal((b, n))).astype(np.complex64)
    base = rng.choice((n - l) // r, size=c, replace=False) * r
    starts = np.sort(base + np.arange(c) % r).astype(np.int32)
    wins = np.tile(rng.random(l).astype(np.float32) + 0.1, (c, 1))
    return spec, starts, wins, keep_from


@pytest.mark.parametrize("r,b", [(1, 13), (2, 22), (4, 20), (4, 44)])
def test_fold_plain_matches_pallas_interpret(r, b):
    """B a multiple of R but not of the Pallas tile (8 R rows)."""
    spec, starts, wins, keep = fold_case(10 + r + b, r, b)
    l = wins.shape[1]
    m = jax_rr_idft_matrix(l, keep, True, float(l), pairs=True)
    folded = (np.concatenate([wins[0], wins[0]])[:, None] * m).astype(
        np.float32)
    ref = np.asarray(fused_extract_shared(
        jnp.asarray(spec), starts, folded, fold_phase_r=r, pairs=True,
        tb=8 * r, interpret=True))
    mat = extract.shared_folded_matrix(spec.shape[1], starts, wins, keep,
                                       float(l))
    got = extract_fused.extract_shared_fold(
        torch.from_numpy(spec), torch.from_numpy(starts),
        torch.from_numpy(mat), r)
    assert got.shape == ref.shape
    assert_close_to_max(got, ref, f"fold r={r}")


@pytest.mark.parametrize("r", [2, 4])
def test_fold_route_matches_default_route(r):
    """The fold (exact quarter turns, the port's route) against kernel A +
    apply_phase_pairs (cos/sin of the angles, the JAX package's default
    route)."""
    spec, starts, wins, keep = fold_case(3, r, 16)
    l = wins.shape[1]
    args = (torch.from_numpy(spec), torch.from_numpy(starts),
            torch.from_numpy(extract.shared_folded_matrix(
                spec.shape[1], starts, wins, keep, float(l))))
    folded = extract.extract_bucket_phased(*args, r)
    default = extract.apply_phase_pairs(
        extract.extract_bucket(*args),
        (torch.arange(16)[None, :] * args[1][:, None]) % r, r)
    assert_close_to_max(folded, default, "fold vs default")
    # a quarter turn is exact: rows with phase 0 equal the unrotated GEMM
    plain = extract_fused.extract_shared_plain(*args)
    zero_phase = ((np.arange(16)[None, :] * starts[:, None]) % r) == 0
    assert torch.equal(folded[torch.from_numpy(zero_phase)],
                       plain[torch.from_numpy(zero_phase)])


def test_fold_phase_env(monkeypatch):
    """The JAX package's FDC_TPU_FOLD_PHASE picks its route; the port has
    one route and reads no such variable: every value, even one the JAX
    parser refuses, gives the same step, through the fold."""
    calls = []

    def fold(*a):
        calls.append(a[-1])
        return extract_fused.extract_shared_fold_plain(*a)

    monkeypatch.setattr(extract_fused, "extract_shared_fold", fold)
    cfg = cfg2_dama16(**SMALL)
    x = torch.from_numpy(tone_capture(cfg, n_batches=1, tail=0))
    outs = []
    for val in (None, "0", "1", "on"):
        if val is None:
            monkeypatch.delenv("FDC_TPU_FOLD_PHASE", raising=False)
        else:
            monkeypatch.setenv("FDC_TPU_FOLD_PHASE", val)
        tf = FrequencyDomainChannelizer(cfg, device="cpu")
        outs.append(tf._device_step(tf._device_init(), x, 0)[1])
    assert calls == [cfg.relinvovl] * 4
    for o in outs[1:]:
        for a, b in zip(o["throughput_buckets"],
                        outs[0]["throughput_buckets"]):
            assert torch.equal(a, b)


def test_fold_route_choice(monkeypatch):
    """R = 8 is no quarter turn and per-channel tables have no fold: both
    keep kernel A / E + apply_phase_pairs; R in {1, 2, 4} with a shared
    matrix takes the fold."""
    calls = []

    def fold(*a):
        calls.append(a[-1])
        return extract_fused.extract_shared_fold_plain(*a)

    monkeypatch.setattr(extract_fused, "extract_shared_fold", fold)
    spec, starts, wins, keep = fold_case(5, 4, 16)
    n, l = spec.shape[1], wins.shape[1]
    t = (torch.from_numpy(spec), torch.from_numpy(starts))
    mat = torch.from_numpy(extract.shared_folded_matrix(n, starts, wins,
                                                        keep, float(l)))
    for r in (1, 2, 4):
        extract.extract_bucket_phased(*t, mat, r)
    assert calls == [1, 2, 4]
    got = extract.extract_bucket_phased(*t, mat, 8)
    ref = extract.apply_phase_pairs(
        extract.extract_bucket(*t, mat),
        (torch.arange(16)[None, :] * t[1][:, None]) % 8, 8)
    assert torch.equal(got, ref)
    mats = torch.from_numpy(extract.static_folded_matrices(
        n, starts, wins * np.linspace(1, 2, len(starts))[:, None]
        .astype(np.float32), keep, float(l)))
    extract.extract_bucket_phased(*t, mats, 4)
    assert calls == [1, 2, 4]


def jax_cfg(cfg):
    return JaxConfig.from_dict({**cfg.to_dict(), "native_emission": False})


def tone_capture(cfg, n_batches, tail, seed=0):
    """Noise and an exact-bin tone in every throughput channel, each with
    its own amplitude."""
    rng = np.random.default_rng(seed)
    n = cfg.blocksize
    n_samples = n_batches * cfg.batch_blocks * cfg.inplen + tail
    spec = np.zeros(n, np.complex128)
    for i, (f, _) in enumerate(cfg.throughput_channels):
        spec[round(f * n) % n] = 1.0 + 0.1 * i
    x = np.resize(np.fft.ifft(spec) * n, n_samples)
    x += 0.01 * (rng.standard_normal(n_samples)
                 + 1j * rng.standard_normal(n_samples))
    return x.astype(np.complex64)


@pytest.mark.parametrize("build,relinvovl,jax_fold", [
    (cfg2_dama16, 4, "1"), (cfg1_single_static, 4, "1"),
    (cfg2_dama16, 8, "1"), (cfg2_dama16, 4, "0"),
], ids=["cfg2", "cfg1", "cfg2-r8", "cfg2-jax-unfolded"])
def test_fold_end_to_end_matches_jax(monkeypatch, build, relinvovl,
                                     jax_fold):
    """The port (always the fold where R allows it) against the JAX
    package with FDC_TPU_FOLD_PHASE=1 (its Pallas fold, interpret mode)
    and =0 (its unfolded route): throughput_buckets key by key over three
    steps, then the process + flush streams. R = 8 falls back on both."""
    monkeypatch.setenv("FDC_TPU_FOLD_PHASE", jax_fold)
    monkeypatch.setenv("FDC_TPU_FUSED_INTERPRET", "1")
    cfg = build(**SMALL, relinvovl=relinvovl)
    jf = JaxFDC(jax_cfg(cfg))
    tf = FrequencyDomainChannelizer(cfg, device="cpu")
    x = tone_capture(cfg, n_batches=3, tail=900)
    bs = tf.batch_samples
    jc, tc = jf._jit_init(), tf._device_init()
    for step in range(3):
        chunk = x[step * bs:(step + 1) * bs]
        t0 = step * cfg.batch_blocks
        jc, jo = jf._jit_step(jc, jnp.asarray(c2f_host(chunk)),
                              jnp.int32(t0))
        tc, to = tf._device_step(tc, torch.from_numpy(chunk), t0)
        assert len(to["throughput_buckets"]) == len(jo["throughput_buckets"])
        for a, b in zip(to["throughput_buckets"], jo["throughput_buckets"]):
            assert a.shape == b.shape
            assert_close_to_max(a, b, f"step {step}")
    rj = [jf.process(x), jf.flush()]
    rt = [tf.process(x), tf.flush()]
    for a, b in zip(rt, rj):
        assert a.blocks_processed == b.blocks_processed
        for ca, cb in zip(a.throughput, b.throughput):
            assert ca.shape == cb.shape
            assert_close_to_max(ca.view(np.float32), cb.view(np.float32),
                                "stream")
