"""Kernel F2c's schedule (``csrc/forward_fft_cluster.cu``), on the CPU.

A CUDA kernel cannot run here, so :func:`cluster_model` repeats F2c in
numpy float32, index for index, for its build at each N (C CTAs a
cluster, NT threads a CTA, least CTAs an SM): each CTA's column
FFTs in groups of G1 transforms (the first Stockham pass reading the
block, the others in the column tile), the DSMEM gather from (peer rank,
local index) to (own rank, local index), staged between the two cluster
barriers and then twiddled from the [m1, m2] table, the row passes in
groups of G2, the last one writing the shifted, scaled spectrum.
Buffers start NaN-filled and the writes are counted, so every value is
shown to be written once. The model is held against the plain version,
float64 numpy and ``fdc_tpu.ops.fft.forward_spectrum_mxu`` (rel-RMS <=
2e-6 and 1e-5 of the max: another order of fp32 sums). The plan tests
hold each build to the card's limits, and ``_front_kernel`` to the
routing by N. The ``cuda`` tests run the kernel (skipped without a card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdc_tpu.ops.fft import forward_spectrum_mxu as jax_mxu
from fdc_tpu_torch.ops import fft

from test_torch_large_n import CPU, assert_fft_close, blocks, stockham

SMEM_OPTIN = 232448  # a CTA's shared memory on the H100
SMEM_SM = 233472  # an SM's
# the kernel's build at each N (FDC_CLUSTER_BUILDS): (C, NT, least CTAs an
# SM)
BUILDS = {32768: (8, 512, 4), 65536: (8, 512, 2), 131072: (8, 1024, 1)}


def geometry(n, c, nt):
    """The kernel's constants at N of a build with C = c, NT = nt."""
    m1, m2 = fft._two_pass_split(n)
    tc, rc = m2 // c, m1 // c
    g1 = nt // (m1 // fft.TWO_PASS_PLANS[m1][0])
    g2 = nt // (m2 // fft.TWO_PASS_PLANS[m2][0])
    return dict(m1=m1, m2=m2, tc=tc, rc=rc, pr=rc + 1, run=rc * tc, g1=g1,
                g2=g2, s=rc * m2 // (2 * nt),
                size=max(m1 * tc, m2 * (rc + 1)))


def cluster_model(x, c, nt, min_blocks=1):
    """F2c on [B, N] complex64 blocks, in numpy float32: cluster b holds
    block b, CTA r of it the buffer bufs[r] (min_blocks only bounds the
    kernel's registers). The row tile is written over the columns after
    the second barrier: here into a NaN-filled buffer, so every value of
    it is shown to be written once."""
    b, n = x.shape
    g = geometry(n, c, nt)
    m1, m2, tc, rc, pr, run = (g[k] for k in
                               ("m1", "m2", "tc", "rc", "pr", "run"))
    tw1, tw2 = (fft._radix_twiddles(m, CPU).numpy() for m in (m1, m2))
    twk = fft._cluster_twiddles(n, CPU).numpy()
    bufs = np.full((c, b, g["size"]), np.nan, np.complex64)
    # 1. the column FFTs, the first pass reading the block: value i of
    # column q + j is x[i m2 + r tc + q + j] (in place of the tile's)
    for r in range(c):
        for q in range(0, tc, g["g1"]):
            cols = q + np.arange(g["g1"])
            bufs[r][:, np.arange(m1)[:, None] * tc + cols] = x[
                :, np.arange(m1)[:, None] * m2 + r * tc + cols]
            bufs[r] = stockham(bufs[r], m1, tc, cols, tw1)
    # 2. every CTA reads its run of every peer into registers (between
    # the cluster barriers), then twiddles it and writes its row tile
    tid = np.arange(nt)
    staged = []
    for cc in range(c):
        regs = []
        for s in range(g["s"]):
            e = 2 * (tid + s * nt)
            r, q = e // run, e % run
            v0 = bufs[r, :, cc * run + q].T  # a 16-byte read: q, q + 1
            v1 = bufs[r, :, cc * run + q + 1].T
            regs.append((v0, v1))
        staged.append(regs)
    for cc in range(c):
        new = np.full((b, g["size"]), np.nan, np.complex64)
        writes = np.zeros(g["size"], np.int64)
        for s, (v0, v1) in enumerate(staged[cc]):
            e = 2 * (tid + s * nt)
            r, q = e // run, e % run
            k1, k, n2 = cc * rc + q // tc, q // tc, r * tc + q % tc
            for dst, v in ((n2 * pr + k, v0 * twk[k1, n2]),
                           ((n2 + 1) * pr + k, v1 * twk[k1, n2 + 1])):
                new[:, dst] = v
                np.add.at(writes, dst, 1)
        # every (n2, k) of the row tile once, the pad column never
        assert writes[:m2 * pr].reshape(m2, pr)[:, :rc].min() == 1
        assert writes.max() == 1 and writes.sum() == m2 * rc
        bufs[cc] = new
        for q in range(0, rc, g["g2"]):
            bufs[cc] = stockham(bufs[cc], m2, pr, q + np.arange(g["g2"]),
                                tw2)
    # 3. the last row pass's values, shifted and scaled into the spectrum
    out = np.full_like(x, np.nan)
    e = np.arange(rc * m2)
    gg, k2 = e % rc, e // rc
    for cc in range(c):
        out[:, cc * rc + gg + m1 * ((k2 + m2 // 2) & (m2 - 1))] = (
            bufs[cc][:, k2 * pr + gg] * np.float32(1.0 / n))
    return out


@pytest.mark.parametrize("n", BUILDS)
def test_cluster_model_matches_plain_and_float64(n):
    x = blocks(n, 2, salt=7)
    got = cluster_model(x, *BUILDS[n])
    assert not np.isnan(got).any()
    plain = fft.forward_spectrum_cluster_plain(torch.from_numpy(x))
    assert_fft_close(got, plain.numpy())
    assert_fft_close(got, np.fft.fftshift(
        np.fft.fft(x.astype(np.complex128), axis=-1), axes=-1) / n)


@pytest.mark.parametrize("n", [32768, 65536])
def test_cluster_model_matches_jax(n):
    x = blocks(n, 2, salt=8)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(jax_mxu(jnp.asarray(x)))
    assert_fft_close(cluster_model(x, *BUILDS[n]), ref)
    assert_fft_close(fft.forward_spectrum(torch.from_numpy(x)).numpy(), ref)


def test_cluster_twiddles_are_the_two_pass_tables():
    for n in BUILDS:
        m1, m2 = fft._two_pass_split(n)
        twk = fft._cluster_twiddles(n, CPU)
        assert twk.shape == (m1, m2) and twk.is_contiguous()
        k = torch.arange(m1)[:, None] * torch.arange(m2)[None, :]
        assert torch.equal(twk, fft._radix_twiddles(n, CPU)[k])


@pytest.mark.parametrize("n", BUILDS)
def test_cluster_build_fits_the_card(n):
    """The build fits a CTA's shared memory and thread limit (and its
    least CTAs an SM fit one SM), in a portable cluster, in whole
    transform groups."""
    c, nt, min_blocks = BUILDS[n]
    g = geometry(n, c, nt)
    assert c in (2, 4, 8) and nt <= 1024
    smem = g["size"] * 8
    assert smem <= SMEM_OPTIN
    assert min_blocks * (smem + 1024) <= SMEM_SM  # + the reserved KB
    assert min_blocks * nt <= 2048
    assert g["g1"] >= 16 and g["tc"] % g["g1"] == 0
    assert g["g2"] >= 16 and g["rc"] % g["g2"] == 0
    assert 2 * g["s"] * nt == g["rc"] * g["m2"]


def test_front_kernel_routes_by_n_alone():
    assert fft.CLUSTER_MAX_N == 1 << 17
    assert [fft._front_kernel(1 << e) for e in range(4, 29)] == (
        ["torch.fft"] * 4 + ["F"] * 7 + ["F2c"] * 3 + ["F2"] * 11)


def test_forward_spectrum_routes_by_n(monkeypatch):
    """forward_spectrum(use_mxu=True) calls the wrapper _front_kernel
    names, through the module (so swapped wrappers are seen)."""
    seen = []
    for name in ("forward_spectrum_four_step", "forward_spectrum_cluster",
                 "forward_spectrum_two_pass"):
        monkeypatch.setattr(fft, name, lambda blocks, out=None, name=name:
                            seen.append(name))
    for n in (4096, 32768, 131072, 262144):
        fft.forward_spectrum(torch.zeros(1, n, dtype=torch.complex64))
    assert seen == ["forward_spectrum_four_step", "forward_spectrum_cluster",
                    "forward_spectrum_cluster", "forward_spectrum_two_pass"]


def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", BUILDS)
def test_cluster_kernel_matches_plain(n):
    """The kernel against the plain version and float64 numpy, and
    through the route's entry point."""
    dev = cuda_device()
    x = blocks(n, 5, salt=9)
    xd = torch.from_numpy(x).to(dev)
    before = fft.forward_spectrum_cluster.launches
    got = fft.forward_spectrum_cluster(xd)
    assert fft.forward_spectrum_cluster.launches == before + 1
    assert_fft_close(got.cpu().numpy(),
                     fft.forward_spectrum_cluster_plain(xd).cpu().numpy())
    assert_fft_close(got.cpu().numpy(), np.fft.fftshift(
        np.fft.fft(x.astype(np.complex128), axis=-1), axes=-1) / n)
    assert torch.equal(fft.forward_spectrum(xd), got)
    assert fft.forward_spectrum_cluster.launches == before + 2


@pytest.mark.cuda
def test_cluster_kernel_writes_into_spec_ext_and_refuses():
    dev = cuda_device()
    x = torch.from_numpy(blocks(32768, 16, salt=10)).to(dev)
    ext = torch.full((17, 32768), 3 + 4j, dtype=torch.complex64, device=dev)
    got = fft.forward_spectrum(x, out=ext[1:])
    assert got.data_ptr() == ext[1:].data_ptr()
    assert bool((ext[0] == 3 + 4j).all())
    assert torch.equal(ext[1:], fft.forward_spectrum_cluster(x))
    # blocks at an odd complex64 offset (8-byte aligned only)
    flat = torch.zeros(2 * 32768 + 1, dtype=torch.complex64, device=dev)
    flat[1:] = x[:2].reshape(-1)
    assert torch.equal(fft.forward_spectrum_cluster(flat[1:].view(2, 32768)),
                       ext[1:3])
    with pytest.raises(ValueError):
        fft.forward_spectrum_cluster(
            torch.zeros(2, 262144, dtype=torch.complex64, device=dev))
