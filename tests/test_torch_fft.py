"""The port's forward FFT route and the FFT probes.

- ``forward_spectrum(use_mxu=True)`` (the four-step DFT-as-product form,
  kernel F's plain version on the CPU) against the JAX package's
  ``forward_spectrum(use_mxu=True)`` and against numpy's float64 FFT
  (shifted, 1/N), for every N kernel F covers: rel-RMS <= 2e-6 (fp32
  products of length <= 128 against float64; measured ~4e-7 at N=16384);
- the FFT route (``use_mxu=False``, and N < 256 either way) against the
  JAX package's ``jnp.fft`` route, rtol 2e-4 / atol 2e-5 of the max;
- every probe's plain version against the numpy expectation its probe
  file states (``tools/pallas_fft_micro.py``, ``pallas_fft_micro2.py``),
  1e-5 of the max (fp32 against float64);
- ``cuda``-marked: kernels F (and its two-pass form at N = 32768 ...
  131072) and P against their plain versions on the card, max abs err
  <= 1e-5 of each result's max (another summation order).

The JAX comparisons import JAX inside the tests and run it on its CPU
backend, so the file also runs on the card's machine, with or without
JAX there:
``python -m pytest --noconftest -o addopts="" tests/test_torch_fft.py``.
Inputs are numpy, seeded.
"""

import numpy as np
import pytest
import torch

from fdc_tpu_torch import kernels
from fdc_tpu_torch.ops import fft, probes

NS = [256, 512, 1024, 2048, 4096, 8192, 16384]
REL_RMS = 2e-6


def blocks(n, b, salt=0):
    rng = np.random.default_rng(n + salt)
    return (rng.standard_normal((b, n))
            + 1j * rng.standard_normal((b, n))).astype(np.complex64)


def rel_rms(got, ref):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2)
                         / np.mean(np.abs(ref) ** 2)))


def assert_close_to_max(got, ref, tol, what=""):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), f"{what}: max abs err {err}"


def jax_forward(x, use_mxu):
    """The JAX package's forward FFT, on JAX's CPU backend (fp32
    products; a GPU backend would take TF32)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from fdc_tpu.ops.fft import forward_spectrum as jx_forward

    with jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(jx_forward(jnp.asarray(x), use_mxu=use_mxu))


@pytest.mark.parametrize("n", NS)
def test_four_step_matches_jax(n):
    x = blocks(n, 6)
    got = fft.forward_spectrum(torch.from_numpy(x), use_mxu=True).numpy()
    assert got.shape == x.shape and got.dtype == np.complex64
    assert rel_rms(got, jax_forward(x, True)) <= REL_RMS


@pytest.mark.parametrize("n", NS)
def test_four_step_matches_float64_fft(n):
    x = blocks(n, 5, salt=1)
    got = fft.forward_spectrum(torch.from_numpy(x), use_mxu=True).numpy()
    ref = np.fft.fftshift(np.fft.fft(x.astype(np.complex128), axis=-1),
                          axes=-1) / n
    assert rel_rms(got, ref) <= REL_RMS


@pytest.mark.parametrize("n,use_mxu", [(64, True), (128, True), (128, False),
                                       (1024, False), (4096, False)])
def test_fft_route_matches_jax(n, use_mxu):
    """Below 256 points (either setting) and with use_mxu off, both
    packages take their FFT route."""
    x = blocks(n, 4, salt=2)
    got = fft.forward_spectrum(torch.from_numpy(x), use_mxu=use_mxu).numpy()
    assert_close_to_max(got, jax_forward(x, use_mxu), 2e-5)


def test_four_step_tables_match_jax():
    """The port's copy of the constant matrices is the JAX package's."""
    pytest.importorskip("jax")
    from fdc_tpu.ops.fft import _four_step_matrices as jx_tables

    for n in NS:
        for a, b in zip(fft._four_step_matrices(n), jx_tables(n)):
            np.testing.assert_array_equal(a, b)


def test_forward_route_on_cpu_takes_the_plain_version(monkeypatch):
    """CPU tensors: the plain version, no launch, no count; the FFT route
    below 256 points."""
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("launched"))
    before = (fft.forward_spectrum_four_step.launches,
              probes.tile_probe.launches)
    x = torch.from_numpy(blocks(1024, 3))
    assert torch.equal(fft.forward_spectrum(x, use_mxu=True),
                       fft.forward_spectrum_four_step_plain(x))
    x = torch.from_numpy(blocks(128, 3))
    assert torch.equal(fft.forward_spectrum(x, use_mxu=True),
                       fft.forward_spectrum(x))
    args = [torch.from_numpy(a) for a in probes.probe_inputs("p4")]
    assert torch.equal(probes.tile_probe("p4", *args),
                       probes.tile_probe_plain("p4", *args))
    assert before == (fft.forward_spectrum_four_step.launches,
                      probes.tile_probe.launches)


def micro_inputs():
    """tools/pallas_fft_micro.py:99-105."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 4096)).astype(np.float32)
    fj2 = rng.standard_normal((64, 64)).astype(np.float32)
    return x, np.eye(64, dtype=np.float32) * 2.0, fj2


def micro2_inputs():
    """tools/pallas_fft_micro2.py:94-100."""
    rng = np.random.default_rng(0)
    shapes = [(64, 64), (32, 128), (256, 128), (64, 64), (64, 64), (64, 64)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def expected(name):
    """(inputs, the expectation) of each probe, as its file states it
    (float64): pallas_fft_micro.py's ops by their definitions (:39-97),
    pallas_fft_micro2.py's cases and ``expect_p4`` (:103-128)."""
    x, f, fj2 = micro_inputs()
    d = np.float64
    flat = (x.astype(d).reshape(512, 64) @ f).reshape(8, 4096)
    micro = {
        "m1": ((x,), x.astype(d) * 2.0),
        "m2": ((x, f), flat), "m2p": ((x, f), flat), "m3": ((x, f), flat),
        "m4": ((x, f), flat),
        "m2f": ((fj2, fj2), fj2.astype(d) @ fj2),
        "m5": ((x.reshape(512, 64), f), x.astype(d).reshape(512, 64) @ f),
        "m6": ((x, np.eye(128, dtype=np.float32)),
               (x.astype(d).reshape(256, 128)
                @ np.eye(128)).reshape(8, 4096)),
    }
    if name in micro:
        return micro[name]
    x64, x128, xtall, f, g, t = micro2_inputs()
    m = 64

    def expect_p4(n_blocks=8, twiddled=True):
        out = np.zeros((8 * 32, 128))
        for b in range(n_blocks):
            blk = xtall[b * 32:(b + 1) * 32].astype(d)
            xb = np.concatenate([blk[:, :m], blk[:, m:]], axis=0)
            s = xb.T @ f
            xk = g @ (s * t) if twiddled else s
            out[b * 32:(b + 1) * 32] = np.concatenate([xk[0::2], xk[1::2]],
                                                      axis=1)
        return out

    return {
        "p1": ((x64, f), x64.T.astype(d) @ f),
        "p2": ((x64,), np.concatenate([x64[0::2], x64[1::2]], axis=0)),
        "p3": ((x128,), np.concatenate([x128[:, :m], x128[:, m:]], axis=0)),
        "p4": ((xtall, f, g, t), expect_p4()),
        "p4c": ((xtall, f), expect_p4(twiddled=False)),
        "p4d": ((xtall, f, g, t), expect_p4(n_blocks=1)),
        "p5": ((x64,), np.concatenate([x64[0::2], x64[1::2]], axis=1)),
        "p6": ((x64,), np.concatenate([x64[:32], x64[32:]], axis=1)),
    }[name]


@pytest.mark.parametrize("name", probes.PROBES)
def test_probe_plain_matches_probe_file(name):
    ins, want = expected(name)
    for a, b in zip(probes.probe_inputs(name), ins):
        np.testing.assert_array_equal(a, b)
    got = probes.tile_probe_plain(name, *map(torch.from_numpy, ins))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert_close_to_max(got.numpy(), want, 1e-5, name)


def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", NS)
def test_forward_fft_kernel_matches_plain(n):
    dev = cuda_device()
    x = torch.from_numpy(blocks(n, 64 if n <= 4096 else 7)).to(dev)
    before = fft.forward_spectrum_four_step.launches
    got = fft.forward_spectrum_four_step(x)
    ref = fft.forward_spectrum_four_step_plain(x)
    assert fft.forward_spectrum_four_step.launches == before + 1
    assert_close_to_max(got.cpu().numpy(), ref.cpu().numpy(), 1e-5, f"N={n}")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 7, 512])
@pytest.mark.parametrize("n", NS)
def test_forward_fft_kernel_batches(n, b):
    """Kernel F (a radix FFT) against its plain version (the four-step
    product form) and float64 numpy, one to 512 blocks."""
    dev = cuda_device()
    x = blocks(n, b, salt=3)
    got = fft.forward_spectrum_four_step(torch.from_numpy(x).to(dev))
    ref = fft.forward_spectrum_four_step_plain(torch.from_numpy(x).to(dev))
    assert_close_to_max(got.cpu().numpy(), ref.cpu().numpy(), 1e-5, f"N={n}")
    want = np.fft.fftshift(np.fft.fft(x.astype(np.complex128), axis=-1),
                           axes=-1) / n
    assert rel_rms(got.cpu().numpy(), want) <= REL_RMS


@pytest.mark.cuda
def test_forward_fft_kernel_writes_into_spec_ext():
    """Kernel F writes rows 1..B of a [B + 1, N] extended spectrum and
    leaves row 0 alone."""
    dev = cuda_device()
    x = torch.from_numpy(blocks(4096, 512, salt=4)).to(dev)
    ext = torch.full((513, 4096), 3 + 4j, dtype=torch.complex64, device=dev)
    got = fft.forward_spectrum_four_step(x, out=ext[1:])
    assert got.data_ptr() == ext[1:].data_ptr()
    assert bool((ext[0] == 3 + 4j).all())
    assert torch.equal(ext[1:], fft.forward_spectrum_four_step(x))


@pytest.mark.cuda
@pytest.mark.parametrize("name", probes.PROBES)
def test_probe_kernel_matches_plain(name):
    dev = cuda_device()
    ins = [torch.from_numpy(a).to(dev) for a in probes.probe_inputs(name)]
    got = probes.tile_probe(name, *ins)
    ref = probes.tile_probe_plain(name, *ins)
    assert_close_to_max(got.cpu().numpy(), ref.cpu().numpy(), 1e-5, name)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32768, 65536, 131072])
def test_two_pass_kernel_matches_plain(n):
    """Kernel F's two-pass form against its plain version (the four-step
    product form) and float64 numpy, through the route's entry point."""
    dev = cuda_device()
    x = blocks(n, 5, salt=5)
    before = fft.forward_spectrum_two_pass.launches
    got = fft.forward_spectrum(torch.from_numpy(x).to(dev))
    assert fft.forward_spectrum_two_pass.launches == before + 1
    ref = fft.forward_spectrum_four_step_plain(torch.from_numpy(x).to(dev))
    assert_close_to_max(got.cpu().numpy(), ref.cpu().numpy(), 1e-5, f"N={n}")
    want = np.fft.fftshift(np.fft.fft(x.astype(np.complex128), axis=-1),
                           axes=-1) / n
    assert rel_rms(got.cpu().numpy(), want) <= REL_RMS


@pytest.mark.cuda
def test_two_pass_kernel_writes_into_spec_ext():
    dev = cuda_device()
    x = torch.from_numpy(blocks(32768, 16, salt=6)).to(dev)
    ext = torch.full((17, 32768), 3 + 4j, dtype=torch.complex64, device=dev)
    got = fft.forward_spectrum(x, out=ext[1:])
    assert got.data_ptr() == ext[1:].data_ptr()
    assert bool((ext[0] == 3 + 4j).all())
    assert torch.equal(ext[1:], fft.forward_spectrum_two_pass(x))


@pytest.mark.cuda
def test_fft_wrappers_refuse_bad_cuda_inputs():
    dev = cuda_device()
    with pytest.raises(ValueError):
        fft.forward_spectrum_four_step(
            torch.zeros(2, 32768, dtype=torch.complex64, device=dev))
    for n in (16384, 3 * 16384):  # kernel F's, not a power of two
        with pytest.raises(ValueError):
            fft.forward_spectrum_two_pass(
                torch.zeros(2, n, dtype=torch.complex64, device=dev))
    with pytest.raises(TypeError):
        fft.forward_spectrum_four_step(
            torch.zeros(2, 1024, dtype=torch.complex128, device=dev))
    with pytest.raises(ValueError):
        probes.tile_probe("p1", torch.zeros(32, 64, device=dev),
                          torch.zeros(64, 64, device=dev))
