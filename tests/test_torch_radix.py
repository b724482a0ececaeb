"""Kernel F's radix schedule and kernel A's tile chooser, on the CPU.

Kernel F (``csrc/forward_fft.cu``) is a Stockham radix FFT; a CUDA kernel
cannot run here, so :func:`radix_model` repeats its exact passes in numpy
float32: the radices of ``fft.RADIX_PLANS`` in order, the Stockham index
maps, the float32 twiddle table ``fft._radix_twiddles``, float32
radix-R DFTs, then the fftshift as an index remap and the 1/N scale. It
is held against the plain version (the four-step product form), float64
numpy and JAX's ``forward_spectrum_mxu`` on its CPU backend at every N,
to rel-RMS <= 2e-6 and 1e-5 of the max (another order of fp32 sums; the
model measures ~1.6e-7 rel-RMS against float64 at N = 16384).

Kernel A's ``gemm_plan`` is held on every bucket shape that the nine
paths of ``chip_smoke.py`` hand kernel A: the tiles cover M x nout
exactly, the grid has at least 132 CTAs where the shape allows, and nout
is padded by at most an eighth. Also: ``out=`` of the front end, the
measures' k range, and the step writing its spectrum straight into the
extended spectrum (no concatenation).
"""

import numpy as np
import pytest
import torch

from fdc_tpu_torch.ops import extract_fused, fft

NS = sorted(fft.RADIX_PLANS)
REL_RMS = 2e-6
MAX_TOL = 1e-5


def blocks(n, b, salt=0):
    rng = np.random.default_rng(7 * n + salt)
    return (rng.standard_normal((b, n))
            + 1j * rng.standard_normal((b, n))).astype(np.complex64)


def rel_rms(got, ref):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2)
                         / np.mean(np.abs(ref) ** 2)))


def assert_close(got, ref):
    assert rel_rms(got, ref) <= REL_RMS
    err = np.abs(np.asarray(got, np.complex128) - ref).max()
    assert err <= MAX_TOL * np.abs(ref).max()


def radix_model(x):
    """Kernel F's passes on [B, N] complex64 blocks, in numpy float32."""
    b, n = x.shape
    values, radices = fft.RADIX_PLANS[n]
    assert int(np.prod(radices)) == n and n // values * values == n
    tw = fft._radix_twiddles(n, torch.device("cpu")).numpy()
    buf = x.astype(np.complex64)
    ns = 1
    for r in radices:
        assert values % r == 0  # whole butterflies a thread
        span = n // r
        j = np.arange(span)
        k = j % ns
        rr = np.arange(r)
        v = buf[:, j[:, None] + rr[None] * span]  # [B, N/R, R]
        v = v * tw[rr[None] * k[:, None] * (n // (ns * r))]
        w = np.exp(-2j * np.pi * np.outer(rr, rr) / r).astype(np.complex64)
        v = v @ w
        nxt = np.empty_like(buf)
        nxt[:, ((j // ns) * ns * r + k)[:, None] + rr[None] * ns] = v
        buf, ns = nxt, ns * r
    spec = np.empty_like(buf)
    spec[:, (np.arange(n) + n // 2) % n] = buf  # the shift as a remap
    return spec * np.float32(1.0 / n)


@pytest.mark.parametrize("n", NS)
def test_radix_model_matches_plain_and_float64(n):
    x = blocks(n, 4)
    got = radix_model(x)
    assert got.dtype == np.complex64
    plain = fft.forward_spectrum_four_step_plain(torch.from_numpy(x))
    assert_close(got, plain.numpy().astype(np.complex128))
    ref = np.fft.fftshift(np.fft.fft(x.astype(np.complex128), axis=-1),
                          axes=-1) / n
    assert_close(got, ref)


@pytest.mark.parametrize("n", NS)
def test_radix_model_matches_jax(n):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from fdc_tpu.ops.fft import forward_spectrum_mxu

    x = blocks(n, 3, salt=1)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(forward_spectrum_mxu(jnp.asarray(x)))
    assert_close(radix_model(x), ref.astype(np.complex128))


def test_radix_twiddles_are_rounded_once():
    for n in NS:
        tw = fft._radix_twiddles(n, torch.device("cpu")).numpy()
        want = np.exp(-2j * np.pi * np.arange(n) / n)
        assert tw.dtype == np.complex64
        np.testing.assert_array_equal(tw, want.astype(np.complex64))


@pytest.mark.parametrize("use_mxu,n", [(True, 1024), (False, 1024),
                                       (True, 128)])
def test_front_end_writes_into_spec_ext_rows(use_mxu, n):
    """``out=`` fills rows 1..B of a [B + 1, N] buffer with the spectrum
    and leaves row 0 alone (the plain version and the FFT route copy)."""
    x = torch.from_numpy(blocks(n, 5, salt=2))
    ext = torch.full((6, n), 3 + 4j, dtype=torch.complex64)
    got = fft.forward_spectrum(x, use_mxu=use_mxu, out=ext[1:])
    assert got.data_ptr() == ext[1:].data_ptr()
    assert bool((ext[0] == 3 + 4j).all())
    assert torch.equal(ext[1:], fft.forward_spectrum(x, use_mxu=use_mxu))
    if use_mxu and n >= 256:
        ext2 = torch.zeros_like(ext)
        fft.forward_spectrum_four_step(x, out=ext2[1:])
        assert torch.equal(ext2, torch.cat([torch.zeros_like(ext[:1]),
                                            ext[1:]]))


def test_step_writes_spectrum_into_spec_ext(monkeypatch):
    """The sample step hands the front end rows 1..B of the extended
    spectrum, and the extraction reads that same buffer: no copy joins
    the previous row to the batch."""
    from fdc_tpu_torch import FrequencyDomainChannelizer
    from fdc_tpu_torch.flagship import _flagship
    from fdc_tpu_torch.models import channelizer

    fdc = FrequencyDomainChannelizer(
        _flagship(blocksize=1024, batch_blocks=8, n_channels=16),
        device="cpu")
    seen = {}
    front = channelizer.forward_spectrum

    def spy_front(blocks, use_mxu=True, out=None):
        seen["out"] = out.data_ptr()
        return front(blocks, use_mxu=use_mxu, out=out)

    inner = fdc._extract_static

    def spy_extract(spec, spec_ext, t0):
        seen["ext"] = (spec_ext.data_ptr(), spec_ext[1:].data_ptr(),
                       spec.data_ptr())
        return inner(spec, spec_ext, t0)

    monkeypatch.setattr(channelizer, "forward_spectrum", spy_front)
    monkeypatch.setattr(fdc, "_extract_static", spy_extract)
    carry = fdc._device_init()
    carry["prev_spec"] = torch.full_like(carry["prev_spec"], 1 + 2j)
    x = torch.zeros(fdc.batch_samples, dtype=torch.complex64)
    new, _ = fdc._device_step(carry, x, 0)
    _, rows_ptr, spec_ptr = seen["ext"]
    assert seen["out"] == rows_ptr == spec_ptr
    assert torch.equal(new["prev_spec"], torch.zeros_like(x[:1024]))


# --- kernel A's tiles ----------------------------------------------------

def path_configs():
    """The nine paths' configurations (chip_smoke.path_table), each cut
    to 8 blocks a batch: bucket shapes scale with the rows only."""
    from fdc_tpu_torch import flagship as fl

    return {
        "flagship": fl._flagship(batch_blocks=8),
        "example": fl.reference_example(batch_blocks=8),
        "powact32": fl.powact32(batch_blocks=8),
        "dama16": fl.cfg2_dama16(batch_blocks=8),
        "segdet": fl.cfg4_segdet(batch_blocks=8),
        "hunter512": fl.cfg5_burst_hunter512(batch_blocks=8),
        "hunter4seg": fl.cfg5b_burst_hunter_4seg(batch_blocks=8),
        "split4": fl.cfg5s_burst_hunter_split4(batch_blocks=8),
    }


def a_calls(cfg):
    """(M, nout, K, masks) of every kernel A call of one step at
    B = 512: the step runs at 8 blocks on the CPU with the wrappers
    recorded, and rows 8 / 9 (B / B + 1) become 512 / 513."""
    from fdc_tpu_torch import FrequencyDomainChannelizer

    calls = []

    def record(fn, measured):
        def rec(spec, starts, mat, *a, **kw):
            masks = (a[0] if a else kw.get("masks")) if measured else None
            calls.append((spec.shape[0], starts.numel(), mat.shape, masks))
            return fn(spec, starts, mat, *a, **kw)
        return rec

    fdc = FrequencyDomainChannelizer(cfg, device="cpu")
    saved = extract_fused.extract_shared, extract_fused.extract_shared_fold
    try:
        extract_fused.extract_shared = record(saved[0], True)
        extract_fused.extract_shared_fold = record(saved[1], False)
        x = torch.zeros(fdc.batch_samples, dtype=torch.complex64)
        fdc._device_step(fdc._device_init(), x, 0)
    finally:
        extract_fused.extract_shared, extract_fused.extract_shared_fold = saved
    rows = {8: 512, 9: 513}
    return [(c * rows[r], k2, l2, masks) for r, c, (l2, k2), masks in calls]


@pytest.fixture(scope="module")
def shapes():
    out = {name: a_calls(cfg) for name, cfg in path_configs().items()}
    # the vcm path (config 5b's detector) has no throughput: no kernel A
    assert out["flagship"] and out["example"] and out["dama16"]
    return out


def test_gemm_plan_on_every_path_bucket(shapes):
    seen = set()
    for name, calls in shapes.items():
        for m, nout, k, _ in calls:
            bm, bn, splits, k_chunk = extract_fused.gemm_plan(m, nout, k)
            seen.add((name, m, nout, k))
            rows, cols = -(-m // bm), -(-nout // bn)
            # the tiles cover M x nout exactly, and the splits K
            assert (rows - 1) * bm < m <= rows * bm
            assert (cols - 1) * bn < nout <= cols * bn
            assert (splits - 1) * k_chunk < k <= splits * k_chunk
            assert k_chunk % extract_fused.BK == 0
            # nout padded by at most an eighth
            assert 8 * (cols * bn - nout) <= nout, (name, nout, bn)
            ctas = rows * cols * splits
            if ctas < extract_fused.SMS:
                # only where no tile and k split of the allowed ones (at
                # least MIN_SPLIT_STAGES stages) could fill the card
                most = max(1, -(-k // extract_fused.BK)
                           // extract_fused.MIN_SPLIT_STAGES)
                assert all(-(-m // extract_fused.TILE_M) * -(-nout // tn)
                           * most < extract_fused.SMS
                           for tn in extract_fused.TILE_N), (name, m, nout)
    # the buckets the kernel table names
    assert ("flagship", 32768, 96, 128) in seen
    assert ("example", 512, 1536, 2048) in seen
    assert ("powact32", 16416, 192, 256) in seen
    assert ("dama16", 8192, 384, 512) in seen


def test_gemm_plan_fills_the_card_on_the_large_buckets(shapes):
    for name, m, nout, k in [("flagship", 32768, 96, 128),
                             ("example", 512, 1536, 2048),
                             ("powact32", 16416, 192, 256),
                             ("dama16", 8192, 384, 512)]:
        bm, bn, splits, _ = extract_fused.gemm_plan(m, nout, k)
        assert -(-m // bm) * -(-nout // bn) * splits >= extract_fused.SMS
        assert nout % bn == 0, name


def test_measure_plan_on_every_measured_bucket(shapes):
    measured = [(name, m, masks) for name, calls in shapes.items()
                for m, _, _, masks in calls if masks is not None]
    assert {n for n, _, _ in measured} == {"flagship", "example"}
    for name, m, masks in measured:
        cols, k_lo, k_hi = extract_fused.mask_extent(masks)
        used = (masks != 0).any(0)
        # the leading columns in use, zero padding after them
        assert cols == int(used.sum()) and bool(used[:cols].all())
        rows_nz = torch.nonzero((masks != 0).any(1)).flatten()
        assert k_lo % extract_fused.BK == 0
        assert k_lo <= int(rows_nz[0]) and k_hi == int(rows_nz[-1]) + 1
        splits, chunk = extract_fused.measure_plan(512, cols, k_lo, k_hi)
        assert (splits - 1) * chunk < k_hi - k_lo <= splits * chunk
        bm, bn = extract_fused.MEASURE_TILE
        ctas = -(-512 // bm) * -(-cols // bn) * splits
        assert ctas >= extract_fused.SMS
        # four CTAs an SM, unless the splits are as short as allowed
        assert ctas >= extract_fused.MEASURE_CTAS or chunk == (
            extract_fused.MEASURE_MIN_STAGES * extract_fused.BK)


def test_mask_extent_is_cached_per_tensor():
    """The extent is a plain function of the masks (host memory, numpy or
    a CPU tensor), which the channelizer computes once where it builds
    them and keeps beside them (no cache, no device sync a call)."""
    m = np.zeros((256, 8), np.float32)
    m[40:50, 0] = 1.0
    m[100:120, 2] = 1.0
    assert extract_fused.mask_extent(m) == (3, 32, 120)
    m[200, 5] = 1.0
    assert extract_fused.mask_extent(torch.from_numpy(m)) == (6, 32, 201)
    assert extract_fused.mask_extent(np.zeros((256, 8))) == (0, 0, 0)


@pytest.mark.parametrize("name", ["flagship", "example"])
def test_channelizer_keeps_its_masks_extent(name):
    """The measured paths' channelizers keep their masks' extent, and
    everything outside it is exact zeros (what kernel A skips)."""
    from fdc_tpu_torch import FrequencyDomainChannelizer

    fdc = FrequencyDomainChannelizer(path_configs()[name], device="cpu")
    masks = fdc.measure_masks.numpy()
    cols, k_lo, k_hi = fdc._measure_extent
    assert (cols, k_lo, k_hi) == extract_fused.mask_extent(masks)
    # the leading columns the detection consumers use
    assert cols == max(hi for _, hi in fdc._measure_cols.values())
    inside = np.zeros_like(masks, bool)
    inside[k_lo:k_hi, :cols] = True
    assert not masks[~inside].any() and masks[inside].any()


@pytest.mark.parametrize("shape, plan", [
    ((32768, 96, 128), (128, 96, 1, 128)),    # flagship, 256 tiles
    ((513, 192, 256), (128, 96, 8, 32)),      # flagship burst, 10 tiles
    ((512, 1536, 2048), (128, 96, 4, 512)),   # example, 64 tiles
    ((16416, 192, 256), (128, 96, 1, 256)),   # powact32, 258 tiles
    ((8192, 384, 512), (128, 96, 1, 512)),    # dama16, 256 tiles
    ((1000, 64, 64), (128, 64, 2, 32)),       # 8 tiles, 2 splits at most
])
def test_gemm_plan_rule(shape, plan):
    """One tile height, the preferred width that pads by at most an
    eighth, and the most k splits (of at least MIN_SPLIT_STAGES stages)
    whose grid still runs in one wave of WAVE CTAs."""
    assert extract_fused.gemm_plan(*shape) == plan
