"""Kernel P's work split, on the CPU.

Kernel P (``csrc/fft_probes.cu``) cannot run here, so :func:`run_model`
repeats its schedule in numpy: each probe's grid, every CTA's slice of
the output, the operands it stages in shared memory (the same row
strides and pads, unstaged words NaN) and the reads its threads make
from them, in the kernel's order (k ascending, float32). The model is
held against the probe's plain version (``probes.tile_probe_plain``):
bit-equal for the copy probes, 1e-5 of the max for the products (another
order of fp32 sums), on each probe's own inputs and, for the products
whose own f is I or 2I, again with a seeded random f. Also:

- the model's grid is the wrapper's (the CTA column of
  ``probes._PROBE``), which the kernel's ``kGrid`` checks at launch;
- every output element is written by exactly one thread of one CTA;
- each CTA's shared arrays fit the 48 KB a kernel has without an opt-in;
- every shared-memory read of a warp is free of bank conflicts: the
  distinct addresses of a 4-byte read (one phase of 32 lanes) or of a
  16-byte read (four phases of 8 lanes) touch distinct banks.
"""

import numpy as np
import pytest
import torch

from fdc_tpu_torch.ops import probes

TB, M, N = 8, 64, 4096
COPY_THREADS = 128
PAD = 4
BM, BN = 16, 32  # a product's slice
P4_BN = 8  # a p4 pipeline's columns a CTA
STATIC_SMEM = 48 * 1024
BANKS = 32

COPIES = ("m1", "p2", "p3", "p5", "p6")
EYE_F = ("m2", "m2p", "m3", "m4", "m5", "m6")  # f = I or 2I
PIPELINES = ("p4", "p4c", "p4d")
PRODUCTS = tuple(n for n in probes.PROBES
                 if n not in COPIES + PIPELINES)


def product_geometry(name):
    """(rows of the output, k, A transposed) of a product probe."""
    if name == "m2f":
        return M, M, False
    if name == "p1":
        return M, M, True
    if name == "m6":
        return TB * 32, 128, False
    return TB * M, M, False


def copy_src(name, e):
    """The input float4 that output float4 ``e`` copies."""
    if name == "p2":
        r = e >> 4
        return ((((r & 31) << 1) | (r >> 5)) << 4) | (e & 15)
    if name == "p3":
        r = e >> 4
        return ((r & 31) << 5) | ((r >> 5) << 4) | (e & 15)
    if name == "p6":
        p, q = e >> 5, e & 31
        return ((((q >> 4) << 5) | p) << 4) | (q & 15)
    return e


class Model:
    """One probe's run: the output, the writes to each element, each
    CTA's shared bytes and every warp read (words, width in words)."""

    def __init__(self, name, ins):
        self.name = name
        self.ins = [np.ascontiguousarray(a, np.float32).ravel() for a in ins]
        shape = probes._PROBE[name][0]
        self.out = np.full(int(np.prod(shape)), np.nan, np.float32)
        self.writes = np.zeros(self.out.size, np.int64)
        self.smem = []
        self.reads = []
        self.ctas = 0

    def write(self, idx, vals):
        idx = np.asarray(idx).ravel()
        self.out[idx] = np.asarray(vals, np.float32).ravel()
        np.add.at(self.writes, idx, 1)

    def read(self, words, width):
        """A shared read by the CTA's threads (in thread order)."""
        self.reads.append((np.asarray(words), width))


def stage(rows, width, ld, size, src, row):
    """A shared array of ``size`` floats, NaN where nothing is staged:
    rows r < ``rows`` of ``width`` floats from src[row(r):], stride ld."""
    dst = np.full(size, np.nan, np.float32)
    for r in range(rows):
        dst[r * ld:r * ld + width] = src[row(r):row(r) + width]
    return dst


def fma_rows(acc, a, b):
    """acc[t, j] += a[t] * b[t, j], in float32."""
    return (acc + a[:, None].astype(np.float32) * b).astype(np.float32)


def run_copy(mdl):
    x = mdl.ins[0]
    mdl.ctas = mdl.out.size // 4 // COPY_THREADS
    for cta in range(mdl.ctas):
        e = cta * COPY_THREADS + np.arange(COPY_THREADS)
        v = x.reshape(-1, 4)[copy_src(mdl.name, e)]
        if mdl.name == "m1":
            v = v * np.float32(2.0)
        mdl.write(4 * e[:, None] + np.arange(4), v)


def run_product(mdl):
    rows, k_len, ta = product_geometry(mdl.name)
    x, f = mdl.ins
    nt, groups = BM * BN // 4, BN // 4
    lda = BM if ta else k_len + PAD
    mdl.ctas = rows // BM * (k_len // BN)
    t = np.arange(nt)
    r, c = t // groups, 4 * (t % groups)
    for cta in range(mdl.ctas):
        m0, n0 = cta // (k_len // BN) * BM, cta % (k_len // BN) * BN
        if ta:
            a_s = stage(k_len, BM, BM, k_len * BM, x,
                        lambda k: k * rows + m0)
        else:
            a_s = stage(BM, k_len, lda, BM * lda, x,
                        lambda i: (m0 + i) * k_len)
        b_s = stage(k_len, BN, BN, k_len * BN, f, lambda k: k * k_len + n0)
        mdl.smem.append(4 * (a_s.size + b_s.size))
        acc = np.zeros((nt, 4), np.float32)
        for k in range(k_len):
            if ta:
                mdl.read(k * BM + r, 1)
                a = a_s[k * BM + r]
            else:
                if k % 4 == 0:
                    mdl.read(r * lda + k, 4)
                a = a_s[r * lda + k]
            mdl.read(k * BN + c, 4)
            acc = fma_rows(acc, a, b_s[k * BN + c[:, None] + np.arange(4)])
        mdl.write((m0 + r)[:, None] * k_len + n0 + c[:, None]
                  + np.arange(4), acc)


def run_pipeline(mdl):
    full = mdl.name != "p4c"
    x, f = mdl.ins[:2]
    g, tw = (mdl.ins[2], mdl.ins[3]) if full else (None, None)
    nt, groups, ldg = M * P4_BN // 4, P4_BN // 4, M + PAD
    blocks = 1 if mdl.name == "p4d" else TB
    mdl.ctas = blocks * (M // P4_BN)
    t = np.arange(nt)
    i, c = t // groups, 4 * (t % groups)
    cols = c[:, None] + np.arange(4)
    for cta in range(mdl.ctas):
        b, j0 = cta // (M // P4_BN), cta % (M // P4_BN) * P4_BN
        blk = b * N
        xs = stage(M, M, M, M * M, x,
                   lambda k: blk + (k & 31) * 2 * M + (k >> 5) * M)
        fs = stage(M, P4_BN, P4_BN, M * P4_BN, f, lambda k: k * M + j0)
        sizes = [xs.size, fs.size]
        if full:
            ts = stage(M, P4_BN, P4_BN, M * P4_BN, tw, lambda k: k * M + j0)
            gs = stage(M, M, ldg, M * ldg, g, lambda r: r * M)
            sizes += [ts.size, gs.size, M * P4_BN]
        else:
            sizes += [4, 4, 4]
        mdl.smem.append(4 * sum(sizes))
        if mdl.name == "p4d":  # the zero rows: blocks 1..7, a float4 a step
            e = cta * nt + t
            for step in range(TB - 1):
                q = N // 4 + step * (N // 4) + e
                mdl.write(4 * q[:, None] + np.arange(4),
                          np.zeros((nt, 4), np.float32))
        acc = np.zeros((nt, 4), np.float32)
        for k in range(M):
            mdl.read(k * M + i, 1)
            mdl.read(k * P4_BN + c, 4)
            acc = fma_rows(acc, xs[k * M + i], fs[k * P4_BN + cols])
        if full:
            acc = (acc * ts[i[:, None] * P4_BN + cols]).astype(np.float32)
            ss = np.full(M * P4_BN, np.nan, np.float32)
            ss[i[:, None] * P4_BN + cols] = acc
            acc = np.zeros((nt, 4), np.float32)
            for k in range(M):
                if k % 4 == 0:
                    mdl.read(i * ldg + k, 4)
                mdl.read(k * P4_BN + c, 4)
                acc = fma_rows(acc, gs[i * ldg + k], ss[k * P4_BN + cols])
        mdl.write(blk + i[:, None] * M + j0 + cols, acc)


def random_f_inputs(name):
    """Probe ``name``'s own x with f seeded noise (numpy seed 1): its own
    f is I or 2I, which a kernel staging f transposed would pass."""
    x, f = probes.probe_inputs(name)
    return x, np.random.default_rng(1).standard_normal(f.shape).astype(
        np.float32)


def run_model(name, ins=None):
    ins = probes.probe_inputs(name) if ins is None else ins
    mdl = Model(name, ins)
    if name in COPIES:
        run_copy(mdl)
    elif name in PIPELINES:
        run_pipeline(mdl)
    else:
        run_product(mdl)
    return mdl


_MODELS = {}


def model(name):
    if name not in _MODELS:
        _MODELS[name] = run_model(name)
    return _MODELS[name]


def conflict_free(words, width):
    """One warp's read: in each phase (32 lanes for 4 bytes, 8 for 16),
    the distinct addresses touch distinct banks (one address read by many
    lanes is a broadcast)."""
    lanes = BANKS // width
    for p in range(0, len(words), lanes):
        w = np.unique(words[p:p + lanes])
        banks = ((w[:, None] + np.arange(width)) % BANKS).ravel()
        if len(np.unique(banks)) != len(banks):
            return False
    return True


def test_the_split_covers_every_probe():
    assert set(COPIES + PIPELINES + PRODUCTS) == set(probes.PROBES)
    assert len(PRODUCTS) == 8


@pytest.mark.parametrize("name", probes.PROBES)
def test_model_grid_is_the_wrappers(name):
    mdl = model(name)
    assert mdl.ctas == probes._PROBE[name][1]
    least = {"m1": 16, "m2f": 4, "p1": 4, "p4d": 4}.get(name, 8)
    if name in ("m2", "m2p", "m3", "m4", "m5"):
        least = 32
    assert mdl.ctas >= least


@pytest.mark.parametrize("name", probes.PROBES)
def test_every_output_written_by_one_cta(name):
    mdl = model(name)
    assert (mdl.writes == 1).all(), np.flatnonzero(mdl.writes != 1)[:8]


def assert_model_matches_plain(mdl, ins):
    ref = probes.tile_probe_plain(
        mdl.name, *map(torch.from_numpy, ins)).numpy().ravel()
    assert not np.isnan(mdl.out).any()  # no unstaged word was read
    if mdl.name in COPIES:
        assert np.array_equal(mdl.out, ref)
    else:
        err = np.abs(mdl.out.astype(np.float64) - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), err


@pytest.mark.parametrize("name", probes.PROBES)
def test_model_matches_plain(name):
    assert_model_matches_plain(model(name), probes.probe_inputs(name))


@pytest.mark.parametrize("name", EYE_F)
def test_model_matches_plain_with_random_f(name):
    ins = random_f_inputs(name)
    mdl = run_model(name, ins)
    assert (mdl.writes == 1).all()
    assert_model_matches_plain(mdl, ins)


@pytest.mark.parametrize("name", probes.PROBES)
def test_staged_bytes_fit_shared_memory(name):
    mdl = model(name)
    if name in COPIES:
        assert mdl.smem == []  # device memory to device memory
        return
    assert len(mdl.smem) == mdl.ctas
    assert max(mdl.smem) <= STATIC_SMEM, max(mdl.smem)


@pytest.mark.parametrize("name", PRODUCTS + PIPELINES)
def test_shared_reads_free_of_bank_conflicts(name):
    mdl = model(name)
    assert mdl.reads
    for words, width in mdl.reads:
        for w in range(0, len(words), 32):
            assert conflict_free(words[w:w + 32], width), (
                name, width, words[w:w + 32])


def test_conflict_check_sees_a_conflict():
    """The check itself: A's rows read unpadded (stride 64) by four lanes
    of a phase collide, the kernel's pad of 4 words does not."""
    lanes = np.repeat(np.arange(4), 2)  # p4's second product, 8 lanes
    assert not conflict_free(lanes * M, 4)
    assert conflict_free(lanes * (M + PAD), 4)
    assert conflict_free(np.zeros(32, np.int64), 4)  # a broadcast
    assert not conflict_free(np.arange(32) * 2, 1)
