"""fdc_tpu_torch's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor fdc_tpu, so it also runs on the
machine with the card, where JAX is absent:

    python -m pytest --noconftest -o addopts="" tests/test_torch_kernels.py -q

Tests marked ``cuda`` need a CUDA device (the kernels have no CPU mode)
and skip without one; the others check the dispatch rule on the CPU.
Tolerances: extractions rtol 2e-4 / atol 2e-5 of each tensor's max,
measures rtol 1e-5 (another accumulation order), flags, slot tables and
burst states exact.
"""

import numpy as np
import pytest
import torch

from fdc_tpu_torch import kernels
from fdc_tpu_torch.models.segment_detection import SegmentDetector
from fdc_tpu_torch.ops import detect, extract, extract_fused, lifecycle, powact
from fdc_tpu_torch.ops.fft import _rr_idft_matrix, interleave_rows

RTOL, ATOL, PRTOL = 2e-4, 2e-5, 1e-5


def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def assert_close_to_max(got, ref, rtol=RTOL, atol=ATOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    assert np.all(err <= atol * np.abs(ref).max() + rtol * np.abs(ref)), (
        f"max abs err {err.max()}")


def bucket(rng, rows, n, l, c):
    spec = torch.from_numpy((rng.standard_normal((rows, n))
                             + 1j * rng.standard_normal((rows, n))
                             ).astype(np.complex64))
    starts = torch.from_numpy(
        np.sort(rng.choice(n - l, c, replace=False)).astype(np.int32))
    win = rng.random(l).astype(np.float32) + 0.1
    m = _rr_idft_matrix(l, l // 4, True, float(l), pairs=True)
    folded = (np.concatenate([win, win])[:, None] * m).astype(np.float32)
    return spec, starts, torch.from_numpy(interleave_rows(folded))


def static_bucket(rng, rows, n, l, c):
    """A bucket whose channels each have their own window (kernel E)."""
    spec = torch.from_numpy((rng.standard_normal((rows, n))
                             + 1j * rng.standard_normal((rows, n))
                             ).astype(np.complex64))
    starts = np.sort(rng.choice(n - l, c, replace=False)).astype(np.int32)
    wins = rng.random((c, l)).astype(np.float32) + 0.1
    mats = extract.static_folded_matrices(n, starts, wins, l // 4, float(l))
    return spec, torch.from_numpy(starts), torch.from_numpy(mats)


def powact_inputs(rng, nb, c):
    """[B, C] powers straddling a 10 dB threshold, a mixed state, and the
    init (lastpower = FLT_MAX) and zero-power floor (FLT_MIN) edges."""
    flt_min = np.float32(1.1754944e-38)
    powers = np.exp(rng.normal(0, 2.0, (nb, c))).astype(np.float32)
    powers[rng.random((nb, c)) < 0.02] = flt_min
    lastpower = np.exp(rng.normal(0, 2.0, c)).astype(np.float32)
    lastpower[::3] = np.float32(3.4028235e38)
    state = {
        "active": torch.from_numpy(rng.random(c) < 0.5),
        "lastpower": torch.from_numpy(lastpower),
        "phase": torch.from_numpy(rng.integers(0, 4, c).astype(np.int32)),
    }
    # negative increments too: the phase is a floor modulo
    delta = torch.from_numpy(rng.integers(-3, 4, c).astype(np.int32))
    return torch.from_numpy(powers), state, delta


def lifecycle_inputs(rng, nb, shapes, n_pa):
    """Packs from busy powers and half-occupied slot tables per segment,
    plus burst powers with on/off edges."""
    packs, states, sds = [], [], []
    for band, slots, k, minchandist in shapes:
        sd = SegmentDetector(0, 1024, 4, band[0], band[1], 6.0, minchandist,
                             0.2,
                             channel_deactivation_delay=1, max_slots=slots,
                             max_candidates=k, max_extract_width=256)
        nc = sd.geometry.n_cells
        p = np.full((nb, nc), 1e-6) + rng.random((nb, nc)) * 2e-6
        for _ in range(6):
            c0 = rng.integers(2, nc - 8)
            on = rng.integers(0, nb - 2)
            p[on:rng.integers(on + 1, nb), c0:c0 + rng.integers(1, 6)] += 1.0
        packs.append(sd._packed_candidates(torch.from_numpy(
            p.astype(np.float32))))
        st = sd.init_state("cpu")
        es = rng.integers(sd.geometry.start, sd.geometry.stop - 64, slots)
        st.update(
            active=torch.from_numpy(rng.random(slots) < 0.5),
            det_start=torch.from_numpy((es + 5).astype(np.int32)),
            det_stop=torch.from_numpy((es + 25).astype(np.int32)),
            ext_start=torch.from_numpy(es.astype(np.int32)),
            order=torch.from_numpy(rng.permutation(slots).astype(np.int32)),
            alloc_counter=torch.tensor(slots, dtype=torch.int32),
        )
        states.append(st)
        sds.append(sd)
    pw = np.exp(rng.normal(0, 2.0, (nb, n_pa))).astype(np.float32)
    powact = {
        "powers": torch.from_numpy(pw),
        "lastpower": torch.ones(n_pa),
        "active": torch.from_numpy(rng.random(n_pa) < 0.5),
        "phase": torch.zeros(n_pa, dtype=torch.int32),
        "delta": torch.from_numpy(rng.integers(0, 4, n_pa).astype(np.int32)),
    }
    kw = dict(n_cands=tuple(sd.k_pack for sd in sds), rs=(4,) * len(sds),
              delays=(1,) * len(sds), powact=powact, pa_r=4,
              pa_thresh=10.0)
    return packs, states, kw


def synthetic_lifecycle(rng, s, k, nb, compact, r=4):
    """A [B, 7K] pack with 0 ... 8 valid candidates a block (a few blocks
    with up to K), compacted to the front or at random columns, overlapping
    intervals, 10% too big; a slot table half live, a few tombstones,
    negative orders, and a quarter of the slots with another's interval
    and order (ties)."""
    pack = np.zeros((nb, 7, k), np.int32)
    for b in range(nb):
        nv = int(rng.integers(0, min(k, 8) + 1))
        if b % 11 == 5:
            nv = int(rng.integers(0, k + 1))  # a crowded block
        cols = (np.arange(nv) if compact
                else np.sort(rng.choice(k, nv, replace=False)))
        cs = rng.integers(0, 600, nv)
        es = cs - rng.integers(0, 9, nv)
        pack[b, 0, cols] = cs
        pack[b, 1, cols] = cs + rng.integers(1, 40, nv)
        pack[b, 2, cols] = 1
        pack[b, 3, cols] = rng.integers(2, 9, nv)
        pack[b, 4, cols] = es
        pack[b, 5, cols] = es % r
        pack[b, 6, cols] = rng.random(nv) < 0.1
    ds = rng.integers(0, 600, s)
    de = ds + rng.integers(5, 60, s)
    order = rng.permutation(s) - s // 3
    # a quarter of the slots copy another's interval and order: ties
    # between lanes and between one lane's registers (the lower slot wins)
    dup = rng.choice(s, s // 4 + 1, replace=False)
    src = rng.choice(s, dup.size)
    ds[dup], de[dup], order[dup] = ds[src], de[src], order[src]
    state = {
        "active": rng.random(s) < 0.5,
        "tomb": rng.random(s) < 0.05,
        "det_start": ds.astype(np.int32),
        "det_stop": de.astype(np.int32),
        "ext_start": (ds - 4).astype(np.int32),
        "wlog2": rng.integers(2, 9, s).astype(np.int32),
        "phase": rng.integers(-3, 4, s).astype(np.int32),
        "phase_inc": rng.integers(0, r, s).astype(np.int32),
        "inactive": rng.integers(0, 4, s).astype(np.int32),
        "order": order.astype(np.int32),
        "alloc_counter": np.int32(s),
        "dropped": np.int32(3),
    }
    return pack.reshape(nb, 7 * k), state


def _floor(nb, nc, rng):
    """A noise floor whose ratios stay between the 6 dB thresholds."""
    return (1.0 + 0.1 * rng.random((nb, nc))).astype(np.float32)


def _carriers(p, rng, n, widths, levels):
    """Lay ``n`` carriers a block at random cells over ``p``."""
    nb, nc = p.shape
    for b in range(nb):
        for _ in range(n):
            w = int(rng.integers(*widths))
            c0 = int(rng.integers(0, nc - w))
            p[b, c0:c0 + w] *= float(rng.uniform(*levels))
    return p


def _all_rises(nb, nc, rng):
    # a rise at every position (ratios 1.05 ... 1.1 > 0.1 dB), no fall
    steps = 1.05 + 0.05 * rng.random((nb, nc))
    return np.cumprod(steps, 1).astype(np.float32)


def _alternating(nb, nc, rng):
    # 1, 100, 1, 100, ...: equal rises at every other cell (ties), each
    # paired with the next fall, all touching: a full pack
    p = np.ones((nb, nc), np.float32)
    p[:, 1::2] = 100.0
    return p


def _zeros(nb, nc, rng):
    # x / 0 = +inf rises (several a block: ties to the lower index) and
    # 0 / 0, which is no edge, or with zero_floor a fall
    p = _floor(nb, nc, rng)
    for b in range(nb):
        for c in rng.choice(nc - 4, 6, replace=False):
            p[b, c:c + int(rng.integers(1, 4))] = 0.0
    return p


def _touching(nb, nc, rng):
    # per block A = [a, f + 1) strongest, B starting at f + 1 (touches A
    # from the right: accepted), C ending at a (touches A from the left:
    # blocked, the test is e_j >= s_i)
    p = np.ones((nb, nc), np.float32)
    for b in range(nb):
        c = int(rng.integers(1, nc - 24))
        a, f = c + 6, c + 12
        p[b, c + 1:a] = 20.0  # C: rise at c, fall at a - 1
        p[b, a + 1:f + 1] = 100.0  # A: rise at a, fall at f
        p[b, f + 2:f + 8] = 50.0  # B: rise at f + 1, fall at f + 7
    return p


def _busy(nb, nc, rng):
    return _carriers(_floor(nb, nc, rng), rng, 12, (1, 9), (10.0, 1e4))


def _wide(nb, nc, rng):
    # one carrier over most of the segment: ext_w > N, ext_start < 0
    p = _floor(nb, nc, rng)
    p[:, 2:nc - 3] *= 1000.0
    return p


def _empty(nb, nc, rng):
    return np.ones((nb, nc), np.float32)


# kernel B's edge cases: name -> (SegmentDetector args, keywords, powers
# maker (nb, n_cells, rng) -> [nb, n_cells] float32). Segdet's geometry
# (4096 points, 90% of the band, 10-bin cells) has 369 cells, 368 ratios.
_SEGDET = (0, 4096, 4, 0.05, 0.95, 6.0, 0.005, 0.2)
PACK_EDGES = {
    "all-rises": ((0, 4096, 4, 0.05, 0.95, 0.1, 0.005, 0.2),
                  dict(max_candidates=0), _all_rises),
    "all-rises-K16": ((0, 4096, 4, 0.05, 0.95, 0.1, 0.005, 0.2),
                      dict(max_candidates=16), _all_rises),
    "alternating": (_SEGDET, dict(max_candidates=0), _alternating),
    "zeros": ((0, 1024, 4, 0.1, 0.6, 6.0, 0.02, 0.2),
              dict(max_candidates=0), _zeros),
    "zeros-zero-floor": ((0, 1024, 4, 0.1, 0.6, 6.0, 0.02, 0.2),
                         dict(max_candidates=0, vcm=True), _zeros),
    "truncation-K4": (_SEGDET, dict(max_candidates=4), _busy),
    "touching": ((0, 1024, 4, 0.1, 0.6, 6.0, 0.02, 0.2),
                 dict(max_candidates=0), _touching),
    "empty": (_SEGDET, dict(max_candidates=16), _empty),
    "negative-es": ((0, 1024, 4, 0.02, 0.98, 6.0, 0.02, 0.2),
                    dict(max_candidates=0, max_extract_width=0), _wide),
    "max-cells": ((0, 4096, 4, 0.25, 0.75, 6.0, 0.0002, 0.2),
                  dict(max_candidates=0), _busy),
}


def pack_edge(name, nb, seed=0):
    """(SegmentDetector args, keywords, [nb, n_cells] powers) of one of
    kernel B's edge cases."""
    args, kw, make = PACK_EDGES[name]
    sd = SegmentDetector(*args, **kw)
    rng = np.random.default_rng(seed)
    return args, kw, make(nb, sd.geometry.n_cells, rng)


def to(tree, dev):
    if isinstance(tree, dict):
        return {k: to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def assert_tree_equal(got, ref, what):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), what
        for k in ref:
            assert_tree_equal(got[k], ref[k], f"{what}[{k}]")
    elif isinstance(ref, (list, tuple)):
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_tree_equal(g, r, f"{what}[{i}]")
    else:
        assert got.dtype == ref.dtype and got.shape == ref.shape, what
        np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy(),
                                      err_msg=what)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors every wrapper computes its plain version and never
    touches the kernel library (here it could not even be built)."""
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("launched"))
    rng = np.random.default_rng(0)
    spec, starts, mat = bucket(rng, 5, 256, 16, 3)
    before = (extract_fused.extract_shared.launches,
              detect.greedy_accept_batch.launches,
              lifecycle.slot_lifecycle_multi.launches)
    out = extract_fused.extract_shared(spec, starts, mat)
    assert_close_to_max(out, extract_fused.extract_shared_plain(
        spec, starts, mat))
    cs = torch.from_numpy(rng.integers(0, 30, (6, 8)).astype(np.int32))
    acc = detect.greedy_accept_batch(cs, cs + 3, torch.ones(6, 8,
                                                            dtype=torch.bool))
    assert acc[:, 0].all()
    packs, states, kw = lifecycle_inputs(rng, 8, [((0.55, 0.8), 8, 0, 0.02)],
                                         1)
    lifecycle.slot_lifecycle_multi(packs, states, **kw)
    assert before == (extract_fused.extract_shared.launches,
                      detect.greedy_accept_batch.launches,
                      lifecycle.slot_lifecycle_multi.launches)


def test_cpu_tensors_take_the_plain_version_packs(monkeypatch):
    """candidate_packs on CPU tensors: the plain version, as views of one
    flat buffer, no launch."""
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("launched"))
    args, kw, power = pack_edge("touching", 6)
    sd = SegmentDetector(*args, **kw)
    before = detect.candidate_packs.launches
    packs = detect.candidate_packs([torch.from_numpy(power)] * 2,
                                   [sd.pack_spec] * 2)
    assert detect.candidate_packs.launches == before
    assert packs[1].storage_offset() == packs[0].numel()
    assert torch.equal(packs[0], packs[1])


def test_cpu_tensors_take_the_plain_version_burst(monkeypatch):
    """Kernels D and E: CPU tensors compute the plain version, launch
    nothing and count nothing."""
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("launched"))
    rng = np.random.default_rng(8)
    before = (extract_fused.extract_static.launches,
              powact.powact_flags.launches)
    args = static_bucket(rng, 7, 256, 32, 3)
    assert_close_to_max(extract_fused.extract_static(*args),
                        extract_fused.extract_static_plain(*args))
    powers, state, delta = powact_inputs(rng, 40, 5)
    got = powact.powact_flags(powers, state, delta, r=4, thresh=10.0)
    ref = powact.powact_flags_plain(powers, state, delta, r=4, thresh=10.0)
    assert_tree_equal(got, ref, "powact")
    assert before == (extract_fused.extract_static.launches,
                      powact.powact_flags.launches)


def test_cpu_tensors_take_the_plain_version_fold(monkeypatch):
    """Kernel A's phase fold: CPU tensors compute the plain version (the
    GEMM, then exact quarter turns), launch nothing and count nothing; an
    R that is no quarter-turn pattern is refused."""
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("launched"))
    rng = np.random.default_rng(12)
    spec, starts, mat = bucket(rng, 12, 256, 16, 8)
    before = extract_fused.extract_shared_fold.launches
    for r in (1, 2, 4):
        got = extract_fused.extract_shared_fold(spec, starts, mat, r)
        ref = extract_fused.fold_quarter_turns(
            extract_fused.extract_shared_plain(spec, starts, mat), starts, r)
        assert torch.equal(got, ref)
    assert extract_fused.extract_shared_fold.launches == before
    with pytest.raises(ValueError):
        extract_fused.extract_shared_fold(spec, starts, mat, 8)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: a missing CUDA compiler is an error."""
    monkeypatch.setattr(kernels, "_BUILD", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels._build()


def test_build_compiles_each_source_and_links_one_library(monkeypatch,
                                                          tmp_path):
    """One compiler process per source, then one link into the library
    (a stand-in nvcc records its calls and writes its -o file)."""
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {calls}\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo built > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "_BUILD", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    out = kernels._build()
    lines = calls.read_text().splitlines()
    sources = sorted(p.name for p in kernels._CSRC.glob("*.cu"))
    compiles = [ln for ln in lines if " -c " in ln]
    assert sorted(ln.split()[-1].rsplit("/", 1)[-1] for ln in compiles) == (
        sources)
    assert len(lines) == len(sources) + 1 and "-shared" in lines[-1]
    assert out.read_text() == "built\n"
    assert list(out.parent.iterdir()) == [out]  # no objects left behind
    assert kernels._build() == out  # cached: no second build
    assert len(calls.read_text().splitlines()) == len(lines)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(13, 512, 64, 5, 128), (9, 1024, 128, 1, 0),
                                   (512, 4096, 64, 64, 128)])
def test_extract_shared_kernel_matches_plain(shape):
    dev = cuda_device()
    rows, n, l, c, cm = shape
    rng = np.random.default_rng(1)
    args = to(bucket(rng, rows, n, l, c), dev)
    if cm:
        args += (torch.from_numpy(
            (rng.random((n, cm)) < 0.05).astype(np.float32)).to(dev),)
    before = extract_fused.extract_shared.launches
    got = extract_fused.extract_shared(*args)
    ref = extract_fused.extract_shared_plain(*args)
    assert extract_fused.extract_shared.launches == before + 1
    if cm:
        assert_close_to_max(got[0].cpu(), ref[0].cpu())
        np.testing.assert_allclose(got[1].cpu(), ref[1].cpu(), rtol=PRTOL)
    else:
        assert_close_to_max(got.cpu(), ref.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("shape", [(36, 1024, 64, 8), (512, 4096, 256, 16)],
                         ids=["small", "cfg2"])
def test_extract_shared_fold_kernel_matches_plain(r, shape):
    """The fold against its plain version, and exactly against the
    unfolded kernel A rotated by the same quarter turns (the epilogue only
    swaps and negates)."""
    dev = cuda_device()
    rows, n, l, c = shape
    rng = np.random.default_rng(13)
    spec, _, mat = bucket(rng, rows, n, l, c)
    # starts covering every residue mod 4
    starts = torch.from_numpy((np.sort(rng.choice((n - l) // 4, c,
                                                  replace=False)) * 4
                               + np.arange(c) % 4).astype(np.int32))
    args = to((spec, starts, mat), dev)
    before = extract_fused.extract_shared_fold.launches
    got = extract_fused.extract_shared_fold(*args, r)
    assert extract_fused.extract_shared_fold.launches == before + 1
    assert_close_to_max(got.cpu(),
                        extract_fused.extract_shared_fold_plain(*args,
                                                                r).cpu())
    unfolded = extract_fused.extract_shared(*args)
    assert torch.equal(got, extract_fused.fold_quarter_turns(unfolded,
                                                             args[1], r))


def band_masks(n, used, cols=128, seed=0):
    """[n, cols] 0/1 measure masks as the channelizer builds them: ``used``
    leading columns, each a contiguous band of bins, then zero padding."""
    rng = np.random.default_rng(seed)
    m = np.zeros((n, cols), np.float32)
    for c in range(used):
        lo = int(rng.integers(n // 8, n - n // 8))
        m[lo:lo + int(rng.integers(4, 40)), c] = 1.0
    return torch.from_numpy(m)


# (rows, N, l, C, odd starts, mask columns in use of 128, the masks'
# extent passed): 2k = 1.5 l
EDGE_CASES = {
    "odd-starts": (37, 1024, 64, 6, True, 0, False),
    "rows513-nout96": (513, 4096, 64, 3, True, 0, False),
    "rows513-nout192": (513, 4096, 128, 5, False, 0, False),
    "example-C1-K2048": (512, 4096, 1024, 1, False, 54, True),
    "masks-34-of-128": (512, 4096, 64, 64, True, 34, True),
    "masks-34-of-128-whole": (512, 4096, 64, 64, True, 34, False),
}


def edge_bucket(rows, n, l, c, odd, seed):
    rng = np.random.default_rng(seed)
    spec, _, mat = bucket(rng, rows, n, l, c)
    starts = np.sort(rng.choice((n - l) // 2, c, replace=False)) * 2
    starts = starts + 1 if odd else starts
    return spec, torch.from_numpy(starts.astype(np.int32)), mat


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_extract_shared_kernel_edge_cases(case):
    """Kernel A on odd starts (8-byte copies), rows and nout that are no
    multiple of its tiles, the example's C = 1, K = 2048 bucket (a k
    split), and masks with only some columns in use, with their extent
    (the channelizer's route) and without it (the whole masks): the
    padding columns come back exactly 0."""
    dev = cuda_device()
    rows, n, l, c, odd, used, ext = EDGE_CASES[case]
    args = to(edge_bucket(rows, n, l, c, odd, 21), dev)
    kw = {}
    if used:
        masks = band_masks(n, used)
        args += (masks.to(dev),)
        if ext:
            kw["extent"] = extract_fused.mask_extent(masks)
    before = extract_fused.extract_shared.launches
    got = extract_fused.extract_shared(*args, **kw)
    ref = extract_fused.extract_shared_plain(*args)
    assert extract_fused.extract_shared.launches == before + 1
    if used:
        assert_close_to_max(got[0].cpu(), ref[0].cpu())
        np.testing.assert_allclose(got[1].cpu(), ref[1].cpu(), rtol=PRTOL)
        assert not got[1][:, used:].any()
    else:
        assert_close_to_max(got.cpu(), ref.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("case", ["odd-starts", "rows513-nout96",
                                  "rows513-nout192", "example-C1-K2048"])
def test_extract_shared_fold_kernel_edge_cases(case, r):
    """The fold's epilogue on the same edge cases, against its plain
    version and exactly against the unfolded kernel A rotated."""
    dev = cuda_device()
    rows, n, l, c, odd, _, _ = EDGE_CASES[case]
    args = to(edge_bucket(rows, n, l, c, odd, 22), dev)
    got = extract_fused.extract_shared_fold(*args, r)
    assert_close_to_max(got.cpu(),
                        extract_fused.extract_shared_fold_plain(*args,
                                                                r).cpu())
    unfolded = extract_fused.extract_shared(*args)
    assert torch.equal(got, extract_fused.fold_quarter_turns(unfolded,
                                                             args[1], r))


@pytest.mark.cuda
@pytest.mark.parametrize("c, same", [(16, True), (5, True), (2, False)])
def test_extract_static_kernel_unchanged_by_the_fold(c, same):
    """Kernel E on per-channel copies of one matrix against kernel A
    unfolded: one GEMM body (gather_gemm.cuh), each output's k terms
    summed in order, one fmaf each, within each k range, and the ranges'
    partial sums added in order. Where static_plan and gemm_plan take the
    same k ranges (16 channels: none; 5: three) the two agree bit for
    bit, whatever their tiles (E's fourth row tile of a channel also
    computes its 513th row); where they differ (2 channels: eight ranges
    against seven) only the order of the sum does, so they agree at the
    plain version's tolerance."""
    dev = cuda_device()
    rng = np.random.default_rng(14)
    a_plan = extract_fused.gemm_plan(c * 513, 384, 512)
    e_plan = extract_fused.static_plan(c, 513, 512, 384)
    assert (a_plan[2:4] == e_plan[2:4]) == same
    spec, starts, mat = to(bucket(rng, 513, 4096, 256, c), dev)
    mats = mat[None].repeat(c, 1, 1).contiguous()
    e = extract_fused.extract_static(spec, starts, mats)
    a = extract_fused.extract_shared(spec, starts, mat)
    if same:
        assert torch.equal(e, a)
    else:
        assert_close_to_max(a.cpu(), e.cpu())


@pytest.mark.cuda
def test_greedy_accept_kernel_matches_plain():
    dev = cuda_device()
    rng = np.random.default_rng(2)
    cs = torch.from_numpy(rng.integers(0, 60, (300, 40)).astype(np.int32))
    ce = cs + torch.from_numpy(rng.integers(1, 12, cs.shape).astype(np.int32))
    hp = torch.from_numpy(rng.random(cs.shape) < 0.8)
    got = detect.greedy_accept_batch(cs.to(dev), ce.to(dev), hp.to(dev))
    np.testing.assert_array_equal(
        got.cpu(), detect.greedy_accept_batch_plain(cs, ce, hp))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PACK_EDGES))
def test_candidate_packs_kernel_edges(name):
    """Kernel B on each edge case, bit-equal to the plain version, one
    launch."""
    dev = cuda_device()
    args, kw, power = pack_edge(name, 64)
    sd = SegmentDetector(*args, **kw)
    ref = detect.candidate_packs_plain([torch.from_numpy(power)],
                                       [sd.pack_spec])[0]
    before = detect.candidate_packs.launches
    got = detect.candidate_packs([torch.from_numpy(power).to(dev)],
                                 [sd.pack_spec])[0]
    assert detect.candidate_packs.launches == before + 1
    assert_tree_equal(got, ref, name)


@pytest.mark.cuda
def test_candidate_packs_kernel_segments():
    """Several segments in one launch, their powers row-strided views of
    one wider matrix (as the channelizer's measures are), a vcm segment
    among them, 512 blocks: every pack bit-equal, one flat buffer at
    kernel C's offsets."""
    dev = cuda_device()
    rng = np.random.default_rng(12)
    sds = [SegmentDetector(0, 4096, 4, a, b, 6.0, 0.005, 0.2,
                           max_candidates=k, vcm=v)
           for a, b, k, v in [(0.05, 0.3, 32, False), (0.3, 0.55, 0, False),
                              (0.55, 0.95, 16, True)]]
    cells = [sd.geometry.n_cells for sd in sds]
    wide = np.concatenate([_busy(512, c, rng) for c in cells] + [
        np.ones((512, 5), np.float32)], 1)
    edges = np.concatenate([[0], np.cumsum(cells)])
    views = [torch.from_numpy(wide)[:, lo:hi]
             for lo, hi in zip(edges[:-1], edges[1:])]
    specs = [sd.pack_spec for sd in sds]
    ref = detect.candidate_packs_plain(views, specs)
    wide_d = torch.from_numpy(wide).to(dev)
    got = detect.candidate_packs(
        [wide_d[:, lo:hi] for lo, hi in zip(edges[:-1], edges[1:])], specs)
    assert_tree_equal(list(got), list(ref), "packs")
    offs, _ = detect.pack_offsets(512, [sd.k_pack for sd in sds])
    assert [p.storage_offset() for p in got] == offs


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [
    [((0.55, 0.8), 16, 0, 0.02)],                     # the flagship form
    [((0.05, 0.3), 16, 8, 0.02), ((0.3, 0.55), 40, 4, 0.02),  # 2 warps
     ((0.55, 0.8), 8, 0, 0.02)],
    [((0.1, 0.9), 24, 0, 0.001)],  # K = 409: 3-block staging chunks
], ids=["one-segment", "three-segments", "wide-segment"])
def test_slot_lifecycle_kernel_matches_plain(shapes):
    dev = cuda_device()
    rng = np.random.default_rng(3)
    packs, states, kw = lifecycle_inputs(rng, 100, shapes, 3)
    ref = lifecycle.slot_lifecycle_multi_plain(packs, states, **kw)
    got = lifecycle.slot_lifecycle_multi(to(packs, dev), to(states, dev),
                                         **to(kw, dev))
    assert_tree_equal(list(got[0]), list(ref[0]), "segments")
    assert_tree_equal(got[1], ref[1], "powact")


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [True, False],
                         ids=["compacted", "uncompacted"])
@pytest.mark.parametrize("k", [16, 32, 409])
@pytest.mark.parametrize("s", [16, 32, 128, 512, 1024])
def test_slot_lifecycle_kernel_schedule_shapes(s, k, compact):
    """Kernel C at every slots-per-lane instantiation (S = 16 ... 1024)
    and K = 16, 32, 409, on packs whose valid candidates sit at the front
    or anywhere (the kernel builds its lists from the valid column), 100
    blocks (several chunks), beside a second segment: flags, slot tables
    and counters exact."""
    dev = cuda_device()
    rng = np.random.default_rng(s * 1000 + k + compact)
    p1, st1 = synthetic_lifecycle(rng, s, k, 100, compact)
    p2, st2 = synthetic_lifecycle(rng, 16, 16, 100, True)
    packs = tuple(torch.from_numpy(p) for p in (p1, p2))
    states = tuple({key: torch.from_numpy(np.array(v))
                    for key, v in st.items()} for st in (st1, st2))
    kw = dict(n_cands=(k, 16), rs=(4, 3), delays=(1, 2))
    ref = lifecycle.slot_lifecycle_multi_plain(packs, states, **kw)
    before = lifecycle.slot_lifecycle_multi.launches
    got = lifecycle.slot_lifecycle_multi(to(packs, dev), to(states, dev),
                                         **kw)
    assert lifecycle.slot_lifecycle_multi.launches == before + 1
    assert_tree_equal(list(got), list(ref), "segments")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(13, 512, 64, 5), (513, 4096, 256, 2),
                                   (513, 4096, 512, 5)],
                         ids=["small", "example-w256", "example-w512"])
def test_extract_static_kernel_matches_plain(shape):
    dev = cuda_device()
    rng = np.random.default_rng(9)
    args = to(static_bucket(rng, *shape), dev)
    before = extract_fused.extract_static.launches
    got = extract_fused.extract_static(*args)
    ref = extract_fused.extract_static_plain(*args)
    assert extract_fused.extract_static.launches == before + 1
    assert_close_to_max(got.cpu(), ref.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("nb,c", [(512, 32), (37, 5), (1, 3)])
def test_powact_kernel_matches_plain(nb, c):
    dev = cuda_device()
    rng = np.random.default_rng(10)
    powers, state, delta = powact_inputs(rng, nb, c)
    ref = powact.powact_flags_plain(powers, state, delta, r=4, thresh=10.0)
    before = powact.powact_flags.launches
    got = powact.powact_flags(powers.to(dev), to(state, dev), delta.to(dev),
                              r=4, thresh=10.0)
    assert powact.powact_flags.launches == before + 1
    assert_tree_equal(got, ref, "powact")


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 2, 4, 8])
@pytest.mark.parametrize("nb", [1, 31, 33, 512, 1100])
def test_powact_kernel_scan_shapes(nb, r):
    """Kernel D's warp scan at runs of one block, lanes with no block,
    one to three super-chunks, and every R: flags and state exact."""
    dev = cuda_device()
    rng = np.random.default_rng(nb * 10 + r)
    powers, state, delta = powact_inputs(rng, nb, 7)
    state["phase"] = torch.from_numpy(rng.integers(0, r, 7).astype(np.int32))
    ref = powact.powact_flags_plain(powers, state, delta, r=r, thresh=10.0)
    got = powact.powact_flags(powers.to(dev), to(state, dev), delta.to(dev),
                              r=r, thresh=10.0)
    assert_tree_equal(got, ref, "powact")


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [3, 33, 1100])
def test_slot_lifecycle_kernel_burst_scan(nb):
    """Kernel C's burst flags through the same warp scan (its block's
    shared memory as the staging) beside a segment: exact."""
    dev = cuda_device()
    rng = np.random.default_rng(nb)
    packs, states, kw = lifecycle_inputs(rng, nb, [((0.55, 0.8), 16, 0,
                                                    0.02)], 9)
    kw["pa_r"] = 8
    ref = lifecycle.slot_lifecycle_multi_plain(packs, states, **kw)
    got = lifecycle.slot_lifecycle_multi(to(packs, dev), to(states, dev),
                                         **to(kw, dev))
    assert_tree_equal(list(got[0]), list(ref[0]), "segments")
    assert_tree_equal(got[1], ref[1], "powact")


@pytest.mark.cuda
def test_wrappers_refuse_bad_cuda_inputs():
    dev = cuda_device()
    rng = np.random.default_rng(4)
    spec, starts, mat = to(bucket(rng, 5, 256, 16, 3), dev)
    with pytest.raises(TypeError):
        extract_fused.extract_shared(spec, starts.long(), mat)
    with pytest.raises(TypeError):
        extract_fused.extract_shared_fold(spec, starts.long(), mat, 4)
    with pytest.raises(TypeError):
        detect.greedy_accept_batch(starts[None].long(), starts[None].long(),
                                   starts[None] > 0)
    spec, starts, mats = to(static_bucket(rng, 5, 256, 16, 3), dev)
    with pytest.raises(TypeError):
        extract_fused.extract_static(spec, starts, mats.double())
    with pytest.raises(ValueError):  # outside the acceptance's bitmap
        detect.greedy_accept_batch(starts[None] + 4000, starts[None] + 4010,
                                   starts[None] >= 0)
    args, kw, power = pack_edge("touching", 4)
    spec = SegmentDetector(*args, **kw).pack_spec
    p = torch.from_numpy(power).to(dev)
    with pytest.raises(TypeError):
        detect.candidate_packs([p.double()], [spec])
    with pytest.raises(ValueError):  # more cells than the kernel takes
        detect.candidate_packs([torch.ones(4, 2049, device=dev)], [spec])
    with pytest.raises(ValueError):  # a column stride
        detect.candidate_packs([p[:, ::2]], [spec])
    powers, state, delta = to(powact_inputs(rng, 8, 3), dev)
    with pytest.raises(TypeError):
        powact.powact_flags(powers, {**state, "active": state["phase"]},
                            delta, r=4, thresh=10.0)
