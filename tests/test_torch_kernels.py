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


@pytest.mark.cuda
def test_extract_static_kernel_unchanged_by_the_fold():
    """Kernel E (tile_gemm MODE 2, no fold) on per-channel copies of one
    matrix equals kernel A unfolded (MODE 0) bit for bit: same tiles,
    same accumulation order."""
    dev = cuda_device()
    rng = np.random.default_rng(14)
    spec, starts, mat = to(bucket(rng, 513, 4096, 256, 5), dev)
    mats = mat[None].repeat(5, 1, 1).contiguous()
    assert torch.equal(extract_fused.extract_static(spec, starts, mats),
                       extract_fused.extract_shared(spec, starts, mat))


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
    powers, state, delta = to(powact_inputs(rng, 8, 3), dev)
    with pytest.raises(TypeError):
        powact.powact_flags(powers, {**state, "active": state["phase"]},
                            delta, r=4, thresh=10.0)
