"""fdc_tpu_torch's detection (kernel B) and slot lifecycle (kernel C)
against fdc_tpu.

Kernel B's plain version is held against ``greedy_accept_batch`` in
Pallas interpret mode, kernel C's against ``slot_lifecycle_multi`` with
the ``pallas_interpret`` lifecycle backend (as
tests/test_lifecycle_pallas.py runs it) and against the plain lax.scan
path. Inputs come from numpy with a seed. Everything here is integer or
flag logic on shared inputs: exact. The CUDA kernels are held against
their plain versions in tests/test_torch_kernels.py. The last test
replays the reference's sequential SegmentDetection
(tests/golden.py:golden_segment_detection) against the port's whole
channelizer: event metadata exact, samples to 3e-4 as
tests/test_burst_paths.py holds the JAX package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fdc_tpu.models.power_activation import PowerActivationBank as JaxPA
from fdc_tpu.models.segment_detection import (
    SegmentDetector as JaxSD,
    scan_slots_multi as jax_scan_slots_multi,
)
from fdc_tpu.ops import detect as jx_detect
from fdc_tpu_torch import ChannelizerConfig, FrequencyDomainChannelizer
from fdc_tpu_torch.models.segment_detection import SegmentDetector
from fdc_tpu_torch.ops import detect, lifecycle

from golden import (
    golden_forward_fft,
    golden_overlap_save,
    golden_segment_detection,
)


def make_pair(band, max_slots=16, max_candidates=0, delay=1,
              backend="scan"):
    args = (0, 1024, 4, band[0], band[1], 6.0, 0.02, 0.2)
    kw = dict(channel_deactivation_delay=delay, max_slots=max_slots,
              max_candidates=max_candidates, max_extract_width=256)
    return (JaxSD(*args, lifecycle_backend=backend, **kw),
            SegmentDetector(*args, **kw))


def busy_power(nc, rng, nb=24, n_carriers=4):
    """Moving carriers (slots churn), a zero-power stretch (infinite
    ratios next to it) and duplicated values (strength ties)."""
    p = np.full((nb, nc), 1e-6)
    for _ in range(n_carriers):
        c = rng.integers(2, nc - 8)
        w = rng.integers(1, 6)
        on = rng.integers(0, nb - 2)
        off = rng.integers(on + 1, nb)
        p[on:off, c:c + w] += rng.random() * 2.0
    p += rng.random((nb, nc)) * 2e-6
    p[nb // 3, : nc // 4] = 0.0
    p[nb // 2, 1::7] = p[nb // 2, 0]
    return p.astype(np.float32)


def random_state(sd, rng, occupancy):
    s = sd.max_slots
    es = rng.integers(sd.geometry.start, sd.geometry.stop - 64, s)
    ds = es + 5
    return {
        "active": rng.random(s) < occupancy,
        "tomb": np.zeros(s, bool),
        "det_start": ds.astype(np.int32),
        "det_stop": (ds + rng.integers(5, 50, s)).astype(np.int32),
        "ext_start": es.astype(np.int32),
        "wlog2": rng.integers(2, sd.w_cap_log2 + 1, s).astype(np.int32),
        "phase": rng.integers(0, 4, s).astype(np.int32),
        "phase_inc": rng.integers(0, 4, s).astype(np.int32),
        "inactive": rng.integers(0, 3, s).astype(np.int32),
        # an order tie (two slots with one activation number) exercises
        # the match's lower-slot tie-break
        "order": np.minimum(np.arange(s), s - 2).astype(np.int32),
        "alloc_counter": np.int32(s),
        "dropped": np.int32(0),
    }


def random_pa(rng, c, nb):
    return (
        np.exp(rng.normal(0, 2.0, (nb, c))).astype(np.float32),
        {
            "active": rng.random(c) < 0.5,
            "lastpower": np.exp(rng.normal(0, 2.0, c)).astype(np.float32),
            "phase": rng.integers(0, 4, c).astype(np.int32),
        },
    )


def to_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def assert_tree_equal(got, ref, what):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), what
        for k in ref:
            assert_tree_equal(got[k], ref[k], f"{what}[{k}]")
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_tree_equal(g, r, f"{what}[{i}]")
    else:
        r = np.asarray(ref)
        g = got.numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, what
        np.testing.assert_array_equal(g, r, err_msg=what)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("max_candidates", [0, 8])
def test_detect_edges_matches_jax(seed, max_candidates):
    rng = np.random.default_rng(seed)
    _, sd = make_pair((0.55, 0.8), max_candidates=max_candidates)
    power = busy_power(sd.geometry.n_cells, rng)
    k = sd.k_detect
    ref = jax.vmap(lambda p: jx_detect.detect_edges(p, sd.thresh, k))(
        jnp.asarray(power))
    got = detect.detect_edges(torch.from_numpy(power), sd.thresh, k)
    assert_tree_equal(got, ref, "detect_edges")


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_accept_plain_matches_pallas(seed):
    """Kernel B's plain version == the Pallas kernel in interpret mode,
    on real candidate rows and on random overlapping intervals."""
    rng = np.random.default_rng(seed)
    _, sd = make_pair((0.55, 0.8))
    power = busy_power(sd.geometry.n_cells, rng, nb=40)
    cs, ce, hp = detect.detect_edges(torch.from_numpy(power), sd.thresh,
                                     sd.k_detect)
    s = rng.integers(0, 60, (40, 24)).astype(np.int32)
    rows = [
        (cs.numpy(), ce.numpy(), hp.numpy()),
        (s, s + rng.integers(1, 12, s.shape).astype(np.int32),
         rng.random(s.shape) < 0.8),
    ]
    for c_s, c_e, h in rows:
        ref = jx_detect.greedy_accept_batch(
            jnp.asarray(c_s), jnp.asarray(c_e), jnp.asarray(h),
            interpret=True)
        got = detect.greedy_accept_batch(
            torch.from_numpy(c_s), torch.from_numpy(c_e), torch.from_numpy(h))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("max_candidates", [0, 8])
def test_packed_candidates_match_jax(seed, max_candidates):
    """The [B, 7K] pack is fdc_tpu's exactly, and its geometry groups are
    candidate_geometry of its interval groups (what the plain scan path
    re-derives)."""
    rng = np.random.default_rng(seed)
    jsd, sd = make_pair((0.55, 0.8), max_candidates=max_candidates)
    power = busy_power(sd.geometry.n_cells, rng)
    ref, k = jsd._packed_candidates(jnp.asarray(power))
    got = sd._packed_candidates(torch.from_numpy(power))
    assert k == sd.k_pack
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    grp = got.reshape(got.shape[0], 7, k)
    wl2, es, big = detect.candidate_geometry(
        grp[:, 0], grp[:, 1], puffer=sd.flank_puffer, w_cap=sd.w_cap,
        w_cap_log2=sd.w_cap_log2, n=sd.blocksize)
    jw, je, jb = jx_detect.candidate_geometry(
        jnp.asarray(grp[:, 0].numpy()), jnp.asarray(grp[:, 1].numpy()),
        puffer=sd.flank_puffer, w_cap=sd.w_cap, w_cap_log2=sd.w_cap_log2,
        n=sd.blocksize)
    for g, j, pk in ((wl2, jw, grp[:, 3]), (es, je, grp[:, 4]),
                     (big.to(torch.int32), jb.astype(jnp.int32), grp[:, 6])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
        np.testing.assert_array_equal(pk.numpy(), g.numpy())
    np.testing.assert_array_equal(grp[:, 5].numpy(), es.numpy() % 4)


@pytest.mark.parametrize("seed", [0, 1])
def test_match_candidates_matches_jax(seed):
    rng = np.random.default_rng(seed)
    s, k = 12, 10
    cs = rng.integers(0, 200, k).astype(np.int32)
    args = (
        cs, cs + rng.integers(2, 30, k).astype(np.int32), rng.random(k) < 0.8,
        rng.random(s) < 0.7,
        rng.integers(0, 200, s).astype(np.int32),
        rng.integers(200, 260, s).astype(np.int32) - 50,
        rng.integers(0, 6, s).astype(np.int32),  # order ties
    )
    ref = jx_detect.match_candidates(*map(jnp.asarray, args))
    got = detect.match_candidates(*(torch.from_numpy(a) for a in args))
    assert_tree_equal(got, ref, "match_candidates")


def _lifecycle_inputs(seed, shapes, nb, with_pa, backend):
    rng = np.random.default_rng(seed)
    pairs = [make_pair(backend=backend, **sh) for sh in shapes]
    states = [random_state(sd, rng, 0.3) for _, sd in pairs]
    # the port's packs (== fdc_tpu's, test_packed_candidates_match_jax)
    packs = [
        sd._packed_candidates(torch.from_numpy(
            busy_power(sd.geometry.n_cells, rng, nb=nb))).numpy()
        for _, sd in pairs
    ]
    pa = None
    if with_pa:
        chans = [(0.2, 0.03), (0.45, 0.05)]
        pa = (JaxPA(1024, 4, chans, 10.0, backend),) + random_pa(rng, 2, nb)
    return pairs, states, packs, pa


def _port_lifecycle(pairs, states, packs, pa):
    sds = [sd for _, sd in pairs]
    kw = dict(n_cands=tuple(sd.k_pack for sd in sds),
              rs=tuple(sd.relinvovl for sd in sds),
              delays=tuple(sd.deactivation_delay for sd in sds))
    if pa is not None:
        bank, powers, st = pa
        kw.update(
            powact={"powers": torch.from_numpy(powers),
                    **to_torch(st),
                    "delta": torch.tensor([g.delta_phase
                                           for g in bank.geometry],
                                          dtype=torch.int32)},
            pa_r=bank.relinvovl, pa_thresh=bank.thresh,
        )
    return lifecycle.slot_lifecycle_multi(
        tuple(torch.from_numpy(p) for p in packs),
        tuple(to_torch(st) for st in states), **kw)


@pytest.mark.parametrize("with_pa", [False, True])
def test_lifecycle_plain_matches_pallas(with_pa):
    """Kernel C's plain version == slot_lifecycle_multi in Pallas
    interpret mode (the flagship shape: one segment, exact mode, with and
    without the burst chain)."""
    pairs, states, packs, pa = _lifecycle_inputs(
        0, [dict(band=(0.55, 0.8))], 24, with_pa, "pallas_interpret")
    kw = {}
    if pa is not None:
        bank, powers, st = pa
        kw["powact"] = (bank, jnp.asarray(powers), to_jax(st))
    ref = jax_scan_slots_multi(
        [jsd for jsd, _ in pairs], [None], [to_jax(s) for s in states],
        packed_list=[jnp.asarray(p) for p in packs], **kw)
    got = _port_lifecycle(pairs, states, packs, pa)
    if pa is None:
        assert_tree_equal(list(got), list(ref), "segments")
    else:
        assert_tree_equal(list(got[0]), list(ref[0]), "segments")
        assert_tree_equal(got[1], ref[1], "powact")


@pytest.mark.parametrize("seed", [0, 1])
def test_lifecycle_plain_matches_scan(seed):
    """Heterogeneous segments (slot counts, candidate caps, delays) plus
    the burst chain == per-segment lax.scan + scan_flags, which re-derive
    the candidate geometry the pack carries."""
    shapes = [
        dict(band=(0.05, 0.3), max_slots=16, max_candidates=8, delay=1),
        dict(band=(0.3, 0.55), max_slots=8, max_candidates=4, delay=0),
        dict(band=(0.55, 0.8), max_slots=32, max_candidates=0, delay=3),
    ]
    pairs, states, packs, pa = _lifecycle_inputs(seed, shapes, 48, True,
                                                 "scan")
    ref = [
        jax.jit(lambda st, p, sd=jsd: sd.scan_slots(None, st, packed=p))(
            to_jax(st), jnp.asarray(p))
        for (jsd, _), st, p in zip(pairs, states, packs)
    ]
    bank, powers, st = pa
    pa_ref = jax.jit(bank.scan_flags)(jnp.asarray(powers), to_jax(st))
    segs, pa_got = _port_lifecycle(pairs, states, packs, pa)
    assert_tree_equal(list(segs), ref, "segments")
    assert_tree_equal(pa_got, pa_ref, "powact")


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_plan_matches_jax(seed):
    rng = np.random.default_rng(seed)
    args = (0, 1024, 4, 0.55, 0.8, 6.0, 0.02, 0.2)
    kw = dict(max_slots=16, extract_budget=5, max_extract_width=256)
    jsd, sd = JaxSD(*args, **kw), SegmentDetector(*args, **kw)
    got_f = rng.random((24, 16)) < 0.02
    proc = rng.random((24, 16)) < 0.03
    ref = jsd.extract_plan(jnp.asarray(got_f), jnp.asarray(proc))
    got = sd.extract_plan(torch.from_numpy(got_f), torch.from_numpy(proc))
    assert_tree_equal(got, ref, "extract_plan")


def test_segment_detection_matches_golden():
    """tests/test_burst_paths.py::test_segment_detection_matches_golden's
    scene through the port: three carriers, one across a batch boundary,
    partial emissions every 6 blocks."""
    n, r, n_blocks = 1024, 4, 32
    inplen = n - n // r
    seg, mcd, thresh_db, puffer, maxblocks, delay = (
        (0.1, 0.9), 0.04, 8.0, 0.2, 6, 1)
    rng = np.random.default_rng(11)
    t = np.arange(n_blocks * inplen)
    x = 2e-3 * (rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)))
    for on, off, f, amp in ((4, 14, 0.30, 1.0), (8, 12, 0.60, 0.8),
                            (18, 26, 0.45, 0.9)):
        gate = np.zeros(len(t))
        gate[on * inplen:off * inplen] = 1.0
        x = x + amp * gate * np.exp(2j * np.pi * (f - 0.5) * t)
    x = x.astype(np.complex64)
    fdc = FrequencyDomainChannelizer(ChannelizerConfig(
        blocksize=n, relinvovl=r,
        activity_detection_segments=[(seg[0] - 0.5, seg[1] - 0.5)],
        act_det_threshold=thresh_db, minchandist=mcd,
        minchanflankpuffer=puffer, act_det_maxblocks=maxblocks,
        act_det_deactivation_delay=delay, batch_blocks=8), device="cpu")
    events = fdc.process(x).events
    blocks, _ = golden_overlap_save(x.astype(np.complex128), n, n // r)
    ref = golden_segment_detection(
        golden_forward_fft(blocks), n, r, seg[0], seg[1], thresh_db, mcd,
        puffer, maxblocks, delay)
    assert len(ref) >= 3 and len(events) == len(ref)
    for ev, g in zip(events, ref):
        assert (ev.finalized, ev.blockstart, ev.blockend, ev.vectorstart,
                ev.vectorend) == (g["finalized"], g["blockstart"],
                                  g["blockend"], g["vectorstart"],
                                  g["vectorend"])
        if g["part"] is not None:
            assert ev.part == g["part"]
        assert ev.ID.split(".")[1:3] == ["DETECTED", "0"]
        assert int(ev.ID.split(".")[-1]) == g["chan_id"]
        np.testing.assert_allclose(ev.rel_cfreq, g["rel_cfreq"], atol=1e-9)
        np.testing.assert_allclose(ev.rel_bw, g["rel_bw"], atol=1e-9)
        assert ev.data.shape == g["data"].shape
        np.testing.assert_allclose(ev.data, g["data"], atol=3e-4)
