"""Kernel B's schedule (``csrc/candidate_packs.cu``), on the CPU.

A CUDA kernel cannot run here, so :func:`pack_model` repeats the
kernel's schedule for one segment in numpy, a block's row as one warp
makes it: the ratios 32 positions a step (IEEE fp32 divisions, FLT_MIN
for a zero denominator with ``zero_floor``) with their rise keys in a
list and the fall masks a chunk, the suffix minima of the chunks' first
falls by a shuffle-down warp scan 32 chunks a step from the last, the
rank of each rise as the count of smaller keys (the ratio's bits
inverted, then the index), the pairing with the first fall at or after
it, the acceptance against a bitmap of occupied cells (two words a lane,
a cell range test and a vote a step), the compaction in acceptance
order and the geometry a column in fp32. It is held exactly against the
plain version (``candidate_packs_plain``) and the JAX package's
``SegmentDetector._packed_candidates`` on busy powers and on kernel B's
edge cases (``test_torch_kernels.PACK_EDGES``: every position a rise,
ties of equal and infinite ratios, 0/0 with and without ``zero_floor``,
K below the ratio count, touching intervals, empty blocks, a negative
ext_start, and n_cells at the kernel's limit of 2048). The flat buffer's
offsets are checked against kernel C's segment table, and the whole
flagship and a four-part split channelizer on the CPU against JAX with
every step's packs passed to kernel C's wrapper as views of one buffer.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.models.segment_detection import SegmentDetector as JaxSD
from fdc_tpu.utils.cplx import c2f_host
from fdc_tpu_torch import FrequencyDomainChannelizer
from fdc_tpu_torch.flagship import _flagship, cfg5s_burst_hunter_split4
from fdc_tpu_torch.models.segment_detection import SegmentDetector
from fdc_tpu_torch.ops import detect, lifecycle

from test_torch_kernels import PACK_EDGES, pack_edge
from test_torch_slice import SMALL, assert_outputs_match, capture
from test_torch_split import jax_cfg

LANES = 32
FULL = 0xFFFFFFFF
NO_FALL = 0x7FFFFFFF
FLT_MIN = np.float32(1.1754944e-38)


def range_bits(w, lo, hi):
    """The bits of bitmap word w in cells [lo, hi]."""
    a, b = max(lo - 32 * w, 0), min(hi - 32 * w, 31)
    return 0 if a > b else (FULL >> (31 - b)) & (FULL << a) & FULL


def accept_chain(cand):
    """The acceptance over (start, end or -1) in order: the indices
    accepted, each blocked iff an occupied cell lies in [start, end]."""
    occ = [[0, 0] for _ in range(LANES)]  # lane l: words l and l + 32
    out = []
    for j, (s, e) in enumerate(cand):
        if e < 0:
            continue
        if any((range_bits(l, s, e) & occ[l][0])
               | (range_bits(l + 32, s, e) & occ[l][1])
               for l in range(LANES)):
            continue
        for l in range(LANES):
            occ[l][0] |= range_bits(l, s, e - 1)
            occ[l][1] |= range_bits(l + 32, s, e - 1)
        out.append(j)
    return out


def suffix_minima(fallm):
    """suf[c]: the first fall at or after cell 32 c, by the kernel's warp
    scan (shuffle-down inclusive minima of 32 chunks a step, from the
    last group, carrying lane 0's)."""
    nch = len(fallm)
    suf = [NO_FALL] * nch
    carry = NO_FALL
    for c0 in range((nch - 1) & ~31, -1, -32):
        v = []
        for lane in range(LANES):
            c = c0 + lane
            m = fallm[c] if c < nch else 0
            v.append(32 * c + (m & -m).bit_length() - 1 if m else NO_FALL)
        off = 1
        while off < LANES:
            v = [min(v[l], v[l + off]) if l + off < LANES else v[l]
                 for l in range(LANES)]
            off *= 2
        v = [min(x, carry) for x in v]
        for lane in range(LANES):
            if c0 + lane < nch:
                suf[c0 + lane] = v[lane]
        carry = v[0]
    return suf


@np.errstate(divide="ignore", invalid="ignore", over="ignore")
def pack_model(power, spec):
    """[B, n_cells] float32 powers -> the [B, 7K] int32 pack, as a warp of
    kernel B makes each row."""
    p = np.asarray(power, np.float32)
    nb, n_cells = p.shape
    n_r = n_cells - 1
    nch = -(-n_r // 32)
    thr = np.float32(spec.thresh)
    inv = np.float32(1.0 / spec.thresh)
    grow = np.float32(1.0 + 2.0 * spec.puffer)
    kp = spec.k_pack
    k_eff = min(spec.k_detect, n_r)
    out = np.zeros((nb, 7, kp), np.int64)
    for b in range(nb):
        # 1. ratios 32 positions a step
        den = p[b, :-1].copy()
        if spec.zero_floor:
            den[den == 0] = FLT_MIN
        ratio = p[b, 1:] / den
        pad = np.full(nch * 32 - n_r, np.float32(1.0))
        ratio = np.concatenate([ratio, pad]).reshape(nch, 32)
        valid = (np.arange(nch * 32) < n_r).reshape(nch, 32)
        rise = valid & (ratio > thr)
        fall = valid & (ratio < inv)
        fallm = [int(sum(1 << l for l in np.flatnonzero(f))) for f in fall]
        idx = np.flatnonzero(rise.ravel())
        bits = ratio.ravel()[idx].view(np.uint32).astype(np.uint64)
        keys = ((~bits & np.uint64(FULL)) << np.uint64(32)) | idx.astype(
            np.uint64)
        # 2. suffix minima, 3. ranks and pairing
        suf = suffix_minima(fallm)
        rank = np.searchsorted(np.sort(keys), keys)  # smaller keys
        cand = [None] * min(len(keys), k_eff)
        for key, r in zip(keys, rank):
            if r < k_eff:
                i = int(key & np.uint64(FULL))
                c = i >> 5
                m = fallm[c] & (FULL << (i & 31)) & FULL
                nf = (32 * c + (m & -m).bit_length() - 1 if m
                      else (suf[c + 1] if c + 1 < nch else NO_FALL))
                cand[r] = (i, nf + 1 if nf < n_r else -1)
        # 4. acceptance, 5. the row
        acc = [cand[j] for j in accept_chain(cand)]
        for j in range(kp):
            v = j < len(acc)
            s, e = acc[j] if v else (0, 0)
            cs = s * spec.decimation + spec.start
            ce = e * spec.decimation + spec.start
            det_w = ce - cs
            ext_raw = int(np.ceil(np.float32(det_w) * grow))
            wl2 = min((max(ext_raw, 1) - 1).bit_length(),
                      spec.w_cap_log2 + 2)
            ext_w = 1 << wl2
            mid = cs + det_w // 2
            es, ee = mid - ext_w // 2, mid + ext_w // 2
            if es < 0:
                es, ee = 0, ext_w
            if ee > spec.n:
                es = spec.n - ext_w
            out[b, :, j] = (cs, ce, v, wl2, es, es % spec.r,
                            ext_w > spec.w_cap)
    return out.reshape(nb, 7 * kp).astype(np.int32)


def hold(args, kw, power):
    """The model == the plain version == fdc_tpu's pack, exactly."""
    sd = SegmentDetector(*args, **kw)
    got = pack_model(power, sd.pack_spec)
    plain = detect.candidate_packs_plain([torch.from_numpy(power)],
                                         [sd.pack_spec])[0]
    np.testing.assert_array_equal(got, plain.numpy())
    ref, k = JaxSD(*args, lifecycle_backend="scan", **kw)._packed_candidates(
        jnp.asarray(power))
    assert k == sd.k_pack
    np.testing.assert_array_equal(got, np.asarray(ref))
    return got, sd.k_pack


def busy_power(nc, rng, nb=24):
    """Carriers moving between blocks, a zero stretch (infinite ratios
    next to it) and duplicated values (ratio ties)."""
    p = np.full((nb, nc), 1e-6)
    for _ in range(6):
        c = rng.integers(2, nc - 8)
        on = rng.integers(0, nb - 2)
        p[on:rng.integers(on + 1, nb), c:c + rng.integers(1, 6)] += (
            rng.random() * 2.0)
    p += rng.random((nb, nc)) * 2e-6
    p[nb // 3, : nc // 4] = 0.0
    p[nb // 2, 1::7] = p[nb // 2, 0]
    return p.astype(np.float32)


@pytest.mark.parametrize("case", [
    "exact-0", "exact-1", "exact-2", "K8-0", "K8-1", "vcm-0", "vcm-1",
])
def test_pack_model_matches_plain_and_jax(case):
    mode, seed = case.split("-")
    rng = np.random.default_rng(int(seed))
    args = (0, 1024, 4, 0.55, 0.8, 6.0, 0.02, 0.2)
    kw = dict(max_candidates=8 if mode == "K8" else 0,
              max_extract_width=256, vcm=mode == "vcm")
    nc = SegmentDetector(*args, **kw).geometry.n_cells
    got, k = hold(args, kw, busy_power(nc, rng))
    assert (got[:, 2 * k:3 * k] != 0).any()


@pytest.mark.parametrize("name", list(PACK_EDGES))
def test_pack_model_edges(name):
    """Every edge case: the model == plain == fdc_tpu, and the case shows
    what it is for."""
    args, kw, power = pack_edge(name, 6 if name == "max-cells" else 8)
    got, k = hold(args, kw, power)
    nv = (got[:, 2 * k:3 * k] != 0).sum(1)
    if name.startswith("all-rises") or name == "empty":
        assert (nv == 0).all()
    elif name == "alternating":
        assert (nv == k).all()  # every touching pair accepted: a full pack
    elif name == "touching":
        assert (nv == 2).all()  # the right neighbour in, the left one out
    elif name == "negative-es":
        assert (got[:, 4 * k:5 * k] < 0).any()
        assert (got[:, 6 * k:] != 0).any()  # too big
    else:
        assert (nv > 0).all()


def test_zero_floor_turns_0_over_0_into_a_fall():
    """0/0 is NaN (no edge) without zero_floor, a fall with it: the two
    packs differ on the zeros case."""
    args, kw, power = pack_edge("zeros", 8)
    a, _ = hold(args, kw, power)
    b, _ = hold(args, {**kw, "vcm": True}, power)
    assert not np.array_equal(a, b)


def test_truncation_drops_rises_ranked_past_k():
    """With K = 4 under 12 carriers a block only the 4 strongest rises
    count: the exact-mode pack accepts more."""
    args, kw, power = pack_edge("truncation-K4", 8)
    got, k = hold(args, kw, power)
    full, kf = hold(args, {**kw, "max_candidates": 0}, power)
    assert ((full[:, 2 * kf:3 * kf] != 0).sum(1)
            > (got[:, 2 * k:3 * k] != 0).sum(1)).all()


def test_pack_offsets_match_kernel_c_table():
    """candidate_packs' views sit in one flat buffer at kernel C's pack
    offsets (``lifecycle.seg_table``), which its wrapper then reads in
    place; separate packs are concatenated into the same layout."""
    rng = np.random.default_rng(5)
    sds = [SegmentDetector(0, 1024, 4, a, b, 6.0, 0.02, 0.2,
                           max_candidates=k, max_slots=s)
           for (a, b), k, s in [((0.05, 0.3), 8, 16), ((0.3, 0.55), 0, 40),
                                ((0.55, 0.8), 4, 8)]]
    nb = 12
    powers = [torch.from_numpy(busy_power(sd.geometry.n_cells, rng, nb))
              for sd in sds]
    packs = detect.candidate_packs(powers, [sd.pack_spec for sd in sds])
    n_cands = [sd.k_pack for sd in sds]
    tab = lifecycle.seg_table(nb, n_cands, [4] * 3, [1] * 3,
                              [sd.max_slots for sd in sds])[0]
    offs, total = detect.pack_offsets(nb, n_cands)
    assert list(tab[:, 4]) == offs
    base = packs[0].storage_offset()
    assert [p.storage_offset() - base for p in packs] == offs
    flat = lifecycle._flat_packs(packs, tab)
    assert flat is packs[0] and packs[-1].untyped_storage().nbytes() == (
        4 * total)
    separate = [p.clone() for p in packs]
    cat = lifecycle._flat_packs(separate, tab)
    assert cat.shape == (total,)
    for p, o, sd, pw in zip(packs, offs, sds, powers):
        np.testing.assert_array_equal(
            cat[o:o + p.numel()].numpy(), p.reshape(-1).numpy())
        np.testing.assert_array_equal(p.numpy(),
                                      sd._packed_candidates(pw).numpy())


def flat_spy(monkeypatch, seen):
    """Wrap kernel C's wrapper: record whether each call's packs are views
    of one buffer at its table's offsets (what the card reads in place)."""
    orig = lifecycle.slot_lifecycle_multi

    def spy(packs, states, **kw):
        nb = packs[0].shape[0]
        tab = lifecycle.seg_table(
            nb, kw["n_cands"], kw["rs"], kw["delays"],
            [st["active"].numel() for st in states])[0]
        seen.append(lifecycle._flat_packs(packs, tab) is packs[0])
        return orig(packs, states, **kw)

    monkeypatch.setattr(lifecycle, "slot_lifecycle_multi", spy)


@pytest.mark.parametrize("name", ["flagship", "split4"])
def test_channelizer_packs_flat_and_matching_jax(name, monkeypatch):
    """The flagship and config 5 split into four parts, small, on the CPU:
    step outputs equal to fdc_tpu's over three steps, every step's packs
    one flat buffer at kernel C's offsets (the split parts' recompacted
    packs copied back into it)."""
    if name == "flagship":
        cfg = _flagship(**SMALL)
    else:
        cfg = cfg5s_burst_hunter_split4(blocksize=1024, batch_blocks=8,
                                        minchandist=0.02)
    tf = FrequencyDomainChannelizer(cfg, device="cpu")
    jf = JaxFDC(jax_cfg(cfg))
    x = capture(cfg, n_batches=3, tail=0, seed=4)
    if name == "split4":
        # carriers over the cuts: kills and suppressed candidates
        n, t = cfg.blocksize, np.arange(len(x))
        for sd in tf.segments[:-1]:
            f = sd.core_bins[1] / n - 0.5
            x = x + (0.3 * np.exp(2j * np.pi * f * t)).astype(np.complex64)
    seen = []
    flat_spy(monkeypatch, seen)
    bs, bb = tf.batch_samples, cfg.batch_blocks
    jc, tc = jf._jit_init(), tf._device_init()
    active = 0
    for step in range(3):
        chunk = x[step * bs:(step + 1) * bs]
        jc, jo = jf._jit_step(jc, jnp.asarray(c2f_host(chunk)),
                              jnp.int32(step * bb))
        tc, to = tf._device_step(tc, torch.from_numpy(chunk), step * bb)
        assert_outputs_match(to, jo, f"{name} step {step}")
        active += sum(int(np.asarray(jo[f"seg{i}"]["activated"]).sum())
                      for i in range(len(tf.segments)))
    assert seen == [True] * 3
    assert active >= 1
