"""Kernel C's schedule (``csrc/lifecycle.cu``), on the CPU.

A CUDA kernel cannot run here, so :func:`chain_model` repeats the
kernel's schedule in numpy: per block the list of valid candidates built
from the valid column itself (k order, whatever the pack's compaction),
the slots spread over 32 lanes (slot ``i * 32 + lane`` in register i of
its lane, ``slots_per_lane`` registers, a power of two), each candidate's
match as the kernel makes it (where one slot of the warp overlaps, that
slot; else two warp reductions: the minimum sign-flipped order
over the lanes' earliest live overlapping slots, then the minimum slot
among the lanes holding it), and the free slots' ranks as the
ballot prefix counts of the registers before them plus the lanes before
them. It is held exactly against the plain version
(``slot_lifecycle_multi_plain``) at S in {16, 32, 128, 512, 1024} and K
in {16, 32, 409} on compacted and uncompacted packs, counters included,
and against the JAX package's ``scan_slots`` on real candidate packs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fdc_tpu.models.segment_detection import SegmentDetector as JaxSD
from fdc_tpu_torch.models.segment_detection import SegmentDetector
from fdc_tpu_torch.ops import lifecycle

from test_torch_kernels import synthetic_lifecycle as synthetic_inputs

LANES = 32
NONE = 0xFFFFFFFF


def slots_per_lane(s):
    spl = 1
    while LANES * spl < s:
        spl *= 2
    return spl


def candidate_lists(row, k):
    """One block's [7K] pack row -> [nv, 6] (start, end, wlog2,
    ext_start, ext_start % R, too_big) of its valid candidates in k
    order (what the helper warps build)."""
    idx = np.flatnonzero(row[2 * k:3 * k] != 0)
    return np.stack([row[f * k + idx] for f in (0, 1, 3, 4, 5, 6)], 1)


def chain_model(pack, state, k, r, delay):
    """One segment's lifecycle over the blocks of ``pack`` [B, 7K], as
    warp 0 of kernel C walks it. Returns (new_state, (got, processed,
    emit, phase_used)) like the plain version, as numpy arrays."""
    pack = np.asarray(pack)
    s = len(state["active"])
    spl = slots_per_lane(s)
    lane = np.arange(LANES)[None, :]
    slot = np.arange(spl)[:, None] * LANES + lane  # [spl, 32]

    def regs(key, dtype):
        out = np.zeros(spl * LANES, dtype)
        out[:s] = np.asarray(state[key])
        return out.reshape(spl, LANES)

    mine = slot < s
    a, t = regs("active", bool), regs("tomb", bool)
    ds, de = regs("det_start", np.int64), regs("det_stop", np.int64)
    xs, wl = regs("ext_start", np.int64), regs("wlog2", np.int64)
    ph, pi = regs("phase", np.int64), regs("phase_inc", np.int64)
    ina, order = regs("inactive", np.int64), regs("order", np.int64)
    alloc = int(state["alloc_counter"])
    dropped = int(state["dropped"])
    flags = []
    for row in pack:
        cands = candidate_lists(row, k)
        live = a & ~t & mine
        ref = np.zeros_like(live)
        new, n_big = [], 0
        for cand in cands:
            cs, ce, big = cand[0], cand[1], cand[5]
            hit = live & (cs < de) & (ce >= ds)
            key = np.where(hit, (order & 0xFFFFFFFF) ^ 0x80000000, NONE)
            best = key.min(0)      # each lane: its earliest order ...
            bi = key.argmin(0)     # ... at its lowest register
            has = hit.any(0)
            if hit.sum() == 1:  # one slot in the warp overlaps
                ref |= hit
            elif has.any():
                m = best[has].min()  # reduction 1: the earliest order
                at = has & (best == m)
                # reduction 2: the lowest slot holding it
                win = np.where(at, bi * LANES + lane[0], NONE).min()
                ref[win // LANES, win % LANES] = True
            elif big:
                n_big += 1
            else:
                new.append(cand)
        ina = np.where(live, np.where(ref, 0, ina + 1), ina)
        free = ~a & ~t & mine
        got = np.zeros_like(free)
        n_free = 0
        for i in range(spl):
            if n_free >= len(new):
                break
            ball = free[i]
            rank = n_free + np.cumsum(ball) - ball  # lanes before, set
            for ln in np.flatnonzero(ball & (rank < len(new))):
                cs, ce, w2, es, esr, _ = new[rank[ln]]
                got[i, ln] = True
                ds[i, ln], de[i, ln] = cs, ce
                wl[i, ln], xs[i, ln], pi[i, ln] = w2, es, esr
                ina[i, ln] = 0
                order[i, ln] = alloc + rank[ln]
            n_free += int(ball.sum())
        n_alloc = min(len(new), n_free)
        dropped += len(new) - n_alloc + n_big
        alloc += n_alloc
        a = a | got
        live2 = a & ~t
        emit = live2 & ~got & (ina > delay)
        t = t | emit
        proc = live2 & ~emit
        pused = np.where(got, pi, ph)
        ph = np.where(got, (2 * pi) % r, np.where(proc, (ph + pi) % r, ph))
        flags.append(tuple(f.reshape(-1)[:s]
                           for f in (got, proc, emit, pused)))
    a = a & ~t
    flat = {
        "active": a, "tomb": np.zeros_like(t), "det_start": ds,
        "det_stop": de, "ext_start": xs, "wlog2": wl, "phase": ph,
        "phase_inc": pi, "inactive": ina, "order": order,
    }
    new_state = {key: (v.reshape(-1)[:s] if v.dtype == bool
                       else v.reshape(-1)[:s].astype(np.int32))
                 for key, v in flat.items()}
    new_state["alloc_counter"] = np.int32(alloc)
    new_state["dropped"] = np.int32(dropped)
    got, proc, emit, pused = (np.stack(f) for f in zip(*flags))
    return new_state, (got, proc, emit, pused.astype(np.int32))



def assert_same(got, ref, what):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), what
        for key in ref:
            assert_same(got[key], ref[key], f"{what}[{key}]")
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, f"{what}[{i}]")
    else:
        g, r = np.asarray(got), np.asarray(ref)
        assert g.dtype == r.dtype and g.shape == r.shape, what
        np.testing.assert_array_equal(g, r, err_msg=what)


def plain(pack, state, k, r, delay):
    (res,) = lifecycle.slot_lifecycle_multi_plain(
        (torch.from_numpy(pack),),
        ({key: torch.from_numpy(np.array(v)) for key, v in state.items()},),
        n_cands=(k,), rs=(r,), delays=(delay,))
    st, flags = res
    return ({key: v.numpy() for key, v in st.items()},
            tuple(f.numpy() for f in flags))


@pytest.mark.parametrize("compact", [True, False],
                         ids=["compacted", "uncompacted"])
@pytest.mark.parametrize("k", [16, 32, 409])
@pytest.mark.parametrize("s", [16, 32, 128, 512, 1024])
def test_chain_model_matches_plain(s, k, compact):
    """The kernel's schedule == the plain version: flags, slot tables and
    both counters exact, whether or not the valid candidates sit at the
    front of the pack."""
    rng = np.random.default_rng(s * 1000 + k + compact)
    pack, state = synthetic_inputs(rng, s, k, 24, compact)
    ref = plain(pack, state, k, 4, 1)
    got = chain_model(pack, state, k, 4, 1)
    assert_same(got, ref, f"S={s} K={k}")
    # the inputs exercise the matching, allocation and the counters
    assert ref[1][0].any() and ref[0]["alloc_counter"] > s
    if s == 16 and k == 409:
        assert ref[0]["dropped"] > 3


@pytest.mark.parametrize("r", [3, 8])
def test_chain_model_phase_modulo(r):
    """The phase bookkeeping's floor modulo, at a power-of-two R (the
    kernel's mask) and at another R (its integer modulo), with negative
    phases carried in."""
    rng = np.random.default_rng(r)
    pack, state = synthetic_inputs(rng, 64, 32, 24, False, r=r)
    assert_same(chain_model(pack, state, 32, r, 2),
                plain(pack, state, 32, r, 2), f"R={r}")


def jax_pair(band, max_slots, minchandist=0.02, delay=1):
    args = (0, 1024, 4, band[0], band[1], 6.0, minchandist, 0.2)
    kw = dict(channel_deactivation_delay=delay, max_slots=max_slots,
              max_candidates=0, max_extract_width=256)
    return (JaxSD(*args, lifecycle_backend="scan", **kw),
            SegmentDetector(*args, **kw))


@pytest.mark.parametrize("band, slots, minchandist", [
    ((0.55, 0.8), 16, 0.02),    # the flagship's segment
    ((0.05, 0.95), 128, 0.01),  # a wide segment, four registers a lane
    ((0.1, 0.9), 512, 0.001),   # K = 409, sixteen registers a lane
], ids=["S16", "S128", "S512-K409"])
def test_chain_model_matches_jax(band, slots, minchandist):
    """The kernel's schedule == the JAX package's scan_slots on the
    candidate packs of busy powers, from a slot table the previous step
    left (its first half live)."""
    rng = np.random.default_rng(slots)
    jsd, sd = jax_pair(band, slots, minchandist)
    nb, nc = 24, sd.geometry.n_cells
    p = np.full((nb, nc), 1e-6) + rng.random((nb, nc)) * 2e-6
    for _ in range(12):
        c0 = rng.integers(2, nc - 8)
        on = rng.integers(0, nb - 2)
        p[on:rng.integers(on + 1, nb), c0:c0 + rng.integers(1, 6)] += 1.0
    pack = sd._packed_candidates(torch.from_numpy(p.astype(np.float32)))
    pack = pack.numpy()
    st = {key: v.numpy() for key, v in sd.init_state("cpu").items()}
    es = rng.integers(sd.geometry.start, sd.geometry.stop - 64, slots)
    st.update(active=np.arange(slots) < slots // 2,
              det_start=(es + 5).astype(np.int32),
              det_stop=(es + 25).astype(np.int32),
              ext_start=es.astype(np.int32),
              order=rng.permutation(slots).astype(np.int32),
              alloc_counter=np.int32(slots))
    k = sd.k_pack
    ref = jax.jit(lambda s_, p_: jsd.scan_slots(None, s_, packed=p_))(
        {key: jnp.asarray(v) for key, v in st.items()}, jnp.asarray(pack))
    got = chain_model(pack, st, k, sd.relinvovl, sd.deactivation_delay)
    assert_same(got, jax.tree_util.tree_map(np.asarray, ref), "scan_slots")
    assert got[1][0].any() and got[1][1].any()
