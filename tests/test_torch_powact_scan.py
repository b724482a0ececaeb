"""Kernel D's warp scan (``csrc/powact_chain.cuh``), on the CPU.

A CUDA kernel cannot run here, so :func:`scan_model` repeats the
kernel's schedule in numpy: a super-chunk of up to 32 x 16 blocks at a
time, each of the 32 lanes composing the maps of its contiguous run of
ceil(n / 32) blocks (a block's map from its two ratio bits: from active
0, up ? (1, set 2 delta) : (0, keep); from active 1, (!dn, add delta)),
a Hillis-Steele inclusive scan of the lanes' maps with shuffle-up
semantics, each lane's entering state from the previous lane's, and the
replay of each run into the flags. It is held exactly against the plain
version (``powact_flags_plain``) at B in {1, 31, 33, 512, 1100} (runs of
one block, lanes with no blocks, two and three super-chunks) and R in
{1, 2, 4, 8}, against the JAX package's ``scan_flags`` on its Pallas
kernel in interpret mode and its lax.scan path (as
tests/test_torch_burst.py runs them), and the composition is checked for
associativity and against walking the blocks one by one on random maps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fdc_tpu.models.power_activation import PowerActivationBank as JaxBank
from fdc_tpu_torch.ops import powact

from test_torch_kernels import powact_inputs

LANES, LMAX = 32, 16
SC = LANES * LMAX
OUT, SET, ADD = 1 << 31, 1 << 30, 1 << 29
VAL = ADD - 1


def compose_op(e2, e1, rm):
    """op2 after op1 (the entry leads where op2 does)."""
    if e2 & SET:
        return e2
    if not e2 & ADD:
        return (e2 & OUT) | (e1 & ~OUT & 0xFFFFFFFF)
    if not e1 & (SET | ADD):
        return e2
    return (e2 & OUT) | (e1 & (SET | ADD)) | ((e1 + e2) & rm)


def compose(g, f, rm):
    """The map g after f, maps as (m0, m1)."""
    return tuple(compose_op(g[1] if e & OUT else g[0], e, rm) for e in f)


def block_map(up, dn, dm, d2):
    return (OUT | SET | d2 if up else 0, (0 if dn else OUT) | ADD | dm)


def apply(m, a, ph, rm):
    e = m[1] if a else m[0]
    v = e & VAL
    if e & SET:
        ph = v
    elif e & ADD:
        ph = (ph + v) & rm
    return bool(e & OUT), ph


IDENTITY = (0, OUT)


def step(a, ph, up, dn, d, rm):
    """One block walked directly (the plain version's body)."""
    rise = not a and up
    fall = a and dn
    proc = rise or a
    pused = d if rise else ph
    ph = (2 * d) & rm if rise else ((ph + d) & rm if proc else ph)
    return (rise or a) and not fall, ph, (rise, fall, proc, pused)


@np.errstate(over="ignore", divide="ignore")  # FLT_MAX / FLT_MIN = inf
def scan_model(powers, state, delta, r, thresh):
    """The kernel's schedule; (new_state, (rise, fall, processed,
    phase_used)) like the plain version, as numpy arrays [C, B]."""
    powers = np.asarray(powers, np.float32)
    nb, nc = powers.shape
    rm = r - 1
    thr = np.float32(thresh)
    flags = np.zeros((4, nc, nb), np.int64)
    act_out = np.zeros(nc, bool)
    ph_out = np.zeros(nc, np.int32)
    for c in range(nc):
        d = int(delta[c])
        dm, d2 = d & rm, (2 * d) & rm
        a, ph = bool(state["active"][c]), int(state["phase"][c])
        col = powers[:, c]
        for base in range(0, nb, SC):
            n = min(SC, nb - base)
            length = -(-n // LANES)
            runs, maps = [], []
            for lane in range(LANES):
                j0 = lane * length
                nl = max(0, min(length, n - j0))
                b0 = base + j0
                m, bits = IDENTITY, []
                if nl:
                    prev = (np.float32(state["lastpower"][c]) if b0 == 0
                            else col[b0 - 1])
                for t in range(nl):
                    p = col[b0 + t]
                    up = bool(p / prev >= thr)
                    dn = bool(prev / p >= thr)
                    bits.append((up, dn))
                    m = compose(block_map(up, dn, dm, d2), m, rm)
                    prev = p
                runs.append((j0, bits))
                maps.append(m)
            off = 1
            while off < LANES:  # shuffle-up inclusive scan
                maps = [compose(maps[i], maps[i - off], rm) if i >= off
                        else maps[i] for i in range(LANES)]
                off *= 2
            after = [apply(m, a, ph, rm) for m in maps]
            for lane, (j0, bits) in enumerate(runs):
                ar, pr = (a, ph) if lane == 0 else after[lane - 1]
                for t, (up, dn) in enumerate(bits):
                    ar, pr, f = step(ar, pr, up, dn, d, rm)
                    flags[:, c, base + j0 + t] = f
            a, ph = after[LANES - 1]
        act_out[c], ph_out[c] = a, ph
    new_state = {"active": act_out, "lastpower": powers[-1].copy(),
                 "phase": ph_out}
    return new_state, (flags[0] != 0, flags[1] != 0, flags[2] != 0,
                       flags[3].astype(np.int32))


def assert_matches(got, ref):
    got_state, got_flags = got
    ref_state, ref_flags = ref
    for k in ("active", "lastpower", "phase"):
        np.testing.assert_array_equal(np.asarray(got_state[k]),
                                      np.asarray(ref_state[k]), err_msg=k)
    for nm, a, b in zip(("rise", "fall", "processed", "phase_used"),
                        got_flags, ref_flags):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, nm
        np.testing.assert_array_equal(a, b, err_msg=nm)


def inputs(nb, c, r, seed):
    rng = np.random.default_rng(seed)
    powers, state, delta = powact_inputs(rng, nb, c)
    state["phase"] = torch.from_numpy(
        rng.integers(0, r, c).astype(np.int32))
    return powers, state, delta


@pytest.mark.parametrize("r", [1, 2, 4, 8])
@pytest.mark.parametrize("nb", [1, 31, 33, 512, 1100])
def test_scan_model_matches_plain(nb, r):
    """The scan's schedule == the plain chain, flags and state exact."""
    powers, state, delta = inputs(nb, 6, r, nb * 10 + r)
    ref = powact.powact_flags_plain(powers, state, delta, r=r, thresh=10.0)
    got = scan_model(powers.numpy(),
                     {k: v.numpy() for k, v in state.items()},
                     delta.numpy(), r, 10.0)
    assert_matches(got, tuple(
        ({k: v.numpy() for k, v in t.items()} if isinstance(t, dict)
         else tuple(f.numpy() for f in t)) for t in ref))
    if nb >= 31:  # the inputs have edges to walk
        assert ref[1][0].any() and ref[1][1].any()


@pytest.mark.parametrize("r", [2, 4, 8])
@pytest.mark.parametrize("nb", [33, 512])
def test_scan_model_matches_jax(nb, r):
    """The scan's schedule == PowerActivationBank.scan_flags on the Pallas
    (interpret) and lax.scan backends, with the init (FLT_MAX) and floor
    (FLT_MIN) edges."""
    chans = [(0.2, 0.03), (0.45, 0.05), (0.7, 0.02), (0.85, 0.04),
             (0.3, 0.01)]
    banks = [JaxBank(1024, r, chans, 10.0, b)
             for b in ("scan", "pallas_interpret")]
    c = banks[0].num_channels
    powers, state, _ = inputs(nb, c, r, 100 + nb + r)
    delta = np.array([g.delta_phase for g in banks[0].geometry], np.int32)
    np_state = {k: v.numpy() for k, v in state.items()}
    got = scan_model(powers.numpy(), np_state, delta, r, banks[0].thresh)
    for bank in banks:
        ref_state, ref = bank.scan_flags(
            jnp.asarray(powers.numpy()),
            {k: jnp.asarray(v) for k, v in np_state.items()})
        assert_matches(got, ({k: np.asarray(v) for k, v in ref_state.items()},
                             tuple(np.asarray(f) for f in ref)))


@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_map_composition_is_associative(r):
    """(h g) f == h (g f) on random maps, and applying a composed run
    equals walking its blocks one by one, from both entering bits and
    phases in and out of [0, R) (keep leaves an unreduced phase as it
    is)."""
    rng = np.random.default_rng(r)
    rm = r - 1
    for _ in range(200):
        d = int(rng.integers(-9, 10))
        dm, d2 = d & rm, (2 * d) & rm
        bits = [tuple(bool(x) for x in rng.random(2) < 0.4)
                for _ in range(int(rng.integers(1, 12)))]
        maps = [block_map(u, w, dm, d2) for u, w in bits]
        cut1, cut2 = sorted(rng.integers(0, len(maps) + 1, 2))

        def run(ms):
            m = IDENTITY
            for x in ms:
                m = compose(x, m, rm)
            return m

        f, g, h = run(maps[:cut1]), run(maps[cut1:cut2]), run(maps[cut2:])
        assert compose(compose(h, g, rm), f, rm) == compose(
            h, compose(g, f, rm), rm)
        whole = run(maps)
        for a0 in (False, True):
            for ph0 in (0, rm, r + 3, -5):
                a, ph = a0, ph0
                for u, w in bits:
                    a, ph, _ = step(a, ph, u, w, d, rm)
                assert apply(whole, a0, ph0, rm) == (a, ph)
