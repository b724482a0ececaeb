"""Kernel C: the detection segments' slot lifecycles and the burst chain.

Replaces the Pallas kernel ``_lifecycle_kernel`` of
``fdc_tpu/ops/lifecycle_pallas.py`` (``slot_lifecycle_multi`` with its
powact chain). The plain version is the semantics the kernel is held to:
per segment the scan body of ``SegmentDetector.scan_slots``
(``fdc_tpu/models/segment_detection.py:571-690``) followed by
``_free_tombstones``, and for the burst bank the scan body of
``PowerActivationBank.scan_flags``
(``fdc_tpu/models/power_activation.py:184-212``). The CUDA source is
``csrc/lifecycle.cu``.

Candidates arrive as the [B, 7K] pack of
``SegmentDetector._packed_candidates``: per block the groups (start bin,
end bin, valid, wlog2, ext_start, ext_start % R, too_big), accepted
candidates compacted to the front. Both versions read the geometry
groups from the pack; they are ``candidate_geometry`` of the first two
groups (the JAX scan path re-derives them; the tests pin the agreement).
"""

from __future__ import annotations

import numpy as np
import torch

from fdc_tpu_torch import kernels
from fdc_tpu_torch.ops.detect import match_candidates

__all__ = [
    "SLOT_KEYS",
    "slot_lifecycle_multi",
    "slot_lifecycle_multi_plain",
]

# the slot-table fields of SegmentDetector.init_state, in kernel row order
SLOT_KEYS = (
    "active", "tomb", "det_start", "det_stop", "ext_start", "wlog2",
    "phase", "phase_inc", "inactive", "order",
)
_MAX_SEGMENTS = 32  # csrc/lifecycle.cu MAXG
_MAX_LANES = 1024   # slots and candidates per segment: one CUDA block


def _free_tombstones(state):
    """Recycle slots retired this step (the host emitters consumed their
    bursts from this step's outputs): active &= ~tomb, tomb cleared."""
    tomb = state["tomb"]
    return {**state, "active": state["active"] & ~tomb,
            "tomb": torch.zeros_like(tomb)}


def _scan_segment_plain(packed, state, k: int, r: int, delay: int):
    """One segment's lifecycle over the B blocks of ``packed``."""
    cs_all = packed[:, 0 * k:1 * k]
    ce_all = packed[:, 1 * k:2 * k]
    cv_all = packed[:, 2 * k:3 * k] != 0
    wl2_all = packed[:, 3 * k:4 * k]
    es_all = packed[:, 4 * k:5 * k]
    esr_all = packed[:, 5 * k:6 * k]
    big_all = packed[:, 6 * k:7 * k] != 0
    st = {key: state[key].clone() for key in SLOT_KEYS}
    alloc_counter = state["alloc_counter"].clone()
    dropped = state["dropped"].clone()
    zero = torch.zeros((), dtype=torch.int32, device=packed.device)
    flags = []
    for b in range(packed.shape[0]):
        cs, ce, c_v = cs_all[b], ce_all[b], cv_all[b]
        active, tomb = st["active"], st["tomb"]
        live = active & ~tomb

        # 2. match against live slots; age unmatched
        refreshed, consumed = match_candidates(
            cs, ce, c_v, live, st["det_start"], st["det_stop"], st["order"]
        )
        inactive = torch.where(
            live, torch.where(refreshed, zero, st["inactive"] + 1),
            st["inactive"],
        )

        # 3. new-channel candidates (geometry precomputed in the pack)
        new_mask = c_v & ~consumed
        new_ok = new_mask & ~big_all[b]

        # 4. allocate free slots in index order, candidates in
        #    acceptance order
        free = ~active & ~tomb
        rank = torch.cumsum(new_ok.to(torch.int32), 0, dtype=torch.int32) - 1
        free_rank = torch.cumsum(free.to(torch.int32), 0,
                                 dtype=torch.int32) - 1
        assign = (
            free[:, None] & new_ok[None, :]
            & (free_rank[:, None] == rank[None, :])
        )  # [S, K]
        got = torch.any(assign, dim=1)
        cand = torch.argmax(assign.to(torch.int32), dim=1)  # first true
        n_free = free.sum(dtype=torch.int32)
        n_new = new_ok.sum(dtype=torch.int32)
        n_alloc = torch.minimum(n_new, n_free)
        dropped = dropped + (n_new - n_alloc) + (new_mask & big_all[b]).sum(
            dtype=torch.int32)

        def pick(arr_k, current):
            return torch.where(got, arr_k[cand], current)

        active = active | got
        st["det_start"] = pick(cs, st["det_start"])
        st["det_stop"] = pick(ce, st["det_stop"])
        st["ext_start"] = pick(es_all[b], st["ext_start"])
        st["wlog2"] = pick(wl2_all[b], st["wlog2"])
        phase_inc = pick(esr_all[b], st["phase_inc"])
        inactive = torch.where(got, zero, inactive)
        st["order"] = torch.where(got, alloc_counter + rank[cand], st["order"])
        alloc_counter = alloc_counter + n_alloc

        # 5. processing / retiring flags for this block
        live = active & ~tomb
        emit = live & ~got & (inactive > delay)
        tomb = tomb | emit
        processed = live & ~emit
        phase = st["phase"]
        phase_used = torch.where(got, phase_inc, phase)
        st["phase"] = torch.where(
            got, (2 * phase_inc) % r,
            torch.where(processed, (phase + phase_inc) % r, phase),
        )
        st.update(active=active, tomb=tomb, inactive=inactive,
                  phase_inc=phase_inc)
        flags.append((got, processed, emit, phase_used))

    got, processed, emit, phase_used = (
        torch.stack(f) for f in zip(*flags)
    )  # each [B, S]
    st.update(alloc_counter=alloc_counter, dropped=dropped)
    return _free_tombstones(st), (got, processed, emit, phase_used)


def _powact_plain(powact, r: int, thresh: float):
    """The burst hysteresis chain over [B, C] powers; flags [C, B]."""
    thr = float(np.float32(thresh))
    delta = powact["delta"]
    active, lastpower, phase = (
        powact["active"], powact["lastpower"], powact["phase"]
    )
    flags = []
    for pwr in powact["powers"]:
        rise = ~active & (pwr / lastpower >= thr)
        fall = active & (lastpower / pwr >= thr)
        processed = rise | active
        phase_used = torch.where(rise, delta, phase)
        phase = torch.where(
            rise, (2 * delta) % r,
            torch.where(processed, (phase + delta) % r, phase),
        )
        active = (active | rise) & ~fall
        lastpower = pwr
        flags.append((rise, fall, processed, phase_used))
    rise, fall, processed, phase_used = (
        torch.stack(f, dim=1) for f in zip(*flags)
    )
    new_state = {"active": active, "lastpower": lastpower, "phase": phase}
    return new_state, (rise, fall, processed, phase_used)


def slot_lifecycle_multi_plain(packs, states, *, n_cands, rs, delays,
                               powact=None, pa_r=None, pa_thresh=None):
    """Plain PyTorch version of :func:`slot_lifecycle_multi`."""
    results = tuple(
        _scan_segment_plain(p, st, k, r, d)
        for p, st, k, r, d in zip(packs, states, n_cands, rs, delays)
    )
    if powact is None:
        return results
    return results, _powact_plain(powact, pa_r, pa_thresh)


def slot_lifecycle_multi(packs, states, *, n_cands, rs, delays,
                         powact=None, pa_r=None, pa_thresh=None):
    """Run G segments' slot lifecycles (and the burst chain) over a batch.

    Args:
      packs: G [B, 7K_g] int32 candidate packs (see module docstring).
      states: G slot tables (``SegmentDetector.init_state`` dicts).
      n_cands / rs / delays: per-segment K_g, relinvovl, deactivation delay.
      powact: optional {powers [B, C] f32, lastpower [C] f32, active [C]
        bool, phase [C] int32, delta [C] int32}, with ``pa_r`` and
        ``pa_thresh`` (linear).

    Returns G pairs (new_state, (got, processed, emit, phase_used)) with
    flags [B, S_g] in scan order and tombstones freed; with ``powact`` the
    tuple (that, (pa_new_state, (rise, fall, processed, phase_used))) with
    burst flags [C, B]. CPU tensors take the plain version; CUDA tensors
    launch kernel C (one launch for all segments and the burst chain).
    """
    dev = packs[0].device if packs else powact["powers"].device
    if dev.type == "cpu":
        return slot_lifecycle_multi_plain(
            packs, states, n_cands=n_cands, rs=rs, delays=delays,
            powact=powact, pa_r=pa_r, pa_thresh=pa_thresh,
        )
    g_n = len(packs)
    if not 1 <= g_n <= _MAX_SEGMENTS:
        raise ValueError(f"slot_lifecycle_multi: 1..{_MAX_SEGMENTS} "
                         f"segments supported, got {g_n}")
    nb = packs[0].shape[0]
    ss = [st["active"].shape[0] for st in states]
    for p, k, s in zip(packs, n_cands, ss):
        if p.dtype != torch.int32 or p.shape != (nb, 7 * k):
            raise ValueError("slot_lifecycle_multi: int32 [B, 7K] packs "
                             "with a common B expected")
        if not (1 <= k <= _MAX_LANES and 1 <= s <= _MAX_LANES):
            raise ValueError(f"slot_lifecycle_multi: K and S must be in "
                             f"1..{_MAX_LANES}")
    # flat buffers with per-segment offsets (csrc/lifecycle.cu SegTab)
    tab = np.zeros((g_n, 8), np.int32)
    pack_off = state_off = flag_off = pu_off = 0
    for g, (k, r, d, s) in enumerate(zip(n_cands, rs, delays, ss)):
        tab[g] = (k, r, d, s, pack_off, state_off, flag_off, pu_off)
        pack_off += nb * 7 * k
        state_off += 10 * s
        flag_off += 3 * s * nb
        pu_off += s * nb
    packs_flat = torch.cat([p.reshape(-1) for p in packs])
    state_in = torch.cat([
        torch.stack([st[key].to(torch.int32) for key in SLOT_KEYS]).reshape(-1)
        for st in states
    ])
    ctr_in = torch.stack([
        torch.stack([st["alloc_counter"], st["dropped"]]) for st in states
    ]).to(torch.int32)
    state_out = torch.empty_like(state_in)
    ctr_out = torch.empty_like(ctr_in)
    bflags = torch.empty(flag_off, dtype=torch.bool, device=dev)
    pu = torch.empty(pu_off, dtype=torch.int32, device=dev)

    n_pa = 0
    pa_ptrs = [None] * 5
    pa_outs = [None] * 4
    thresh = 0.0
    if powact is not None:
        pw = powact["powers"].contiguous()
        if pw.dtype != torch.float32 or pw.shape[0] != nb:
            raise ValueError("slot_lifecycle_multi: float32 [B, C] burst "
                             "powers expected")
        n_pa = pw.shape[1]
        pa_in = [
            pw,
            powact["lastpower"].to(torch.float32).contiguous(),
            powact["active"].to(torch.int32),
            powact["phase"].to(torch.int32).contiguous(),
            powact["delta"].to(torch.int32).contiguous(),
        ]
        pa_ptrs = [t.data_ptr() for t in pa_in]
        pa_state = torch.empty((2, n_pa), dtype=torch.int32, device=dev)
        pa_last = torch.empty(n_pa, dtype=torch.float32, device=dev)
        pa_bflags = torch.empty((3, n_pa, nb), dtype=torch.bool, device=dev)
        pa_pu = torch.empty((n_pa, nb), dtype=torch.int32, device=dev)
        pa_outs = [t.data_ptr() for t in (pa_state, pa_last, pa_bflags,
                                          pa_pu)]
        thresh = float(np.float32(pa_thresh))
    threads = max(32, -(-max(ss) // 32) * 32)
    rc = kernels.library().fdc_slot_lifecycle(
        g_n, tab.ctypes.data, nb, packs_flat.data_ptr(),
        state_in.data_ptr(), ctr_in.data_ptr(), state_out.data_ptr(),
        ctr_out.data_ptr(), bflags.data_ptr(), pu.data_ptr(),
        max(n_cands), n_pa, *pa_ptrs, thresh, int(pa_r or 1), *pa_outs,
        threads, kernels.stream_ptr(dev),
    )
    kernels.check(rc, "fdc_slot_lifecycle")
    slot_lifecycle_multi.launches += 1

    results = []
    for g, s in enumerate(ss):
        _, _, _, _, _, so, fo, po = (int(v) for v in tab[g])
        rows = state_out[so:so + 10 * s].reshape(10, s)
        new_state = {
            key: (rows[i] != 0 if i < 2 else rows[i])
            for i, key in enumerate(SLOT_KEYS)
        }
        new_state["alloc_counter"] = ctr_out[g, 0]
        new_state["dropped"] = ctr_out[g, 1]
        fl = bflags[fo:fo + 3 * s * nb].reshape(3, s, nb)
        pus = pu[po:po + s * nb].reshape(s, nb)
        # kernel writes [S, B]; return the scan-order [B, S] views
        results.append((new_state, (fl[0].T, fl[1].T, fl[2].T, pus.T)))
    results = tuple(results)
    if powact is None:
        return results
    pa_new = {"active": pa_state[0] != 0, "lastpower": pa_last,
              "phase": pa_state[1]}
    return results, (pa_new, (pa_bflags[0], pa_bflags[1], pa_bflags[2],
                              pa_pu))


slot_lifecycle_multi.launches = 0
