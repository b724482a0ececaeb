"""Lanes: the torch devices a multi-device channelizer runs on.

A lane is one entry of a device list; entries may repeat, and on CUDA
each lane has a ``torch.cuda.Stream`` of its own, so several lanes on one
card run as concurrent streams. :class:`Lanes` is the part that the MPMD
pipeline (``parallel.pipeline``) and the SPMD sharded step
(``parallel.sharded``) share: running on a lane, handing tensors from one
lane to another, the per-device replicas of the module's tables, the
placement of the carry, the scan-owner groups' stage B and the gather of
per-time-run detection statistics into the batch layout the scans read.

Ordering: a lane that reads what another lane made first waits for that
lane's stream (``Stream.wait_stream``) and records the tensor on its own
stream (``Tensor.record_stream``: the caching allocator would otherwise
hand the memory out again while the reader still runs). Lane ``None`` is
the caller's current stream.

Compiled steps (``runtime.compiled``): a step that runs on several
lanes forks their streams from the caller's stream first and joins them
back before it returns, so one CUDA graph captures every lane's part and
replays it on the caller's stream; its lanes must be streams of one card.
"""

from __future__ import annotations

import contextlib
import copy
from typing import List

import numpy as np
import torch

from fdc_tpu_torch.models.channelizer import resolve_device
from fdc_tpu_torch.models.segment_detection import (
    SegmentDetector,
    scan_slots_multi,
)
from fdc_tpu_torch.ops.detect import pack_offsets
from fdc_tpu_torch.runtime.compiled import CaptureError

__all__ = ["Lanes", "lane_devices", "tree_map", "leaves", "merge_rows",
           "join_packs"]


def lane_devices(devices) -> List[torch.device]:
    """The lanes' torch devices: every CUDA device when ``devices`` is
    empty (there is no CPU fallback), else the given entries, repeats
    kept, a bare ``"cuda"`` read as the current CUDA device."""
    if not devices:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fdc_tpu_torch: no CUDA device (the kernels run on the "
                "card); pass devices=['cpu', ...] for their plain PyTorch "
                "versions"
            )
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return out


def tree_map(fn, tree):
    """fn over the tensor leaves of nested dicts / lists / tuples (None
    leaves stay None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def leaves(tree):
    """The tensor leaves of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def merge_rows(parts):
    """Row families of consecutive time runs, each [C, n_k + 1, ...] with
    row 0 the run's reach-back row (the block before it), joined into
    [C, 1 + sum(n_k), ...]: the first run's reach-back row, then every
    run's own rows (numpy arrays or tensors of one device)."""
    if len(parts) == 1:
        return parts[0]
    pieces = [parts[0][:, :1]] + [p[:, 1:] for p in parts]
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(pieces, axis=1)
    return torch.cat(pieces, dim=1)


def join_packs(parts):
    """The candidate packs of consecutive time runs (per run, its G
    [b, 7K] packs) joined into G [B, 7K] views of one flat buffer at
    kernel C's pack offsets (``lifecycle.seg_table``), on the caller's
    stream, so kernel C reads them in place."""
    ks = [p.shape[1] // 7 for p in parts[0]]
    runs = [p[0].shape[0] for p in parts]
    nb = sum(runs)
    offs, total = pack_offsets(nb, ks)
    flat = torch.empty(total, dtype=torch.int32, device=parts[0][0].device)
    views = [flat.as_strided((nb, 7 * k), (7 * k, 1), o)
             for o, k in zip(offs, ks)]
    row = 0
    for packs, n in zip(parts, runs):
        for v, p in zip(views, packs):
            v[row:row + n].copy_(p)
        row += n
    return views


class Lanes:
    """Mixin of a :class:`FrequencyDomainChannelizer` subclass that runs
    on ``self.devices`` (set by :meth:`_init_lanes`). Stage B's segment
    groups are ``self._owner_groups`` ([(lane, [segment indices])], empty
    for one kernel C launch on lane 0) and ``self._seg_lane`` (each
    segment's owner lane, where its carry lives)."""

    def _init_lanes(self, devs):
        self.devices = devs
        self._streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                         else None for d in devs]
        self._owner_groups = []
        self._seg_lane = [0] * len(self.segments)
        # the module's tables live on devices[0]; a lane on another device
        # reads a replica of them there, one per distinct device
        self._replicas = {}
        for d in devs:
            if d not in self._replicas:
                self._replicas[d] = self if d == self.device else (
                    self._replica(d))

    def _set_owner_groups(self, owners):
        """Segment i's chain on ``owners[i % len(owners)]`` (lanes), the
        burst chain with the first group; one group is one kernel C
        launch on lane 0 (no groups)."""
        if len(owners) < 2 or len(self.segments) < 2:
            return
        groups = {}
        for i in range(len(self.segments)):
            groups.setdefault(owners[i % len(owners)], []).append(i)
        self._owner_groups = sorted(groups.items())
        for lane, ids in self._owner_groups:
            for i in ids:
                self._seg_lane[i] = lane

    def _replica(self, device):
        """A view of this module with its buffers and sub-modules copied
        to ``device`` (the tables of a lane on another device); host state
        and emitters are shared and unused."""
        rep = copy.copy(self)
        rep.__dict__["_buffers"] = {
            k: None if v is None else v.to(device)
            for k, v in self._buffers.items()}
        rep.__dict__["_modules"] = {
            k: copy.deepcopy(m).to(device) for k, m in self._modules.items()}
        rep.__dict__["device"] = device
        return rep

    def _graphed(self, lanes=None) -> bool:
        """Whether the steps run compiled (``compile_step``, the class's or
        the instance's). A graph that spans ``lanes`` (default: every
        lane) holds the streams of one card: lanes on several CUDA
        devices raise :class:`CaptureError` (no eager fallback)."""
        if not self.compile_step:
            return False
        lanes = range(len(self.devices)) if lanes is None else lanes
        cards = {self.devices[ln] for ln in lanes
                 if self.devices[ln].type == "cuda"}
        if len(cards) > 1:
            raise CaptureError(
                f"one CUDA graph would span the lanes of {len(cards)} "
                f"devices ({sorted(map(str, cards))}); a graph holds one "
                f"card's streams: set compile_step to False to run the "
                f"step eagerly")
        return True

    def _stream(self, lane):
        """The lane's stream; lane None: the caller's current stream (None
        on the CPU)."""
        if lane is not None:
            return self._streams[lane]
        d = self.devices[0]
        return torch.cuda.current_stream(d) if d.type == "cuda" else None

    def _on(self, lane):
        """Run on the lane's stream (CUDA) or as it is (CPU, lane None)."""
        s = None if lane is None else self._streams[lane]
        return contextlib.nullcontext() if s is None else torch.cuda.stream(s)

    def _fork(self, lanes):
        """The lanes' streams wait for the caller's (inside a capture: they
        join it)."""
        for ln in lanes:
            s = self._streams[ln]
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(s.device))

    def _handoff(self, tree, src, dst):
        """Tensors made on lane ``src`` (None: the caller's stream),
        readable on lane ``dst``: moved to its device (the copy ordered on
        ``src``), ``dst`` waiting for what ``src`` has enqueued, and each
        recorded on ``dst``'s stream."""
        dev = self.devices[dst]
        s_src, s_dst = self._stream(src), self._streams[dst]
        with self._on(src):
            moved = tree_map(lambda t: t.to(dev), tree)
        if s_dst is not None and s_dst is not s_src:
            if s_src is not None:
                s_dst.wait_stream(s_src)
            for t in leaves(moved):
                if t.device == dev:
                    t.record_stream(s_dst)
        return moved

    def _from_caller(self, tree, dst):
        """Tensors the caller's stream made (inputs, a restored carry),
        readable on lane ``dst``: the lane waits for that stream and
        records them."""
        s = self._streams[dst]
        if s is not None:
            s.wait_stream(torch.cuda.current_stream(s.device))
            for t in leaves(tree):
                if t.device == s.device:
                    t.record_stream(s)
        return tree

    def _to_caller(self, tree, lanes=None):
        """The caller's streams wait for every lane (of ``lanes``), and
        every CUDA leaf of ``tree`` is recorded on its device's current
        stream (outputs made on the lanes, read by the caller)."""
        for ln in range(len(self._streams)) if lanes is None else lanes:
            s = self._streams[ln]
            if s is not None:
                torch.cuda.current_stream(s.device).wait_stream(s)
        for t in leaves(tree):
            if t.device.type == "cuda":
                t.record_stream(torch.cuda.current_stream(t.device))
        return tree

    def _carry_lane(self, key: str) -> int:
        return self._seg_lane[int(key[3:])] if key.startswith("seg") else 0

    def _adopt_carry(self):
        """The caller's stream may have written the carry (its init, a
        restored checkpoint, the checkpoint sync): every lane waits for
        it, and each carry leaf is recorded on its owner lane's stream."""
        if self._carry is None:
            with self._on(0):
                self._carry = self._device_init()
        self._adopt(self._carry)

    def _adopt(self, carry):
        for s in self._streams:
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(s.device))
        for key, val in carry.items():
            s = self._streams[self._carry_lane(key)]
            if s is not None:
                for t in leaves(val):
                    if t.device == s.device:
                        t.record_stream(s)

    # -- stage B ------------------------------------------------------------

    def _gather_packs(self, parts, dst):
        """The candidate packs of consecutive time runs (``parts``: per
        run, (lane, the run's G pack views)) joined on lane ``dst``
        (:func:`join_packs`)."""
        moved = [self._handoff(list(packs), lane, dst)
                 for lane, packs in parts]
        with self._on(dst):
            return join_packs(moved)

    def _gather_rows(self, parts, dst):
        """Tensors of consecutive time runs (``parts``: (lane, [n, ...]))
        joined along dim 0 on lane ``dst``."""
        moved = [self._handoff(t, lane, dst) for lane, t in parts]
        with self._on(dst):
            return torch.cat(moved) if len(moved) > 1 else moved[0]

    def _scan_one(self, carry, lane, pa_powers, seg_packed):
        """Stage B as one kernel C (or D) launch on lane 0, in batch
        order: only the small powers and candidate packs travel there."""
        pa_o, segk_o = self._handoff((pa_powers, list(seg_packed)), lane, 0)
        with self._on(0):
            carry = dict(carry)
            scans = self._scan_detections(carry, pa_o, segk_o)
        return carry, scans

    def _group_scan(self, lane, ids, states, packs, powact, foreign):
        """One owner lane's stage B: its segment group's cut
        reconciliation against the ``foreign`` views ({local index:
        (lower view | None, upper view | None)}), the group's scans in one
        kernel C launch (with the burst chain on group 0: ``powact`` =
        (pa_powers, pa_state)) and the plans (JAX:
        parallel/pipeline.py:451-507)."""
        rep = self._replicas[self.devices[lane]]
        sds = [rep.segments[i] for i in ids]
        states, packs, killed = list(states), list(packs), {}
        for lk, (lo_v, hi_v) in foreign.items():
            kill_from = [] if lo_v is None else [lo_v]
            suppress_from = kill_from + ([] if hi_v is None else [hi_v])
            states[lk], packs[lk], killed[lk] = sds[lk].reconcile_split(
                states[lk], packs[lk], kill_from, suppress_from)
        pa_res = None
        if powact is not None:
            seg_scans, pa_res = scan_slots_multi(
                sds, states, packs, powact=(rep.power_bank, *powact))
        else:
            seg_scans = scan_slots_multi(sds, states, packs)
        outs = []
        for lk, (sd, (st, flags)) in enumerate(zip(sds, seg_scans)):
            so = sd.plan_outputs(st, flags)
            if lk in killed:
                so["killed"] = killed[lk]
            outs.append((st, so))
        return outs, pa_res

    def _scan_groups(self, carry, lane, pa_powers, seg_packed):
        """Multi-owner stage B: each owner lane advances its segment
        group's chain. The split parts' neighbour views are taken from
        the previous batch's states before any group runs (the lagged
        contract of ``SegmentDetector.reconcile_split``), each on the lane
        that owns the part. A group's packs reach its lane as views of
        kernel B's flat buffer; kernel C reads them in place where they
        sit at the group's own pack offsets (a single segment), else as
        one copy a group (``lifecycle._flat_packs``)."""
        views = {}
        for i in self._split_neighbors:
            with self._on(self._seg_lane[i]):
                views[i] = SegmentDetector.split_foreign_view(
                    carry[f"seg{i}"])
        results = [None] * len(self.segments)
        pa_res = None
        carry = dict(carry)
        for k, (olane, ids) in enumerate(self._owner_groups):
            # a segment's carry lives on its owner lane (a restored carry
            # may sit on devices[0]: handing off to itself moves it)
            states = [self._handoff(carry[f"seg{i}"], olane, olane)
                      for i in ids]
            packs = self._handoff([seg_packed[i] for i in ids], lane, olane)
            foreign = {}
            for lk, i in enumerate(ids):
                if i in self._split_neighbors:
                    foreign[lk] = tuple(
                        None if j is None else self._handoff(
                            views[j], self._seg_lane[j], olane)
                        for j in self._split_neighbors[i])
            powact = None
            if k == 0 and self.power_bank:
                powact = (self._handoff(pa_powers, lane, olane),
                          carry["powact"])
            with self._on(olane):
                outs, pa_k = self._group_scan(olane, ids, states, packs,
                                              powact, foreign)
            if k == 0:
                pa_res = pa_k
            for i, (st, so) in zip(ids, outs):
                carry[f"seg{i}"] = st
                results[i] = (st, so)
        scans = {"segs": results}
        if self.power_bank:
            carry["powact"], scans["powact"] = pa_res
        return carry, scans

    def _scan(self, carry, lane, pa_powers, seg_packed):
        """Stage B from ``carry`` and the powers and packs on ``lane``:
        the owner groups' chains, or one launch on lane 0. Returns (the
        new carry, the scans' flags and plans)."""
        if self._owner_groups:
            return self._scan_groups(carry, lane, pa_powers, seg_packed)
        return self._scan_one(carry, lane, pa_powers, seg_packed)
