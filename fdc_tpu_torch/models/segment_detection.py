"""Dynamic carrier detection + channelization over one frequency segment.

Port of ``fdc_tpu.models.segment_detection`` (reference:
lib/SegmentDetection_impl.cc). Per batch: the decimated power spectrum
of all blocks, the candidate packs of all blocks at once (kernel B, one
launch for every segment of a step), the slot-table lifecycle over the
blocks (kernel C, ``ops.lifecycle``), a compaction plan of the slots that
need extraction, and one batched variable-width extraction of the
planned slots over the [B+1]-row spectrum batch (row 0 = previous
batch's last block, reference: lib/SegmentDetection_impl.cc:431-435).

Slots are allocated monotonically within a step and freed on device at
step end after the host emitters consumed the retired ones; slot
exhaustion drops new channels with a counter (reference:
lib/SegmentDetection_impl.cc:298-308).

Two-tier extraction (``extract_width_split``): slots whose width fits the
split ship from a second, narrower [E_narrow, B+1, W_split] bucket; wide
slots and narrow overflow ship from the w_cap bucket. With ``vcm`` the
detector follows the multi-segment block's conventions
(``models.activity_detection``). ``use_mxu`` (the ``use_mxu_fft`` knob)
extracts the slots by one product with the W-point IDFT matrix; without
it by ``torch.fft`` (``ops.fft.interp_subband_ifft``), as ``fdc_tpu``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from fdc_tpu_torch.config import SegmentGeometry, solve_segment
from fdc_tpu_torch.ops import detect
from fdc_tpu_torch.ops.detect import PackSpec, cell_power
from fdc_tpu_torch.ops.extract import extract_dynamic
from fdc_tpu_torch.ops.fft import _rr_idft_matrix, interleave_rows
from fdc_tpu_torch.ops import lifecycle
from fdc_tpu_torch.ops.windows import flank_window_bank

__all__ = ["SegmentDetector", "scan_slots_multi"]


class SegmentDetector(nn.Module):
    """One detection segment with an S-slot dynamic channel table.

    Buffers: ``window_table`` [log2(w_cap)+1, w_cap] (phase-0 flank window
    of every power-of-2 width, zero-padded) and, with ``use_mxu``,
    ``idft`` [2 w_cap, 2 w_cap] (the slot transform, rows interleaved)
    and, with ``extract_width_split``, ``idft_narrow`` (the same at the
    split width)."""

    def __init__(
        self,
        segment_id: int,
        blocksize: int,
        relinvovl: int,
        seg_start: float,
        seg_stop: float,
        thresh_db: float,
        minchandist: float,
        window_flank_puffer: float,
        channel_deactivation_delay: int = 1,
        max_slots: int = 32,
        max_candidates: int = 0,
        max_extract_width: int = 0,
        extract_budget: int = 0,
        geometry: SegmentGeometry = None,
        vcm: bool = False,
        extract_width_split: int = 0,
        extract_budget_narrow: int = 0,
        core_bins=None,
        use_mxu: bool = False,
    ):
        super().__init__()
        self.use_mxu = bool(use_mxu)  # the slot transform as a product
        if thresh_db < 0.0:
            raise ValueError("Threshold is dB and must be >= 0")
        if window_flank_puffer < 0.0:
            raise ValueError("window_flank_puffer must be >= 0")
        self.segment_id = segment_id
        self.blocksize = blocksize
        self.relinvovl = relinvovl
        # linear threshold (reference: lib/SegmentDetection_impl.cc:75-77)
        self.thresh = float(10.0 ** (thresh_db / 10.0))
        self.flank_puffer = float(window_flank_puffer)
        self.deactivation_delay = int(channel_deactivation_delay)
        self.max_slots = int(max_slots)
        self.max_candidates = int(max_candidates)  # 0 = exact (all edges)
        # device-side output compaction: rows shipped per step
        self.extract_budget = min(
            int(extract_budget) or self.max_slots, self.max_slots
        )
        # optional narrower second bucket (never more rows than slots)
        self.extract_width_split = int(extract_width_split)
        self.extract_budget_narrow = min(
            int(extract_budget_narrow), self.max_slots
        )
        if self.extract_width_split:
            w = self.extract_width_split
            if w & (w - 1) or not 0 < w < (int(max_extract_width) or blocksize):
                raise ValueError(
                    "extract_width_split must be a power of 2 below "
                    "max_extract_width"
                )
            if self.extract_budget_narrow <= 0:
                raise ValueError(
                    "extract_width_split requires extract_budget_narrow > 0"
                )
            self.split_log2 = int(math.log2(w))
        # the multi-segment block's semantics: 1/decimation power
        # normalization and FLT_MIN zero-denominator edge ratios
        # (reference: lib/activity_detection_channelizer_vcm_impl.cc:630-650,
        # 701-705)
        self.vcm = bool(vcm)
        self.w_cap = int(max_extract_width) or blocksize
        if self.w_cap & (self.w_cap - 1):
            raise ValueError("max_extract_width must be a power of 2")
        self.w_cap = min(self.w_cap, blocksize)
        self.w_cap_log2 = int(math.log2(self.w_cap))
        self.geometry: SegmentGeometry = geometry or solve_segment(
            blocksize, seg_start, seg_stop, minchandist
        )
        # a split part's candidate ownership window
        # (config.split_segment_geometry): reconcile_split keeps a spawn
        # candidate only if its extraction midpoint bin is in [core_bins)
        self.core_bins = None
        if core_bins is not None:
            lo, hi = int(core_bins[0]), int(core_bins[1])
            g = self.geometry
            if not g.start <= lo < hi <= g.stop:
                raise ValueError(
                    f"core_bins {core_bins} outside segment "
                    f"[{g.start}, {g.stop})"
                )
            self.core_bins = (lo, hi)
        # K for edge detection (0 = exact: every ratio position) vs K of
        # the candidate pack: accepted intervals are disjoint and at least
        # two cells wide (thresh >= 1), so at most (n_cells - 1) // 2
        # survive per block and truncating the compacted pack is exact
        self.k_detect = self.max_candidates or (self.geometry.n_cells - 1)
        if self.thresh < 1.0:
            raise ValueError("the k_pack bound requires thresh >= 1")
        self.k_pack = min(
            self.k_detect, max(1, (self.geometry.n_cells - 1) // 2)
        )
        g = self.geometry
        self.pack_spec = PackSpec(
            thresh=self.thresh, k_detect=self.k_detect, k_pack=self.k_pack,
            zero_floor=self.vcm, start=g.start, decimation=g.decimation,
            puffer=self.flank_puffer, w_cap=self.w_cap,
            w_cap_log2=self.w_cap_log2, n=blocksize, r=relinvovl,
        )

        # phase-0 window of every power-of-2 width <= w_cap, zero-padded
        # (reference: lib/SegmentDetection_impl.cc:551-583)
        table = np.zeros((self.w_cap_log2 + 1, self.w_cap), np.float32)
        for s in range(self.w_cap_log2 + 1):
            w = 1 << s
            table[s, :w] = flank_window_bank(
                w, relinvovl, self.flank_puffer
            )[0].real
        self.register_buffer("window_table", torch.from_numpy(table))
        # the slot transform of each bucket width
        self._idft_of = {self.w_cap: "idft"}
        if self.extract_width_split:
            self._idft_of[self.extract_width_split] = "idft_narrow"
        for w, name in self._idft_of.items():
            self.register_buffer(name, torch.from_numpy(interleave_rows(
                _rr_idft_matrix(w, 0, False, 1.0, pairs=True)
            )) if self.use_mxu else None)

    # -- state ----------------------------------------------------------------

    def init_state(self, device):
        s = self.max_slots
        state = {
            key: torch.zeros(s, dtype=torch.int32, device=device)
            for key in lifecycle.SLOT_KEYS
        }
        state["active"] = torch.zeros(s, dtype=torch.bool, device=device)
        state["tomb"] = torch.zeros(s, dtype=torch.bool, device=device)
        state["alloc_counter"] = torch.zeros((), dtype=torch.int32,
                                             device=device)
        state["dropped"] = torch.zeros((), dtype=torch.int32, device=device)
        return state

    # -- device step ----------------------------------------------------------

    def measure(self, sq: torch.Tensor) -> torch.Tensor:
        """[B, N] |X|^2 -> [B, n_cells] decimated segment power
        (reference: lib/SegmentDetection_impl.cc:178-193)."""
        g = self.geometry
        p = cell_power(sq, g.start, g.n_cells, g.decimation)
        if self.vcm:
            p = p * float(np.float32(1.0 / g.decimation))
        return p

    def _packed_candidates(self, power: torch.Tensor) -> torch.Tensor:
        """[B, n_cells] powers -> [B, 7K] candidate pack (K = k_pack):
        groups (start bin, end bin, valid, wlog2, ext_start, ext_start % R,
        too_big), accepted candidates compacted to the front in acceptance
        order, empty columns 0 before the bin conversion
        (``ops.detect.candidate_packs`` of this segment alone)."""
        return detect.candidate_packs([power], [self.pack_spec])[0]

    def _recompact_pack(self, packed: torch.Tensor, keep: torch.Tensor):
        """Order-preserving re-compaction of a [B, 7K] candidate pack under
        a new validity mask ``keep`` [B, K] (K = k_pack): kept candidates
        to the front, group 2 replaced by ``keep``, the rest zero. Kernel C
        reads valid-first packs."""
        b, k = keep.shape
        rank = torch.cumsum(keep.to(torch.int32), 1, dtype=torch.int32) - 1
        dest = torch.where(keep, rank, k).long()  # column k: discard
        groups = packed.reshape(b, 7, k).clone()
        groups[:, 2] = keep.to(torch.int32)
        taken = torch.zeros((b, 7, k + 1), dtype=torch.int32,
                            device=packed.device)
        taken.scatter_(2, dest[:, None, :].expand(b, 7, k), groups)
        return taken[:, :, :k].reshape(b, 7 * k)

    def reconcile_split(self, state, packed, kill_from, suppress_from):
        """A split part's pre-scan reconciliation against its neighbors'
        slot tables as of the end of the previous batch (``kill_from`` /
        ``suppress_from``: tuples ``(det_start, det_stop, live)``, see
        :meth:`split_foreign_view`), with ``fdc_tpu``'s three rules:

        1. kill: a live local slot overlapping a live slot of the lower
           neighbor is dropped silently (``killed``: the emitters discard
           its buffered samples);
        2. refresh priority: a candidate overlapping a live local slot is
           kept, and so is one overlapping an earlier block's kept
           candidate of this batch (the batch-local chain closure);
        3. spawn ownership: any other candidate is kept only if its
           midpoint bin is in this part's core and it overlaps no live
           foreign slot.

        Returns ``(state', packed', killed [S] bool)``."""
        dev = packed.device
        killed = torch.zeros(self.max_slots, dtype=torch.bool, device=dev)
        new_state = state
        if kill_from:
            live = state["active"] & ~state["tomb"]
            ov = torch.zeros_like(killed)
            for fds, fde, flive in kill_from:
                # the candidate-match convention (start < stop, stop >= start)
                ov = ov | ((state["det_start"][:, None] < fde[None, :])
                           & (state["det_stop"][:, None] >= fds[None, :])
                           & flive[None, :]).any(1)
            killed = live & ov
            new_state = {**state, "active": state["active"] & ~killed}
        if self.core_bins is None:
            return new_state, packed, killed
        k = self.k_pack
        cs, ce = packed[:, :k], packed[:, k:2 * k]
        cv = packed[:, 2 * k:3 * k] != 0
        mid = cs + (ce - cs) // 2  # candidate_geometry's midpoint bin
        lo, hi = self.core_bins
        in_core = (mid >= lo) & (mid < hi)
        # cell-mask form on the part's cells: all values are cell-aligned
        # bins, so "candidate [cs, ce) overlaps slot [ds, de)" is "its
        # cells meet the slot's cells extended one cell down"
        g = self.geometry
        dec = g.decimation
        cell_bins = g.start + torch.arange(g.n_cells, dtype=torch.int32,
                                           device=dev) * dec
        in_int = ((cell_bins[None, None, :] >= cs[:, :, None])
                  & (cell_bins[None, None, :] < ce[:, :, None]))  # [B, K, C]

        def slot_cover(ds, de, live_mask):
            return (live_mask[:, None]
                    & (cell_bins[None, :] >= ds[:, None] - dec)
                    & (cell_bins[None, :] < de[:, None])).any(0)  # [C]

        live = new_state["active"] & ~new_state["tomb"]
        loc_cover = slot_cover(new_state["det_start"], new_state["det_stop"],
                               live)
        f_cover = torch.zeros(g.n_cells, dtype=torch.bool, device=dev)
        for fds, fde, flive in suppress_from:
            f_cover = f_cover | slot_cover(fds, fde, flive)
        local_ov = (in_int & loc_cover).any(2)  # [B, K]
        f_ov = (in_int & f_cover).any(2)
        keep0 = cv & (local_ov | (in_core & ~f_ov))
        # the batch-local chain: cells covered by an EARLIER block's kept
        # candidate (the exclusive prefix OR over blocks, as "the first
        # block covering the cell comes before this one")
        covered = (in_int & keep0[:, :, None]).any(1)  # [B, C]
        nb = covered.shape[0]
        blocks = torch.arange(nb, device=dev)[:, None]
        first = torch.where(covered, blocks, nb).amin(0)  # [C]
        earlier = blocks > first  # [B, C]
        chain_ov = (in_int & earlier[:, None, :]).any(2)
        keep = keep0 | (cv & chain_ov)
        return new_state, self._recompact_pack(packed, keep), killed

    @staticmethod
    def split_foreign_view(state):
        """The slot-interval table a split part publishes to its neighbors
        for :meth:`reconcile_split`: (det_start, det_stop, live)."""
        return (state["det_start"], state["det_stop"],
                state["active"] & ~state["tomb"])

    def extract_plan(self, got, processed):
        """Output compaction plan from [B, S] flags: (slot_ids [E] int32,
        overflow int32) — slots activated or processed this step first, in
        slot-index order, then idle slots as filler; overflow counts needy
        slots beyond the budget E."""
        s = self.max_slots
        e = self.extract_budget
        dev = got.device
        if e >= s:
            return (torch.arange(s, dtype=torch.int32, device=dev),
                    torch.zeros((), dtype=torch.int32, device=dev))
        need = torch.any(got | processed, dim=0)  # [S]
        n_need = need.sum(dtype=torch.int32)
        rank_needy = torch.cumsum(need.to(torch.int32), 0) - 1
        rank_idle = n_need + torch.cumsum((~need).to(torch.int32), 0) - 1
        pos = torch.where(need, rank_needy, rank_idle)  # [S] permutation
        ids = torch.empty(s, dtype=torch.int32, device=dev)
        ids[pos.long()] = torch.arange(s, dtype=torch.int32, device=dev)
        overflow = torch.clamp(n_need - e, min=0).to(torch.int32)
        return ids[:e], overflow

    def extract_plan_split(self, got, processed, wlog2_state):
        """Two-bucket compaction plan (``extract_width_split``): needy
        slots that fit the narrow bucket fill it first, in slot order; the
        remaining needy slots (wide ones and narrow overflow) fill the
        wide bucket. Unfilled rows hold the sentinel S (they extract zeros
        and the emitters skip them). Returns (ids_narrow [E_n], ids_wide
        [E_w], overflow int32: needy slots in neither bucket)."""
        s = self.max_slots
        dev = got.device
        need = torch.any(got | processed, dim=0)  # [S]
        slots = torch.arange(s, dtype=torch.int32, device=dev)

        def pick(mask, budget):
            rank = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
            chosen = mask & (rank < budget)
            # row `budget` is a discard row for the slots not chosen
            ids = torch.full((budget + 1,), s, dtype=torch.int32, device=dev)
            ids[torch.where(chosen, rank, budget).long()] = slots
            return chosen, ids[:budget]

        narrow_ok = need & (wlog2_state <= self.split_log2)
        in_n, ids_n = pick(narrow_ok, self.extract_budget_narrow)
        in_w, ids_w = pick(need & ~in_n, self.extract_budget)
        overflow = (need.sum(dtype=torch.int32) - in_n.sum(dtype=torch.int32)
                    - in_w.sum(dtype=torch.int32))
        return ids_n, ids_w, overflow

    def extract_slots(self, spec_ext: torch.Tensor, state, slot_ids,
                      width: int = None):
        """Variable-width extraction of the slots named by ``slot_ids``
        over every row of ``spec_ext``: [E, rows, width, 2] phase-0
        interpolated pairs (see ``ops.extract.extract_dynamic``), width
        the bucket's (default w_cap; the split width for the narrow
        bucket). A sentinel id (S) and a slot wider than the bucket get
        start 0 and an all-zero window, hence zero rows. Without
        ``use_mxu`` the transform is ``torch.fft``'s."""
        w = width or self.w_cap
        ids = slot_ids.long()
        valid = ids < self.max_slots
        ids = torch.where(valid, ids, 0)
        wlog2 = state["wlog2"][ids].long()
        ok = valid & (wlog2 <= int(math.log2(w)))
        ext_start = torch.where(valid, state["ext_start"][ids], 0)
        windows = torch.where(
            ok[:, None], self.window_table[torch.where(ok, wlog2, 0), :w], 0.0
        )
        return extract_dynamic(spec_ext, ext_start.to(torch.int32), windows,
                               getattr(self, self._idft_of[w]))

    def plan_outputs(self, seg_state, flags):
        """The scan-stage outputs of one step: flags in host layout [S, B],
        the slot_meta snapshot and the extraction plan(s)."""
        got, processed, emit_now, phase_used = flags
        so = {
            "activated": got.T,
            "processed": processed.T,
            "emit": emit_now.T,
            "phase_used": phase_used.T,
            "slot_meta": {
                "ext_start": seg_state["ext_start"],
                "wlog2": seg_state["wlog2"],
                "order": seg_state["order"],
            },
        }
        if self.extract_width_split:
            ids_n, ids_w, overflow = self.extract_plan_split(
                got, processed, seg_state["wlog2"])
            so["slot_ids_narrow"] = ids_n
        else:
            ids_w, overflow = self.extract_plan(got, processed)
        so["slot_ids"] = ids_w
        so["ext_overflow"] = overflow
        return so

    def extract_planned(self, spec_ext, seg_state, so):
        """The planned slots' extractions: {"extract"} and, with
        ``extract_width_split``, {"extract_narrow"}."""
        out = {"extract": self.extract_slots(spec_ext, seg_state,
                                             so["slot_ids"])}
        if self.extract_width_split:
            out["extract_narrow"] = self.extract_slots(
                spec_ext, seg_state, so["slot_ids_narrow"],
                width=self.extract_width_split)
        return out


def scan_slots_multi(segments, states, packed_list, powact=None):
    """All segments' lifecycle scans (and the burst bank's hysteresis
    chain, ``powact=(bank, pa_powers, pa_state)``) in one kernel C
    launch. Returns a list of (new_state, (got, processed, emit,
    phase_used)) with flags [B, S], and with ``powact`` the pair
    (that list, (pa_new_state, pa_flags [C, B]))."""
    kw = {}
    if powact is not None:
        bank, pa_powers, pa_state = powact
        kw = dict(
            powact={
                "powers": pa_powers,
                "lastpower": pa_state["lastpower"],
                "active": pa_state["active"],
                "phase": pa_state["phase"],
                "delta": bank.delta,
            },
            pa_r=bank.relinvovl,
            pa_thresh=bank.thresh,
        )
    out = lifecycle.slot_lifecycle_multi(
        tuple(packed_list), tuple(states),
        n_cands=tuple(sd.k_pack for sd in segments),
        rs=tuple(sd.relinvovl for sd in segments),
        delays=tuple(sd.deactivation_delay for sd in segments),
        **kw,
    )
    if powact is None:
        return list(out)
    seg_results, pa_result = out
    return list(seg_results), pa_result
