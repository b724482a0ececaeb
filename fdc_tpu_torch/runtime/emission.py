# Copied from fdc_tpu/runtime/emission.py; only the import lines differ.
"""Host emission layer: turns device step outputs into ChannelEvents.

The devices return dense per-block flags plus phase-0 extraction tensors;
this layer replays the reference's per-block emission logic exactly —
burst buffers, part counters, maxblocks partial emission, metadata and ID
conventions — producing :class:`fdc_tpu.utils.events.ChannelEvent` records
(the PDU equivalents) and optional raw files.

Block-count conventions differ between the two reference blocks and are
replicated:
- PowerActivationChannel: blockcount starts at 1 ("hist is block 0") and the
  count during handling of global block t is t+1
  (reference: lib/PowerActivationChannel_impl.cc:96,147-171).
- SegmentDetection: d_blockcount starts at 0 and is incremented after each
  block, so emission during block t reads t
  (reference: lib/SegmentDetection_impl.cc:117,141-154).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from fdc_tpu_torch.utils.events import (
    ChannelEvent,
    FileSink,
    current_timestamp,
    make_event_id,
)

__all__ = [
    "PowerActivationEmitter",
    "SegmentDetectionEmitter",
    "NativePowerActivationEmitter",
    "NativeSegmentDetectionEmitter",
]


def _phase_rot_table(relinvovl: int) -> np.ndarray:
    return np.exp(2j * np.pi * np.arange(relinvovl) / relinvovl).astype(
        np.complex64
    )


# ---------------------------------------------------------------------------
# Native engine state <-> structured schema (checkpoint portability)
#
# The C++ engine serializes per-unit burst state as a binary blob
# (runtime/native/emission.cc fdc_emit_save_state: count, part, es, ee, w,
# live, n_blocks, finished, id_len, id bytes, then per block len+samples).
# Checkpoints must restore across emitter BACKENDS — a capture saved on a
# machine with the native build must resume on one without it and vice
# versa (VERDICT r3 item 5) — so the native emitters' get_state/set_state
# speak the SAME structured schema as the Python emitters, converting
# through these two helpers. Legacy {"native_blob": ...} checkpoints load
# into either backend too.
# ---------------------------------------------------------------------------

import struct as _struct

_UNIT_HDR = _struct.Struct("<9q")


def _parse_native_blob(blob: bytes, n_units: int) -> list:
    """Blob -> per-unit dicts {count, part, es, ee, w, live, fin,
    msg_id, blocks}."""
    units = []
    off = 0
    for _ in range(n_units):
        (count, part, es, ee, w, live, nb, fin, idl) = _UNIT_HDR.unpack_from(
            blob, off
        )
        off += _UNIT_HDR.size
        msg_id = blob[off:off + idl].decode()
        off += idl
        blocks = []
        for _ in range(nb):
            (bl,) = _struct.unpack_from("<q", blob, off)
            off += 8
            blocks.append(
                np.frombuffer(blob, np.complex64, bl, off).copy()
            )
            off += 8 * bl
        units.append(
            dict(count=count, part=part, es=es, ee=ee, w=w,
                 live=live != 0, fin=fin, msg_id=msg_id, blocks=blocks)
        )
    if off != len(blob):
        raise ValueError(
            f"native emitter blob: {len(blob) - off} trailing bytes"
        )
    return units


def _build_native_blob(units: list) -> bytes:
    """Per-unit dicts (see :func:`_parse_native_blob`) -> blob."""
    out = bytearray()
    for u in units:
        idb = u["msg_id"].encode()
        out += _UNIT_HDR.pack(
            int(u["count"]), int(u["part"]), int(u["es"]), int(u["ee"]),
            int(u["w"]), 1 if u["live"] else 0, len(u["blocks"]),
            int(u["fin"]), len(idb),
        )
        out += idb
        for b in u["blocks"]:
            b = np.ascontiguousarray(b, np.complex64)
            out += _struct.pack("<q", len(b)) + b.tobytes()
    return bytes(out)


def _surface_overflow(outputs, cumulative: int, log_fn) -> int:
    """Count + log the device-side compaction overflow (the reference's
    philosophy is clamp/skip + LOG, lib/SegmentDetection_impl.cc:298-308 —
    data loss must never be silent). Shared by the Python and native
    segment emitters so the two can never drift; returns the updated
    cumulative count."""
    ovf = int(np.sum(np.asarray(outputs.get("ext_overflow", 0))))
    if ovf:
        cumulative += ovf
        if log_fn is not None:
            log_fn(
                f"extraction budget exceeded: {ovf} needy slot(s) "
                f"zeroed this step (cumulative {cumulative})"
            )
    return cumulative


def _log_seg_emission(log, ev: "ChannelEvent"):
    """Reference lifecycle log line for a segment-detection emission
    (reference: lib/SegmentDetection_impl.cc:474-481 fin,
    :530-538 part — same lines in the vcm block,
    lib/activity_detection_channelizer_vcm_impl.cc:443-455,500-512)."""
    if log is None:
        return
    if ev.finalized:
        log(
            f"{ev.ID}.fin: start={ev.vectorstart}, stop={ev.vectorend}, "
            f"blockstart={ev.blockstart}, blockend={ev.blockend}"
        )
    else:
        log(
            f"{ev.ID}.part: start={ev.vectorstart}, stop={ev.vectorend}, "
            f"part={ev.part}, blockstart={ev.blockstart}, "
            f"blockend={ev.blockend}"
        )


def _log_pa_emission(log, ev: "ChannelEvent", es: int, ee: int):
    """Reference lifecycle log line for a power-activation emission
    (reference: lib/PowerActivationChannel_impl.cc:245-253): the suffix is
    '.fin' or '.parted.<part>' and start/stop are the extract bin bounds."""
    if log is None:
        return
    bare = ev.ID.rsplit(".", 1)[0]  # event IDs carry .fin/.part already
    suffix = ".fin" if ev.finalized else f".parted.{ev.part}"
    log(
        f"{bare}{suffix}: start={es}, stop={ee}, "
        f"blockstart={ev.blockstart}, blockend={ev.blockend}"
    )


class PowerActivationEmitter:
    """Burst assembly + emission for a PowerActivationBank.

    One instance owns the host state of all C channels: burst buffers,
    part/count counters, message IDs (reference state:
    lib/PowerActivationChannel_impl.h via :96-110 ctor).
    """

    def __init__(
        self,
        bank,
        maxblocks: int,
        file_sink: Optional[FileSink] = None,
        msg_output: bool = True,
        channel_logs: Optional[list] = None,
    ):
        self.bank = bank
        self.maxblocks = int(maxblocks)
        self.file_sink = file_sink
        self.msg_output = msg_output
        # per-channel lifecycle loggers (reference: one PowerActivationChannel
        # block per channel, each with its own log file); None disables
        self.channel_logs = channel_logs
        self.rot = _phase_rot_table(bank.relinvovl)

        c = bank.num_channels
        self._blocks = [[] for _ in range(c)]
        self._count = np.zeros(c, np.int64)
        self._part = np.zeros(c, np.int64)
        self._msg_id = [""] * c
        self._finished = np.zeros(c, np.int64)

        # channel -> (bucket width, row inside bucket extraction tensor)
        self._loc = {}
        for bucket in bank.buckets:
            for row, chan in enumerate(bucket.channel_ids):
                self._loc[chan] = (bucket.width, row)

    def get_state(self) -> dict:
        """Host-side burst state for checkpointing (fdc_tpu.runtime.checkpoint)."""
        return {
            "blocks": [[b.copy() for b in ch] for ch in self._blocks],
            "count": self._count.copy(),
            "part": self._part.copy(),
            "msg_id": list(self._msg_id),
            "finished": self._finished.copy(),
        }

    def set_state(self, st: dict):
        if "native_blob" in st:  # legacy native-emitter checkpoint
            units = _parse_native_blob(
                st["native_blob"], self.bank.num_channels
            )
            st = {
                "blocks": [u["blocks"] for u in units],
                "count": [u["count"] for u in units],
                "part": [u["part"] for u in units],
                "msg_id": [u["msg_id"] for u in units],
                "finished": [u["fin"] for u in units],
            }
        self._blocks = [[np.asarray(b) for b in ch] for ch in st["blocks"]]
        self._count = np.asarray(st["count"]).copy()
        self._part = np.asarray(st["part"]).copy()
        self._msg_id = list(st["msg_id"])
        self._finished = np.asarray(st["finished"]).copy()

    def _emit(self, c: int, fin: bool, blockcount: int) -> ChannelEvent:
        g = self.bank.geometry[c]
        # msgoutput=False skips sample assembly (the reference gates PDU
        # construction on the flag, lib/PowerActivationChannel_impl.cc:223-233);
        # burst state updates and file output are unaffected.
        want_data = self.msg_output or self.file_sink is not None
        data = (
            np.concatenate(self._blocks[c])
            if (want_data and self._blocks[c])
            else np.zeros(0, np.complex64)
        )
        self._blocks[c] = []
        ev = ChannelEvent(
            # dict ID carries a .fin/.part suffix
            # (reference: lib/PowerActivationChannel_impl.cc:224)
            ID=self._msg_id[c] + (".fin" if fin else ".part"),
            finalized=fin,
            part=int(self._part[c]),
            rel_cfreq=(g.extract_start + g.extract_stop) / 2.0 / self.bank.blocksize,
            rel_bw=g.extract_width / self.bank.blocksize,
            blockstart=int(blockcount - self._count[c]),
            blockend=int(blockcount),
            data=data,
        )
        if self.file_sink is not None:
            # file name uses the bare ID + .fin/.parted.N
            # (reference: lib/PowerActivationChannel_impl.cc:236-237)
            fev = ChannelEvent(
                **{**ev.__dict__, "ID": self._msg_id[c]}
            )
            self.file_sink.write(fev)
        if self.channel_logs is not None:
            _log_pa_emission(
                self.channel_logs[c], ev, g.extract_start, g.extract_stop
            )
        self._part[c] += 1
        return ev

    def process_step(self, outputs, t0: int) -> List[ChannelEvent]:
        """Replay B blocks of device flags; returns events in emission order.

        outputs: numpy-converted device outputs of PowerActivationBank.step.
        t0: global index of the first block of this batch.
        """
        rise = np.asarray(outputs["rise"])
        fall = np.asarray(outputs["fall"])
        processed = np.asarray(outputs["processed"])
        phase_used = np.asarray(outputs["phase_used"])
        ext = {w: np.asarray(v) for w, v in outputs["extract"].items()}

        c_total, nb = rise.shape
        events: List[ChannelEvent] = []
        mb = self.maxblocks

        for b in range(nb):
            blockcount = t0 + b + 1
            # only touch channels with any flag set this block
            for c in np.nonzero(rise[:, b] | processed[:, b])[0]:
                width, row = self._loc[c]
                rows = ext[width]
                if rise[c, b]:
                    # activate: reset burst, process hist + current block
                    # (reference: lib/PowerActivationChannel_impl.cc:198-210)
                    self._part[c] = 0
                    self._count[c] = 0
                    self._blocks[c] = []
                    self._msg_id[c] = make_event_id(
                        "PowActChan", c, int(self._finished[c])
                    )
                    self._blocks[c].append(rows[row, b])  # hist, phase 0
                    self._blocks[c].append(
                        rows[row, b + 1] * self.rot[phase_used[c, b]]
                    )
                    self._count[c] += 2
                elif processed[c, b]:
                    self._blocks[c].append(
                        rows[row, b + 1] * self.rot[phase_used[c, b]]
                    )
                    self._count[c] += 1

                if fall[c, b]:
                    ev = self._emit(c, True, blockcount)
                    if self.msg_output:
                        events.append(ev)
                    self._finished[c] += 1
                elif (
                    processed[c, b]
                    and not rise[c, b]
                    and (
                        mb == 0
                        or (mb > 0 and self._count[c] % mb == 0)
                    )
                ):
                    # partial emission while active
                    # (reference: lib/PowerActivationChannel_impl.cc:159-166)
                    ev = self._emit(c, False, blockcount)
                    if self.msg_output:
                        events.append(ev)

        return events


class SegmentDetectionEmitter:
    """Burst assembly + emission + slot recycling for a SegmentDetector."""

    def __init__(
        self,
        detector,
        maxblocks: int,
        file_sink: Optional[FileSink] = None,
        msg_output: bool = True,
        log=None,
    ):
        self.det = detector
        self.maxblocks = int(maxblocks)
        self.file_sink = file_sink
        self.msg_output = msg_output
        self.log_fn = log  # lifecycle logger (None = disabled)
        # vcm emission conventions: blockcount starts at 1 and maxblocks
        # partial emission happens INLINE per channel rather than in a
        # post-loop sweep (reference:
        # lib/activity_detection_channelizer_vcm_impl.cc:188,305-321)
        self.vcm = bool(getattr(detector, "vcm", False))
        self.rot = _phase_rot_table(detector.relinvovl)

        s = detector.max_slots
        self._data = [[] for _ in range(s)]
        self._count = np.zeros(s, np.int64)
        self._part = np.zeros(s, np.int64)
        self._msg_id = [""] * s
        # cached geometry per slot (filled at activation)
        self._es = np.zeros(s, np.int64)
        self._ee = np.zeros(s, np.int64)
        self._w = np.zeros(s, np.int64)
        self._live = np.zeros(s, bool)
        # blocks whose samples were beyond the extraction budget (zeroed)
        self.lost_rows = 0
        # device-reported needy-slots-beyond-budget count (step granularity)
        self.overflow_slots = 0

    def get_state(self) -> dict:
        """Host-side slot state for checkpointing (fdc_tpu.runtime.checkpoint)."""
        return {
            "data": [[b.copy() for b in sl] for sl in self._data],
            "count": self._count.copy(),
            "part": self._part.copy(),
            "msg_id": list(self._msg_id),
            "es": self._es.copy(),
            "ee": self._ee.copy(),
            "w": self._w.copy(),
            "live": self._live.copy(),
        }

    def set_state(self, st: dict):
        if "native_blob" in st:  # legacy native-emitter checkpoint
            units = _parse_native_blob(
                st["native_blob"], self.det.max_slots
            )
            st = {
                "data": [u["blocks"] for u in units],
                "count": [u["count"] for u in units],
                "part": [u["part"] for u in units],
                "msg_id": [u["msg_id"] for u in units],
                "es": [u["es"] for u in units],
                "ee": [u["ee"] for u in units],
                "w": [u["w"] for u in units],
                "live": [u["live"] for u in units],
            }
        self._data = [[np.asarray(b) for b in sl] for sl in st["data"]]
        self._count = np.asarray(st["count"]).copy()
        self._part = np.asarray(st["part"]).copy()
        self._msg_id = list(st["msg_id"])
        self._es = np.asarray(st["es"]).copy()
        self._ee = np.asarray(st["ee"]).copy()
        self._w = np.asarray(st["w"]).copy()
        self._live = np.asarray(st["live"]).copy()

    def _emit(self, s: int, fin: bool, blockcount: int, ntx: int) -> ChannelEvent:
        n = self.det.blocksize
        chunk = self._data[s][:ntx] if ntx else []
        self._data[s] = self._data[s][ntx:]
        # msgoutput=False skips sample assembly (the reference gates PDU
        # construction on the flag, lib/SegmentDetection_impl.cc:446-460);
        # slot state updates and file output are unaffected.
        want_data = self.msg_output or self.file_sink is not None
        data = (
            np.concatenate(chunk)
            if (want_data and chunk)
            else np.zeros(0, np.complex64)
        )
        part = int(self._part[s])
        ev = ChannelEvent(
            ID=self._msg_id[s],
            finalized=fin,
            # fin events carry `part` only if partial emissions happened
            # (reference: lib/SegmentDetection_impl.cc:450-451,506)
            part=(part if (not fin or part > 0) else None),
            rel_bw=float(self._w[s]) / n,
            rel_cfreq=(self._es[s] + self._ee[s]) / 2.0 / n,
            blockstart=int(blockcount - self._count[s]),
            blockend=int(blockcount),
            vectorstart=int(self._es[s]),
            vectorend=int(self._ee[s]),
            data=data,
        )
        if self.file_sink is not None:
            self.file_sink.write(ev)
        _log_seg_emission(self.log_fn, ev)
        if not fin:
            self._part[s] += 1
        return ev

    def process_step(self, outputs, slot_meta, t0: int):
        """Replay B blocks; returns the events in emission order.

        outputs: numpy-converted outputs of SegmentDetector.step;
        slot_meta: its {ext_start, wlog2, order} snapshot (the device carry
        itself never reaches the host — slot recycling happens on device at
        step end, SegmentDetector._free_tombstones).
        """
        activated = np.asarray(outputs["activated"])
        processed = np.asarray(outputs["processed"])
        emit = np.asarray(outputs["emit"])
        phase_used = np.asarray(outputs["phase_used"])
        extract = np.asarray(outputs["extract"])  # [E, B+1, w_cap]

        ext_start = np.asarray(slot_meta["ext_start"])
        wlog2 = np.asarray(slot_meta["wlog2"])
        order = np.asarray(slot_meta["order"])

        self.overflow_slots = _surface_overflow(
            outputs, self.overflow_slots, self.log_fn
        )

        # split-cut reconciliation (SegmentDetector.reconcile_split):
        # slots killed as cross-part duplicates at BATCH ENTRY — discard
        # their buffered burst silently (the twin slot in the adjacent
        # part holds the data); they carry no flags this step.
        killed = outputs.get("killed")
        if killed is not None:
            for s_k in np.flatnonzero(np.asarray(killed)):
                if self._live[s_k]:
                    if self.log_fn is not None:
                        self.log_fn(
                            f"{self._msg_id[s_k]} killed (cut duplicate)"
                        )
                    self._live[s_k] = False
                    self._data[s_k] = []
                    self._count[s_k] = 0
                    self._part[s_k] = 0
                    self._msg_id[s_k] = ""

        # extraction rows are compacted: row_of[slot] -> extract row, or -1
        # if the slot's samples were beyond the extraction budget this step
        # (outputs["ext_overflow"] counts them; data is replaced by zeros).
        # Sentinel plan entries (== max_slots) mark unused rows.
        s_cap = activated.shape[0]

        def build_row_of(ids):
            ids = np.asarray(ids)
            ro = np.full(s_cap, -1, np.int64)
            valid = ids < s_cap
            ro[ids[valid]] = np.flatnonzero(valid)
            return ro

        if "slot_ids" in outputs:
            row_of = build_row_of(outputs["slot_ids"])
        else:
            row_of = np.arange(s_cap)
        # optional second, narrower bucket (extract_width_split)
        extract_n = outputs.get("extract_narrow")
        if extract_n is not None:
            extract_n = np.asarray(extract_n)
            l_cap_n = extract_n.shape[-1]
            row_of_n = build_row_of(outputs["slot_ids_narrow"])
        else:
            row_of_n = None

        # The reference iterates channels in ACTIVATION order (its channel
        # deque is append-ordered, lib/SegmentDetection_impl.cc:346-365);
        # after slot recycling a newer channel can occupy a lower slot index,
        # so every per-block loop below walks slots sorted by their
        # occupant's activation sequence number. Slots are never recycled
        # within a step, so state["order"] is authoritative for the step.
        slot_rank = np.argsort(order, kind="stable").astype(np.int64)

        s_total, nb = activated.shape
        r = self.det.relinvovl
        events: List[ChannelEvent] = []
        mb = self.maxblocks
        l_cap = extract.shape[-1]

        def take_row(s, b_row, w, gain=None):
            """Decode one block from the interpolated extraction row: sample
            at stride q = cap//w and apply the fftshift sign compensation
            (-1)^m (see fdc_tpu.ops.fft.interp_subband_ifft). The slot's
            row lives in the wide bucket, the narrow bucket, or nowhere
            (beyond budget: zeros + lost counter)."""
            ovl = w // r
            rr = row_of[s]
            src, cap = extract, l_cap
            if rr < 0 and row_of_n is not None:
                rr = row_of_n[s]
                src, cap = extract_n, l_cap_n
            if rr < 0:  # beyond the extraction budget: samples lost
                self.lost_rows += 1
                return np.zeros(w - ovl, np.complex64)
            q = cap // w
            row = src[rr, b_row, ovl * q:: q][: w - ovl]
            signs = 1.0 - 2.0 * ((np.arange(ovl, w) & 1).astype(np.float32))
            out = row * signs
            if gain is not None:
                out = out * gain
            return out

        def do_activate(s, b):
            w = 1 << int(wlog2[s])
            self._live[s] = True
            self._data[s] = []
            self._count[s] = 0
            self._part[s] = 0
            self._es[s] = int(ext_start[s])
            self._ee[s] = int(ext_start[s]) + w
            self._w[s] = w
            self._msg_id[s] = make_event_id(
                "DETECTED", self.det.segment_id, int(order[s])
            )
            # hist block (phase 0) then current block
            # (reference: lib/SegmentDetection_impl.cc:431-435)
            self._data[s].append(take_row(s, b, w))
            self._data[s].append(
                take_row(s, b + 1, w, self.rot[phase_used[s, b]])
            )
            self._count[s] += 2

        def do_process(s, b):
            w = int(self._w[s])
            self._data[s].append(
                take_row(s, b + 1, w, self.rot[phase_used[s, b]])
            )
            self._count[s] += 1

        if self.vcm:
            # vcm: blockcount starts at 1; one unified walk in activation
            # order with the maxblocks partial emission INLINE per channel
            # (reference: lib/activity_detection_channelizer_vcm_impl.cc:
            # 305-321,544-570)
            touched = activated | processed | emit
            for b in range(nb):
                blockcount = t0 + b + 1
                for s in slot_rank[touched[slot_rank, b]]:
                    if activated[s, b]:
                        do_activate(s, b)
                    elif emit[s, b]:
                        ev = self._emit(s, True, blockcount,
                                        len(self._data[s]))
                        if self.msg_output:
                            events.append(ev)
                        self._live[s] = False
                    elif processed[s, b]:
                        do_process(s, b)
                    if (mb >= 0 and self._live[s]
                            and len(self._data[s]) >= mb):
                        ntx = len(self._data[s]) if mb == 0 else mb
                        if ntx > 0:
                            ev = self._emit(s, False, blockcount, ntx)
                            if self.msg_output:
                                events.append(ev)
            return events

        for b in range(nb):
            blockcount = t0 + b  # SegmentDetection convention
            for s in slot_rank[activated[slot_rank, b]]:
                do_activate(s, b)

            for s in slot_rank[(processed & ~activated)[slot_rank, b]]:
                do_process(s, b)

            for s in slot_rank[emit[slot_rank, b]]:
                ev = self._emit(s, True, blockcount, len(self._data[s]))
                if self.msg_output:
                    events.append(ev)
                self._live[s] = False

            # maxblocks partial emission after all per-block work
            # (reference: lib/SegmentDetection_impl.cc:359-362)
            if mb >= 0:
                for s in slot_rank[self._live[slot_rank]]:
                    if len(self._data[s]) >= mb:
                        ntx = len(self._data[s]) if mb == 0 else mb
                        if ntx > 0:
                            ev = self._emit(s, False, blockcount, ntx)
                            if self.msg_output:
                                events.append(ev)

        return events


# ---------------------------------------------------------------------------
# Native (C++) fast-path emitters — drop-in replacements backed by
# fdc_tpu/runtime/native/emission.cc. The Python classes above are the
# reference implementation; these replay identical logic without the
# per-(block x channel) Python loop (the host bottleneck at pod scale).
# ---------------------------------------------------------------------------


def _native():
    from fdc_tpu_torch.runtime import native

    return native


class NativePowerActivationEmitter:
    """C++-backed PowerActivationEmitter (same interface and events)."""

    def __init__(self, bank, maxblocks, file_sink=None, msg_output=True,
                 channel_logs=None):
        native = _native()
        self.bank = bank
        self.file_sink = file_sink
        self.msg_output = msg_output
        self.channel_logs = channel_logs
        self.engine = native.EmissionEngine(
            native.EmissionEngine.MODE_PA,
            bank.num_channels,
            bank.relinvovl,
            bank.blocksize,
            int(maxblocks),
        )
        self.engine.set_want_data(msg_output or file_sink is not None)
        self._loc = {}
        self.out_cap = 0
        for bucket in bank.buckets:
            for row, chan in enumerate(bucket.channel_ids):
                self._loc[chan] = (bucket.width, row, bucket.out_len)
            self.out_cap = max(self.out_cap, bucket.out_len)
        for c, g in enumerate(bank.geometry):
            self.engine.pa_set_channel(
                c,
                self._loc[c][2],
                (g.extract_start + g.extract_stop) / 2.0 / bank.blocksize,
                g.extract_width / bank.blocksize,
            )

    def _flatten_extract(self, ext: dict) -> np.ndarray:
        some = next(iter(ext.values()))
        rows = some.shape[1]
        out = np.zeros(
            (self.bank.num_channels, rows, self.out_cap), np.complex64
        )
        for c, (width, row, out_len) in self._loc.items():
            out[c, :, :out_len] = ext[width][row]
        return out

    def process_step(self, outputs, t0: int) -> List[ChannelEvent]:
        ext = {w: np.asarray(v) for w, v in outputs["extract"].items()}
        prefix = f"{current_timestamp()}.PowActChan".encode()
        raw = self.engine.pa_step(
            np.asarray(outputs["rise"]),
            np.asarray(outputs["fall"]),
            np.asarray(outputs["processed"]),
            np.asarray(outputs["phase_used"]),
            self._flatten_extract(ext),
            prefix,
            int(t0),
        )
        events = []
        for ev in raw:
            ce = ChannelEvent(
                ID=ev.ID,
                finalized=ev.finalized,
                part=ev.part,
                rel_cfreq=ev.rel_cfreq,
                rel_bw=ev.rel_bw,
                blockstart=ev.blockstart,
                blockend=ev.blockend,
                data=ev.data,
            )
            if self.file_sink is not None:
                bare = ChannelEvent(**{**ce.__dict__,
                                       "ID": ce.ID.rsplit(".", 1)[0]})
                self.file_sink.write(bare)
            if self.channel_logs is not None:
                # ID convention: <ts>.PowActChan.<chan>.<count>.<suffix>
                c = int(ce.ID.split(".")[-3])
                g = self.bank.geometry[c]
                _log_pa_emission(
                    self.channel_logs[c], ce,
                    g.extract_start, g.extract_stop,
                )
            if self.msg_output:
                events.append(ce)
        return events

    def get_state(self) -> dict:
        """Backend-portable state: the SAME schema as
        :class:`PowerActivationEmitter` (a native-saved checkpoint
        restores into the Python emitter and vice versa)."""
        units = _parse_native_blob(
            self.engine.save_state(), self.bank.num_channels
        )
        return {
            "blocks": [u["blocks"] for u in units],
            "count": np.asarray([u["count"] for u in units], np.int64),
            "part": np.asarray([u["part"] for u in units], np.int64),
            "msg_id": [u["msg_id"] for u in units],
            "finished": np.asarray([u["fin"] for u in units], np.int64),
        }

    def set_state(self, st: dict):
        if "native_blob" in st:  # legacy pre-portability checkpoint
            self.engine.load_state(st["native_blob"])
            return
        count = np.asarray(st["count"])
        part = np.asarray(st["part"])
        fin = np.asarray(st["finished"])
        units = [
            # es/ee/w/live are unused by the engine's pa mode
            dict(count=count[c], part=part[c], es=0, ee=0, w=0,
                 live=False, fin=fin[c], msg_id=st["msg_id"][c],
                 blocks=st["blocks"][c])
            for c in range(self.bank.num_channels)
        ]
        self.engine.load_state(_build_native_blob(units))


class NativeSegmentDetectionEmitter:
    """C++-backed SegmentDetectionEmitter (same interface and events)."""

    def __init__(self, detector, maxblocks, file_sink=None, msg_output=True,
                 log=None):
        native = _native()
        self.det = detector
        self.file_sink = file_sink
        self.msg_output = msg_output
        self.log_fn = log
        mode = (
            native.EmissionEngine.MODE_SEG_VCM
            if getattr(detector, "vcm", False)
            else native.EmissionEngine.MODE_SEG
        )
        self.engine = native.EmissionEngine(
            mode,
            detector.max_slots,
            detector.relinvovl,
            detector.blocksize,
            int(maxblocks),
        )
        self.engine.set_want_data(msg_output or file_sink is not None)
        self.overflow_slots = 0

    def process_step(self, outputs, slot_meta, t0: int):
        order = np.asarray(slot_meta["order"])
        self.overflow_slots = _surface_overflow(
            outputs, self.overflow_slots, self.log_fn
        )
        # split-cut duplicate kills (see the Python emitter for the
        # contract); the engine resets the unit without emitting
        killed = outputs.get("killed")
        if killed is not None:
            for s_k in np.flatnonzero(np.asarray(killed)):
                self.engine.kill_unit(int(s_k))
        ts = current_timestamp()
        ids = b"".join(
            make_event_id(
                "DETECTED", self.det.segment_id, int(order[s]), ts
            ).encode() + b"\0"
            for s in range(self.det.max_slots)
        )
        raw = self.engine.seg_step(
            np.asarray(outputs["activated"]),
            np.asarray(outputs["processed"]),
            np.asarray(outputs["emit"]),
            np.asarray(outputs["phase_used"]),
            np.asarray(outputs["extract"]),
            np.asarray(slot_meta["ext_start"]),
            np.asarray(slot_meta["wlog2"]),
            order,
            ids,
            int(t0),
            slot_ids=(
                np.asarray(outputs["slot_ids"])
                if "slot_ids" in outputs else None
            ),
            extract_narrow=(
                np.asarray(outputs["extract_narrow"])
                if "extract_narrow" in outputs else None
            ),
            slot_ids_narrow=(
                np.asarray(outputs["slot_ids_narrow"])
                if "slot_ids_narrow" in outputs else None
            ),
        )
        events = []
        for ev in raw:
            ce = ChannelEvent(
                ID=ev.ID,
                finalized=ev.finalized,
                part=ev.part,
                rel_cfreq=ev.rel_cfreq,
                rel_bw=ev.rel_bw,
                blockstart=ev.blockstart,
                blockend=ev.blockend,
                vectorstart=ev.vectorstart,
                vectorend=ev.vectorend,
                data=ev.data,
            )
            if self.file_sink is not None:
                self.file_sink.write(ce)
            _log_seg_emission(self.log_fn, ce)
            if self.msg_output:
                events.append(ce)
        return events

    @property
    def lost_rows(self) -> int:
        """Blocks whose samples were beyond the extraction budget."""
        return self.engine.lost_rows

    def get_state(self) -> dict:
        """Backend-portable state: the SAME schema as
        :class:`SegmentDetectionEmitter` (a native-saved checkpoint
        restores into the Python emitter and vice versa)."""
        units = _parse_native_blob(
            self.engine.save_state(), self.det.max_slots
        )
        return {
            "data": [u["blocks"] for u in units],
            "count": np.asarray([u["count"] for u in units], np.int64),
            "part": np.asarray([u["part"] for u in units], np.int64),
            "msg_id": [u["msg_id"] for u in units],
            "es": np.asarray([u["es"] for u in units], np.int64),
            "ee": np.asarray([u["ee"] for u in units], np.int64),
            "w": np.asarray([u["w"] for u in units], np.int64),
            "live": np.asarray([u["live"] for u in units], bool),
        }

    def set_state(self, st: dict):
        if "native_blob" in st:  # legacy pre-portability checkpoint
            self.engine.load_state(st["native_blob"])
            return
        count = np.asarray(st["count"])
        part = np.asarray(st["part"])
        es, ee = np.asarray(st["es"]), np.asarray(st["ee"])
        w, live = np.asarray(st["w"]), np.asarray(st["live"])
        units = [
            # fin (pa_finished) is unused by the engine's seg modes
            dict(count=count[s], part=part[s], es=es[s], ee=ee[s],
                 w=w[s], live=bool(live[s]), fin=0,
                 msg_id=st["msg_id"][s], blocks=st["data"][s])
            for s in range(self.det.max_slots)
        ]
        self.engine.load_state(_build_native_blob(units))
