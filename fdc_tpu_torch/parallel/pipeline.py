"""Pipeline-parallel channelizer: batches farm over lanes, scans run ahead.

Port of ``fdc_tpu.parallel.pipeline``. The step splits at its true
dependencies into three stages:

- **stage A (worker lane w, batch b)**: framing and the forward FFT over
  B + 1 blocks (the leading block recomputes the previous batch's last
  spectrum row from the host-fed sample tail, which removes the only
  cross-batch device dependency), every flag-independent extraction
  (throughput and burst channels), the detection power measures and the
  candidate packs (kernels F, A, E and B). Independent across batches.
- **stage B (the scan owner, in batch order)**: the burst hysteresis and
  slot lifecycle chains and the extraction plans on the KB-scale powers
  and packs (kernel C, or D without segments). The only serial stage.
- **stage C (worker lane w)**: the detection-slot extraction on the
  worker's spectrum, given the owner's slot tables and plans.

A lane is one entry of ``devices`` (``parallel.lanes``): entries may
repeat, and on CUDA each lane has a ``torch.cuda.Stream`` of its own, so
several lanes on one card run as concurrent streams. ``devices[0]`` owns
the scan chain (the carry); every lane extracts in round-robin batch
order, or with ``dedicated_owner=True`` the leading ``max(1,
scan_owners)`` lanes are reserved as the owner pool and only the others
extract. With ``scan_owners > 1`` on a multi-segment config the
segments' scan chains spread round-robin over the leading lanes (the
burst chain rides lane 0).

With ``shard_time > 1`` (the pipeline x SPMD composition) each worker is
a group of ``shard_time`` consecutive worker lanes: the group's lane t
runs stages A and C on blocks [t*b, (t+1)*b) of the batch, b = B /
shard_time, framed from its own host-fed run of samples (one leading
block recomputes the previous run's last spectrum row), so the time runs
need no hand-off between lanes. Their powers and packs are joined on the
scan lane; the duplicated reach-back rows of the row-family outputs are
dropped on the host when the batch is consumed.

Ordering: the host enqueues A, B and C of each batch on their lanes'
streams, with the hand-offs of ``parallel.lanes``. A batch's outputs are
read on the host only after the event each of its worker lanes records at
the end of stage C, which follows every stage it waited for. The host
keeps up to ``window`` batches in flight and consumes them in order, so
it never blocks on the newest batch.

Results equal :class:`FrequencyDomainChannelizer`'s: stage A recomputes
the same spectra (on the card the reach-back row is kernel F's [1, N]
call, bit-equal to row B of the previous batch's [B, N] call), stage B
runs the same scans on the same powers, stage C the same slot
extraction.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from fdc_tpu_torch.config import ChannelizerConfig
from fdc_tpu_torch.models.channelizer import (
    FrequencyDomainChannelizer,
    _pairs_to_complex,
)
from fdc_tpu_torch.ops.fft import forward_spectrum
from fdc_tpu_torch.ops.framing import frame_blocks
from fdc_tpu_torch.parallel.lanes import Lanes, lane_devices, merge_rows

__all__ = ["PipelineChannelizer", "lane_devices"]


def _complex_to_pairs(z: np.ndarray) -> np.ndarray:
    """complex64 [...] -> float32 [..., 2] pairs."""
    z = np.ascontiguousarray(z, np.complex64)
    return z.view(np.float32).reshape(*z.shape, 2)


def _host(t):
    return t if isinstance(t, np.ndarray) else t.cpu().numpy()


class PipelineChannelizer(Lanes, FrequencyDomainChannelizer):
    """FrequencyDomainChannelizer whose batches pipeline over lanes.

    Usage::

        fdc = PipelineChannelizer(config, devices=["cuda:0"] * 3,
                                  dedicated_owner=True)
        result = fdc.process(samples)   # the plain channelizer's results

    ``devices`` defaults to every CUDA device; tests pass ``["cpu"] * n``
    (the kernels' plain versions). With one lane this is the plain step's
    work split over three stages (same results).

    ``process_spectra`` (the pre-FFT'd vector mode) pipelines the same
    way: there is no framing tail to recompute the reach-back row from,
    and none is needed, since the host holds the input spectra; each
    batch ships with the previous batch's last spectrum row prepended.
    """

    # its stages run on several lanes and its outputs are consumed a batch
    # or two late, past the next replay of a compiled step: they stay
    # eager (JAX: parallel/pipeline.py:258-261 jits each stage)
    compile_step = False

    def __init__(self, config: Optional[ChannelizerConfig] = None,
                 devices: Optional[List] = None, window: int = 0,
                 dedicated_owner: bool = False, shard_time: int = 1,
                 scan_owners: int = 1, **kwargs):
        self.shard_time = int(shard_time)
        if self.shard_time < 1:
            raise ValueError("shard_time must be >= 1")
        devs = lane_devices(devices)
        super().__init__(config, device=devs[0], **kwargs)
        self._init_lanes(devs)
        # with a dedicated owner the scan lanes do no extraction: the
        # leading max(1, scan_owners) lanes are the owner pool (JAX:
        # parallel/pipeline.py:94-118)
        n = len(devs)
        scan_owners = max(1, int(scan_owners))
        reserved = (min(scan_owners, max(1, n - 1))
                    if dedicated_owner and n > 1 else 0)
        self.worker_lanes = list(range(reserved, n))
        self.workers = [devs[lane] for lane in self.worker_lanes]
        # each worker a group of shard_time consecutive worker lanes
        # (JAX: parallel/pipeline.py:119-178)
        tn = self.shard_time
        n_groups = len(self.worker_lanes) // tn
        if tn > 1 and n_groups < 1:
            raise ValueError(
                f"shard_time={tn} needs at least that many worker "
                f"devices, have {len(self.worker_lanes)}"
            )
        self.groups = [self.worker_lanes[g * tn:(g + 1) * tn]
                       for g in range(n_groups)]
        cfg = self.config
        if tn > 1:
            if cfg.batch_blocks % tn:
                raise ValueError(
                    f"batch_blocks={cfg.batch_blocks} must be divisible "
                    f"by shard_time={tn}"
                )
            self.b_local = cfg.batch_blocks // tn
            if (cfg.batch_blocks % cfg.relinvovl == 0
                    and self.b_local % cfg.relinvovl):
                # the static phase-fold contract needs every run's first
                # global block index == 0 (mod R)
                raise ValueError(
                    f"b_local={self.b_local} must be a multiple of "
                    f"relinvovl={cfg.relinvovl} (phase-fold contract)"
                )
        # bound on dispatched-but-unconsumed batches (device memory holds
        # one spec_ext + extraction set per in-flight batch)
        self.window = int(window) or 2 * len(self.groups)
        # multi-owner scans: segment groups round-robin over the leading
        # lanes, the burst chain with group 0; each segment's carry lives
        # on its group's lane
        if scan_owners > 1:
            self._set_owner_groups(
                list(range(min(scan_owners, len(self.segments), n))))

        # host rolling tail: the inplen + ovllen samples before the next
        # batch (ovllen of framing history for the recomputed leading
        # block plus that block's inplen samples: the last block)
        self._tail = np.zeros(cfg.inplen + cfg.ovllen, np.complex64)
        # one-shot reach-back row for a resume from a plain checkpoint
        self._ov_row = np.zeros((cfg.blocksize, 2), np.float32)
        self._ov_flag = False
        # vector mode: the previous batch's last spectrum row (float
        # pairs), prepended to the next batch
        self._prev_specf = np.zeros((cfg.blocksize, 2), np.float32)

    def reset(self):
        super().reset()
        cfg = self.config
        self._tail = np.zeros(cfg.inplen + cfg.ovllen, np.complex64)
        self._ov_row = np.zeros((cfg.blocksize, 2), np.float32)
        self._ov_flag = False
        self._prev_specf = np.zeros((cfg.blocksize, 2), np.float32)

    def _batch_done(self, lanes):
        """An event a worker lane after every stage of its batch: the lane
        waits for the owner lanes (their flags and tables), then records.
        None on CPU lanes."""
        events = []
        for lane in lanes:
            s = self._streams[lane]
            if s is None:
                continue
            for owner in {0, *self._seg_lane}:
                o = self._streams[owner]
                if o is not None and o is not s:
                    s.wait_stream(o)
            ev = torch.cuda.Event()
            ev.record(s)
            events.append(ev)
        return events or None

    # -- stages -------------------------------------------------------------------

    def _frame_front(self, lane, tail, chunk, lo, n_blocks, ov_row):
        """Framing and kernel F on ``lane``: the n_blocks + 1 blocks whose
        samples start at ``lo`` on the line ``tail`` + ``chunk`` (the
        first block, the reach-back block, is the one before the run),
        both parts copied straight into one buffer; kernel F writes the
        reach-back row (or the resume override ``ov_row``, [N, 2] pairs)
        and the body into one spec_ext."""
        cfg = self.config
        dev = self.devices[lane]
        n = cfg.ovllen + (n_blocks + 1) * cfg.inplen
        k = min(max(len(tail) - lo, 0), n)  # samples from the tail
        c0 = lo + k - len(tail)
        with self._on(lane):
            x = torch.empty(n, dtype=torch.complex64, device=dev)
            if k:
                x[:k].copy_(torch.from_numpy(tail[lo:lo + k]))
            if n > k:
                x[k:].copy_(torch.from_numpy(chunk[c0:c0 + n - k]))
            blocks, _ = frame_blocks(x[cfg.ovllen:], x[:cfg.ovllen],
                                     cfg.blocksize)
            spec_ext = torch.empty(blocks.shape, dtype=torch.complex64,
                                   device=dev)
            if ov_row is None:
                forward_spectrum(blocks[:1], use_mxu=cfg.use_mxu_fft,
                                 out=spec_ext[:1])
            else:
                spec_ext[0] = torch.from_numpy(
                    _pairs_to_complex(ov_row)).to(dev)
            forward_spectrum(blocks[1:], use_mxu=cfg.use_mxu_fft,
                             out=spec_ext[1:])
        return spec_ext

    def _pipe_front(self, lane, chunk, t0, ov_row=None):
        """Stage A on ``lane`` from host samples: the tail and ``chunk``
        frame B + 1 blocks (:meth:`_frame_front`), and the tail moves
        past ``chunk``."""
        tail = self._tail
        self._advance_tail(chunk)
        spec_ext = self._frame_front(lane, tail, chunk, 0,
                                     self.config.batch_blocks, ov_row)
        return self._pipe_static(lane, spec_ext, t0)

    def _pipe_front_group(self, lanes, chunk, t0, ov_row=None):
        """Stage A over a group's lanes: lane t frames blocks [t*b - 1,
        (t+1)*b) of the batch from its own run of the sample line (JAX's
        ``_shard_inputs``) and extracts at its global block offset; only
        the first run takes the resume override. One stage A tuple a
        lane."""
        cfg = self.config
        tail = self._tail
        self._advance_tail(chunk)
        bl = self.b_local
        return [self._pipe_static(
            lane,
            self._frame_front(lane, tail, chunk, t * bl * cfg.inplen, bl,
                              ov_row if t == 0 else None),
            t0 + t * bl) for t, lane in enumerate(lanes)]

    def _pipe_front_spec(self, lane, spec_ext_host, t0):
        """Stage A in vector mode: the host's [B + 1, N] spectra, row 0
        the previous batch's last row."""
        with self._on(lane):
            spec_ext = torch.from_numpy(spec_ext_host).to(self.devices[lane])
        return self._pipe_static(lane, spec_ext, t0)

    def _pipe_static(self, lane, spec_ext, t0):
        rep = self._replicas[self.devices[lane]]
        with self._on(lane):
            spec = spec_ext[1:]
            out, pa_powers, pa_ext, seg_powers, seg_packed = (
                rep._extract_static(spec, spec_ext, t0))
            dbg = torch.view_as_real(spec) if self.config.debug else None
        return out, pa_powers, pa_ext, seg_powers, seg_packed, spec_ext, dbg

    def _pipe_scan_extract(self, lane, pa_powers, seg_packed, spec_ext):
        """Stages B and C for one batch: the owner lanes' scans, then the
        slot extraction back on the batch's worker lane under the owners'
        tables and plans. Returns (scans, extracts, the batch's done
        events or None)."""
        self._carry, scans = self._scan(self._carry, lane, pa_powers,
                                        seg_packed)
        return scans, self._pipe_slots(lane, spec_ext, scans), (
            self._batch_done([lane]))

    def _pipe_slots(self, lane, spec_ext, scans):
        """Stage C on ``lane``: every segment's planned slots over
        ``spec_ext``."""
        states, plans = [], []
        for i, (st, so) in enumerate(scans["segs"]):
            plan = {k: so[k] for k in ("slot_ids", "slot_ids_narrow")
                    if k in so}
            st, plan = self._handoff((st, plan), self._seg_lane[i], lane)
            states.append(st)
            plans.append(plan)
        rep = self._replicas[self.devices[lane]]
        with self._on(lane):
            return rep._extract_slots_all(spec_ext, states, plans)

    def _pipe_group(self, lanes, fronts, t0):
        """Stages B and C for a group's batch (``fronts``: each lane's
        stage A): the runs' powers and packs joined on the scan lane in
        kernel C's layout, the scans, each lane's slot extraction. Returns
        the in-flight entry; its per-lane row families are merged on the
        host when the batch is consumed."""
        parts = list(zip(lanes, fronts))
        pa_powers = (self._gather_rows([(ln, f[1]) for ln, f in parts], 0)
                     if self.power_bank else None)
        seg_packed = (self._gather_packs([(ln, f[4]) for ln, f in parts], 0)
                      if len(self.segments) else [])
        self._carry, scans = self._scan(self._carry, 0, pa_powers,
                                        seg_packed)
        extracts = [self._pipe_slots(ln, f[5], scans) for ln, f in parts]
        return ([f[0] for f in fronts], [f[2] for f in fronts],
                [f[3] for f in fronts], [f[6] for f in fronts], scans,
                extracts, t0, self._batch_done(lanes))

    def _join_group(self, parts):
        """A group batch's per-lane stage outputs joined on the host into
        the plain step's layout: streams and powers concatenated over the
        runs, row families with the runs' duplicated reach-back rows
        dropped (JAX: parallel/pipeline.py:437-446,700-720)."""
        outs, pa_exts, seg_powers, dbgs, scans, extracts, t0_b, done = parts
        out = {}
        if self.throughput:
            out["throughput_buckets"] = [
                np.concatenate([_host(o["throughput_buckets"][k])
                                for o in outs], axis=1)
                for k in range(len(self.throughput.buckets))]
        pa_ext = None
        if self.power_bank:
            pa_ext = {w: merge_rows([_host(p[w]) for p in pa_exts])
                      for w in pa_exts[0]}
        seg_p = [np.concatenate([_host(p[i]) for p in seg_powers])
                 for i in range(len(self.segments))]
        dbg = (np.concatenate([_host(d) for d in dbgs])
               if self.config.debug else None)
        ext = [{k: merge_rows([_host(e[i][k]) for e in extracts])
                for k in extracts[0][i]} for i in range(len(self.segments))]
        return out, pa_ext, seg_p, dbg, scans, ext, t0_b, done

    def _consume_pipeline_batch(self, batch_parts, result, dbg):
        """Join one in-flight batch's stage outputs into the plain step's
        ``out`` and fold it into the result, once its done events have
        fired (deferred, so the host never blocks the pipeline)."""
        done = batch_parts[-1]
        for ev in done or ():
            ev.synchronize()
        if isinstance(batch_parts[0], list):
            batch_parts = self._join_group(batch_parts)
        (out_static, pa_ext, seg_powers, dbgb, scans, extracts, t0_b,
         _) = batch_parts
        out = dict(out_static)
        self._assemble_detections(out, scans, extracts, pa_ext, seg_powers)
        if self.config.debug:
            out["debug_spectrum"] = dbgb
        self._consume_outputs(out, result, dbg, t0=t0_b)
        result.blocks_processed += self.config.batch_blocks

    def _advance_tail(self, chunk):
        """The tail after ``chunk``: its last inplen + ovllen samples."""
        n = len(self._tail)
        self._tail = (chunk[-n:].copy() if len(chunk) >= n
                      else np.concatenate([self._tail, chunk])[-n:])

    def _take_override(self):
        """The resume override row for the next batch, once."""
        row = self._ov_row if self._ov_flag else None
        self._ov_flag = False
        return row

    # -- pipelined streaming ------------------------------------------------------

    def _dispatch(self, b, front, front_group):
        """Stages A, B and C of the call's batch number ``b`` on its
        worker lane or group (``front(b, lane, t0)`` and
        ``front_group(b, lanes, t0)`` its stage A); the in-flight
        entry."""
        t0 = self._t0
        if self.shard_time > 1:
            lanes = self.groups[b % len(self.groups)]
            return self._pipe_group(lanes, front_group(b, lanes, t0), t0)
        lane = self.worker_lanes[b % len(self.worker_lanes)]
        (out_static, pa_powers, pa_ext, seg_powers, seg_packed, spec_ext,
         dbgb) = front(b, lane, t0)
        scans, extracts, done = self._pipe_scan_extract(
            lane, pa_powers, seg_packed, spec_ext)
        return (out_static, pa_ext, seg_powers, dbgb, scans, extracts, t0,
                done)

    def _run_batches(self, n_batches, front, front_group):
        """Dispatch ``n_batches`` batches, keeping up to ``window`` in
        flight, and consume them in order."""
        result = self._new_result()
        dbg = []
        inflight = []
        for b in range(n_batches):
            inflight.append(self._dispatch(b, front, front_group))
            self._t0 += self.config.batch_blocks
            if len(inflight) >= self.window:
                self._consume_pipeline_batch(inflight.pop(0), result, dbg)
        while inflight:
            self._consume_pipeline_batch(inflight.pop(0), result, dbg)
        if dbg:
            result.debug_spectrum = np.concatenate(dbg)
        return result

    def process(self, samples: np.ndarray):
        if self._spectra_mode:
            # one entry point per stream: the host framing state (_tail
            # vs _prev_specf) is per mode, and a mixed-mode checkpoint
            # would sync the wrong one into the carry
            raise RuntimeError(
                "process() called on a stream already driven by "
                "process_spectra(); use one entry point per stream "
                "(reset() starts a new one)"
            )
        self._samples_mode = True
        self._adopt_carry()
        x = np.concatenate([self._pending,
                            np.asarray(samples, np.complex64)])
        bs = self.batch_samples
        n_batches = len(x) // bs
        self._pending = x[n_batches * bs:]

        def chunk(b):
            return x[b * bs:(b + 1) * bs]

        return self._run_batches(
            n_batches,
            lambda b, lane, t0: self._pipe_front(
                lane, chunk(b), t0, self._take_override()),
            lambda b, lanes, t0: self._pipe_front_group(
                lanes, chunk(b), t0, self._take_override()))

    def process_spectra(self, spectra: np.ndarray):
        """Pipelined pre-FFT'd vector mode: the batch farm of ``process``
        minus framing and FFT. The host owns the input spectra, so each
        batch ships with the previous batch's last row prepended: the
        reach-back row is exact by construction (a group's lane t gets
        rows [t*b, (t+1)*b] of it, JAX's ``_shard_spec_inputs``)."""
        cfg = self.config
        if self._samples_mode:
            raise RuntimeError(
                "process_spectra() called on a stream already driven by "
                "process(); use one entry point per stream (reset() "
                "starts a new one)"
            )
        spectra = np.ascontiguousarray(spectra, np.complex64)
        if spectra.ndim != 2 or spectra.shape[1] != cfg.blocksize:
            raise ValueError(
                f"spectra must be [B, {cfg.blocksize}], got {spectra.shape}"
            )
        self._adopt_carry()
        self._spectra_mode = True
        spectra = np.concatenate([self._pending_spec, spectra])
        bb = cfg.batch_blocks
        n_batches = spectra.shape[0] // bb
        self._pending_spec = spectra[n_batches * bb:]

        def spec_ext(b):
            ext = np.concatenate([_pairs_to_complex(self._prev_specf)[None],
                                  spectra[b * bb:(b + 1) * bb]])
            self._prev_specf = _complex_to_pairs(ext[-1])
            return ext

        def group(b, lanes, t0):
            ext, bl = spec_ext(b), self.b_local
            return [self._pipe_front_spec(lane, ext[t * bl:(t + 1) * bl + 1],
                                          t0 + t * bl)
                    for t, lane in enumerate(lanes)]

        return self._run_batches(
            n_batches,
            lambda b, lane, t0: self._pipe_front_spec(lane, spec_ext(b), t0),
            group)

    # -- checkpoint integration -----------------------------------------------------

    def _host_extra_state(self) -> dict:
        """Checkpoint hook: the pipeline's framing state is on the host
        (the sample tail, or in vector mode the previous spectrum row);
        the pipelined steps never advance carry['hist'] /
        carry['prev_spec']. Sync them into the carry so a plain
        channelizer resumes this checkpoint, and save the host state
        (``fdc_tpu``'s keys) so a pipeline does."""
        cfg = self.config
        if self._carry is not None:
            carry = dict(self._carry)
            if self._spectra_mode:
                # the sample tail is all zeros in vector mode: the
                # reach-back row is the host-held _prev_specf
                carry["prev_spec"] = torch.from_numpy(
                    _pairs_to_complex(self._prev_specf)).to(self.device)
            else:
                # the tail is the last processed block: its spectrum is
                # prev_spec, its end the framing history
                t = torch.from_numpy(self._tail).to(self.device)
                carry["hist"] = t[-cfg.ovllen:].clone()
                carry["prev_spec"] = forward_spectrum(
                    t[None], use_mxu=cfg.use_mxu_fft)[0]
            self._carry = carry
        return {
            "pipeline_tail": self._tail.copy(),
            "pipeline_prev_specf": self._prev_specf.copy(),
        }

    def _restore_host_extra_state(self, extra: dict):
        cfg = self.config
        tail = extra.get("pipeline_tail")
        row = extra.get("pipeline_prev_specf")
        if tail is not None:
            self._tail = np.asarray(tail, np.complex64)
            self._prev_specf = (
                np.asarray(row, np.float32) if row is not None
                # a pipeline file without the row: the saving side synced
                # the carry, so the carried prev_spec is the exact row
                else self._pack_host_row()["prev_spec"]
            )
            self._ov_flag = False
            return
        # a plain checkpoint: the tail's history comes from the carried
        # hist; the samples before it are unknown, so the first batch
        # takes the carried prev_spec as its reach-back row (exact). In
        # vector mode the carried prev_spec is the reach-back row.
        host = self._pack_host_row()
        self._tail = np.concatenate(
            [np.zeros(cfg.inplen, np.complex64), host["hist"]])
        self._ov_row = host["prev_spec"]
        self._ov_flag = True
        self._prev_specf = host["prev_spec"]

    def _pack_host_row(self):
        """The carried hist (complex64) and prev_spec ([N, 2] float32
        pairs) on the host."""
        return {
            "hist": self._carry["hist"].cpu().numpy(),
            "prev_spec": _complex_to_pairs(
                self._carry["prev_spec"].cpu().numpy()),
        }
