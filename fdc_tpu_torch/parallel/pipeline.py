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

Compiled stages (JAX: ``parallel/pipeline.py:258-261`` jits each stage):
stage A (``_jit_front``, ``_jit_front_spec``) and stage C
(``_jit_slots``) are compiled steps of their lane, replayed on its
stream; stage B (``_jit_scan``) one of the owner lane, its graph forking
the owner groups' lanes. Each is a ring (``runtime.compiled``): a lane
keeps ``ceil(window / len(groups))`` slots of A and C (slot k of both in
one graph pool), B ``window`` slots sharing the carry, so no batch's
outputs are overwritten before the host consumed them. The done events
are recorded between replays, never inside a graph. The ``compile_step``
attribute (the class's or the instance's) runs the same stage functions
eagerly.

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
from fdc_tpu_torch.parallel.lanes import (
    Lanes,
    join_packs,
    lane_devices,
    merge_rows,
)
from fdc_tpu_torch.runtime.compiled import (
    GraphPool,
    HostMirror,
    _to_host,
    compiled_ring,
    install_carry,
)

__all__ = ["PipelineChannelizer", "lane_devices"]


def _complex_to_pairs(z: np.ndarray) -> np.ndarray:
    """complex64 [...] -> float32 [..., 2] pairs."""
    z = np.ascontiguousarray(z, np.complex64)
    return z.view(np.float32).reshape(*z.shape, 2)


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
        # the host mirror a group batch's lane outputs are joined from
        self._join_mirror = HostMirror()
        self._build_stages()

    def reset(self):
        super().reset()
        cfg = self.config
        self._tail = np.zeros(cfg.inplen + cfg.ovllen, np.complex64)
        self._ov_row = np.zeros((cfg.blocksize, 2), np.float32)
        self._ov_flag = False
        self._prev_specf = np.zeros((cfg.blocksize, 2), np.float32)
        # the stages' graphs and their pools go with the stream
        for step in self._stage_steps():
            step.release()
        self._uses = {}

    # -- the compiled stages --------------------------------------------------------

    def _ring_depths(self):
        """(slots of a worker lane's stage A / C rings, slots of stage B's
        ring): batch b takes its lane's next slot and B's; with the lanes
        taking batches in turn, a slot runs again only after ``window``
        batches, by when the host has consumed its outputs."""
        return -(-self.window // len(self.groups)), self.window

    def _build_stages(self):
        """The compiled stages (JAX: parallel/pipeline.py:258-261): for each
        worker lane, rings of stage A (samples, spectra) and stage C on its
        device, slot k of all three in one graph pool (they run in turn on
        the lane's stream); the owner lane's ring of stage B, a pool a
        slot, every slot advancing one static carry."""
        d_lane, d_scan = self._ring_depths()
        self._jit_front, self._jit_front_spec, self._jit_slots = {}, {}, {}
        for lane in self.worker_lanes:
            dev = self.devices[lane]
            pools = [GraphPool() for _ in range(d_lane)]
            self._jit_front[lane] = compiled_ring(
                self._stage_front, dev, d_lane, pools=pools)
            self._jit_front_spec[lane] = compiled_ring(
                self._stage_front_spec, dev, d_lane, pools=pools)
            self._jit_slots[lane] = compiled_ring(
                self._stage_slots, dev, d_lane, pools=pools, takes_t0=False)
        self._jit_scan = compiled_ring(self._stage_scan, self.device,
                                       max(1, d_scan), takes_t0=False)
        self._uses = {}  # calls of each ring so far (its next slot)

    def _stage_steps(self):
        rings = (*self._jit_front.values(), *self._jit_front_spec.values(),
                 *self._jit_slots.values(), self._jit_scan)
        return [step for ring in rings for step in ring]

    def _next_slot(self, key, depth):
        n = self._uses.get(key, 0)
        self._uses[key] = n + 1
        return n % depth

    def _owner_lanes(self):
        return sorted({0, *(lane for lane, _ in self._owner_groups)})

    def _set_carry(self, carry):
        self._carry = install_carry(self._jit_scan, self._carry, carry)

    def _stage(self, ring, slot, lanes, carry, *args):
        """One stage call on the caller's stream: slot ``slot`` of ``ring``
        replayed (captured at its first call a shape), its graph spanning
        ``lanes``; the stage function run eagerly where ``compile_step``
        is off."""
        step = ring[slot]
        if self._graphed(lanes):
            return step(carry, *args)
        return step.eager(carry, *args)

    # -- stage functions (each runs on the caller's stream) ---------------------

    def _stage_front(self, _, lane, x, ov_row, ov_flag, t0):
        """Stage A: framing and kernel F over the host-assembled run ``x``
        ([ovllen + (b + 1) * inplen] complex64: history, the reach-back
        block, the run's b blocks), the reach-back row (kernel F's [1, N]
        call) replaced by ``ov_row`` where ``ov_flag`` (a resume from a
        plain checkpoint; JAX's ``pipe_front``, ``jnp.where``), then the
        static extraction at global block ``t0``."""
        cfg = self.config
        blocks, _ = frame_blocks(x[cfg.ovllen:], x[:cfg.ovllen],
                                 cfg.blocksize)
        spec_ext = torch.empty(blocks.shape, dtype=torch.complex64,
                               device=x.device)
        forward_spectrum(blocks[:1], use_mxu=cfg.use_mxu_fft,
                         out=spec_ext[:1])
        spec_ext[:1] = torch.where(ov_flag, ov_row[None], spec_ext[:1])
        forward_spectrum(blocks[1:], use_mxu=cfg.use_mxu_fft,
                         out=spec_ext[1:])
        return None, self._stage_static(lane, spec_ext, t0)

    def _stage_front_spec(self, _, lane, spec_ext, t0):
        """Stage A in vector mode: the host's [b + 1, N] spectra, row 0
        the reach-back row."""
        return None, self._stage_static(lane, spec_ext, t0)

    def _stage_static(self, lane, spec_ext, t0):
        rep = self._replicas[self.devices[lane]]
        spec = spec_ext[1:]
        out, pa_powers, pa_ext, seg_powers, seg_packed = (
            rep._extract_static(spec, spec_ext, t0))
        dbg = torch.view_as_real(spec) if self.config.debug else None
        return out, pa_powers, pa_ext, seg_powers, seg_packed, spec_ext, dbg

    def _stage_scan(self, carry, pa_parts, pack_parts):
        """Stage B from the time runs' powers and packs (a run a lane of
        the batch's group): the runs joined in kernel C's layout, then the
        owner groups' chains, or one kernel C (or D) launch on lane 0,
        their lanes forked from the caller's stream and joined back.
        Returns (the new carry, the scans' flags, tables and plans)."""
        pa = None if pa_parts is None else (
            torch.cat(pa_parts) if len(pa_parts) > 1 else pa_parts[0])
        packs = join_packs(pack_parts) if len(self.segments) else []
        lanes = self._owner_lanes()
        self._fork(lanes)
        carry, scans = self._scan(carry, None, pa, packs)
        self._to_caller((carry, scans), lanes)
        return carry, scans

    def _stage_slots(self, _, lane, spec_ext, states, plans):
        """Stage C: every segment's planned slots over ``spec_ext``."""
        rep = self._replicas[self.devices[lane]]
        return None, rep._extract_slots_all(spec_ext, states, plans)

    # -- one batch ------------------------------------------------------------------

    def _front(self, lane, slot, host, t0):
        """Stage A on ``lane`` from its host inputs (``(x, ov_row,
        ov_flag)``, or ``(spec_ext,)`` in vector mode) through slot
        ``slot`` of its ring; the stage A tuple (out, pa_powers, pa_ext,
        seg_powers, seg_packed, spec_ext, dbg)."""
        ring = (self._jit_front if len(host) == 3
                else self._jit_front_spec)[lane]
        with self._on(lane):
            return self._stage(ring, slot, [lane], None, lane, *host, t0)[1]

    def _scan_parts(self, pa_parts, pack_parts):
        """Stage B on the owner lane (its parts already there) through the
        ring's next slot; the scans, ready in the owner lane's stream."""
        slot = self._next_slot("scan", len(self._jit_scan))
        with self._on(0):
            self._carry, scans = self._stage(
                self._jit_scan, slot, self._owner_lanes(), self._carry,
                pa_parts, pack_parts)
        return scans

    def _slots_on(self, lane, slot, spec_ext, states, plans):
        """Stage C on ``lane`` (its inputs already there) through slot
        ``slot`` of its ring."""
        with self._on(lane):
            return self._stage(self._jit_slots[lane], slot, [lane], None,
                               lane, spec_ext, states, plans)[1]

    def _dispatch(self, lanes, runs, t0):
        """Stages A, B and C of one batch on a worker group's lanes (one
        lane unless shard_time > 1); ``runs``: each lane's (host inputs,
        its first block's offset in the batch). Returns the in-flight
        entry; a group's per-lane row families are merged on the host when
        the batch is consumed."""
        slots = [self._next_slot(ln, len(self._jit_front[ln]))
                 for ln in lanes]
        fronts = [self._front(ln, k, host, t0 + off)
                  for ln, k, (host, off) in zip(lanes, slots, runs)]
        pa = ([self._handoff(f[1], ln, 0) for ln, f in zip(lanes, fronts)]
              if self.power_bank else None)
        packs = [self._handoff(list(f[4]), ln, 0)
                 for ln, f in zip(lanes, fronts)]
        scans = self._scan_parts(pa, packs)
        states = [st for st, _ in scans["segs"]]
        plans = [{k: so[k] for k in ("slot_ids", "slot_ids_narrow")
                  if k in so} for _, so in scans["segs"]]
        extracts = []
        for ln, k, f in zip(lanes, slots, fronts):
            st, pl = self._handoff((states, plans), 0, ln)
            extracts.append(self._slots_on(ln, k, f[5], st, pl))
        done = self._batch_done(lanes)
        if len(lanes) == 1:
            out, _, pa_ext, seg_powers, _, _, dbg = fronts[0]
            return (out, pa_ext, seg_powers, dbg, scans, extracts[0], t0,
                    done)
        return ([f[0] for f in fronts], [f[2] for f in fronts],
                [f[3] for f in fronts], [f[6] for f in fronts], scans,
                extracts, t0, done)

    def _sample_runs(self, n_runs, chunk):
        """The stage A inputs of a batch's ``n_runs`` time runs from the
        host: the sample line (the tail, then ``chunk``) cut into runs of
        ovllen + (b + 1) * inplen samples, run t starting t*b blocks in
        (its first block recomputes the previous run's last spectrum row:
        JAX's ``_shard_inputs``), the first with the resume override; the
        tail moves past ``chunk``."""
        cfg = self.config
        line = np.concatenate([self._tail, chunk])
        self._advance_tail(chunk)
        row, flag = self._take_override()
        b = len(chunk) // cfg.inplen // n_runs
        n = cfg.ovllen + (b + 1) * cfg.inplen
        none = (torch.zeros_like(row), torch.tensor(False))
        return [((torch.from_numpy(line[t * b * cfg.inplen:][:n]),
                  *((row, flag) if t == 0 else none)), t * b)
                for t in range(n_runs)]

    def _batch_done(self, lanes):
        """An event a worker lane after every stage of its batch: the lane
        waits for the owner lanes (their flags and tables), then records,
        between the replays (an event recorded inside a graph cannot be
        waited on from the host). None on CPU lanes."""
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

    def _join_group(self, parts):
        """A group batch's per-lane stage outputs joined on the host into
        the plain step's layout: streams and powers concatenated over the
        runs, row families with the runs' duplicated reach-back rows
        dropped (JAX: parallel/pipeline.py:437-446,700-720). The lanes'
        outputs are copied out once, into the join's mirror; the joins
        copy them out of it."""
        outs, pa_exts, seg_powers, dbgs, scans, extracts, t0_b, done = parts
        outs, pa_exts, seg_powers, dbgs, extracts = _to_host(
            (outs, pa_exts, seg_powers, dbgs, extracts), self._join_mirror)
        out = {}
        if self.throughput:
            out["throughput_buckets"] = [
                np.concatenate([o["throughput_buckets"][k] for o in outs],
                               axis=1)
                for k in range(len(self.throughput.buckets))]
        pa_ext = None
        if self.power_bank:
            pa_ext = {w: merge_rows([p[w] for p in pa_exts])
                      for w in pa_exts[0]}
        seg_p = [np.concatenate([p[i] for p in seg_powers])
                 for i in range(len(self.segments))]
        dbg = np.concatenate(dbgs) if self.config.debug else None
        ext = [{k: merge_rows([e[i][k] for e in extracts])
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
        """The resume override of the next batch, once: (the reach-back
        row [N] complex64, whether it replaces the recomputed one) as host
        tensors."""
        flag = self._ov_flag
        self._ov_flag = False
        return (torch.from_numpy(_pairs_to_complex(self._ov_row)),
                torch.tensor(flag))

    # -- pipelined streaming ------------------------------------------------------

    def _run_batches(self, n_batches, runs):
        """Dispatch ``n_batches`` batches over the worker groups in turn
        (``runs(b, n_lanes)``: batch b's stage A inputs), keeping up to
        ``window`` in flight, and consume them in order."""
        result = self._new_result()
        dbg = []
        inflight = []
        for b in range(n_batches):
            lanes = self.groups[b % len(self.groups)]
            inflight.append(self._dispatch(lanes, runs(b, len(lanes)),
                                           self._t0))
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

        return self._run_batches(
            n_batches,
            lambda b, n: self._sample_runs(n, x[b * bs:(b + 1) * bs]))

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

        def runs(b, n):
            ext = np.concatenate([_pairs_to_complex(self._prev_specf)[None],
                                  spectra[b * bb:(b + 1) * bb]])
            self._prev_specf = _complex_to_pairs(ext[-1])
            bl = bb // n
            return [((torch.from_numpy(ext[t * bl:(t + 1) * bl + 1]),),
                     t * bl) for t in range(n)]

        return self._run_batches(n_batches, runs)

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
            # written into the static carry the stage B graphs read
            self._carry = install_carry(self._jit_scan, self._carry, carry)
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
