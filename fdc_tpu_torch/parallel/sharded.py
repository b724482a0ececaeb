"""Multi-device channelizer: the step over a (time, chan) mesh of ranks.

Port of ``fdc_tpu.parallel.sharded``. JAX runs the step as one
``shard_map`` program; here one controller (the process) enqueues every
rank's part of the step, a rank being one mesh position, a torch device
(on CUDA with a stream of its own, ``parallel.lanes``), and JAX's
collectives become explicit hand-offs between ranks:

- **time axis**: the batch of B blocks splits into T consecutive runs of
  b = B / T blocks. Time rank t frames and transforms blocks [t*b,
  (t+1)*b) (kernel F into rows 1..b of its own extended spectrum); its
  framing history is the previous run's last ``ovllen`` samples (a view
  of the batch on one device) and its row 0 is the previous rank's last
  spectrum row, handed over. Rank t's measures, candidate packs and
  extractions use its global block offset t0 + t*b.
- **chan axis**: throughput / burst channel rows and the detection slots'
  extraction split over the C chan ranks: each holds the zero-padded row
  slices of every bucket's tables on its own device and extracts only
  its rows, and its slice of the slot extraction plans.
- **detection**: each time rank's powers are computed once (the
  measures ride its first chan rank's kernel A launch), its candidate
  packs by one kernel B launch; both are gathered over time into the
  batch layout, the packs straight into one flat buffer at kernel C's
  offsets. The scans then run once, on their owner ranks: with C > 1
  and two or more segments segment i is owned by chan rank i % C (one
  kernel C launch an owner group), else one kernel C (or D) launch. JAX
  replicates them over every device, which on one card would be T x C
  times the same chain.

The outputs are joined into the plain step's layout (each rank's
duplicated reach-back row dropped), so the host emission is shared, and
the carry is the plain carry: checkpoints cross-restore between plain
and sharded channelizers of either package.

With several processes (``parallel.multihost``) each holds a contiguous
run of the time ranks; the history tail, the reach-back row, the
detection statistics and the step outputs cross process boundaries
through the process group, so every process runs the same scans and
emits the same events.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from fdc_tpu_torch.config import ChannelizerConfig
from fdc_tpu_torch.models.channelizer import FrequencyDomainChannelizer
from fdc_tpu_torch.models.throughput import split_rows
from fdc_tpu_torch.ops.fft import forward_spectrum
from fdc_tpu_torch.ops.framing import frame_blocks
from fdc_tpu_torch.parallel.lanes import Lanes, merge_rows
from fdc_tpu_torch.parallel.mesh import CHAN_AXIS, TIME_AXIS, Mesh

__all__ = ["ShardedChannelizer", "split_rows"]


def _round_up(v: int, m: int) -> int:
    return v + (-v) % m


class ShardedChannelizer(Lanes, FrequencyDomainChannelizer):
    """FrequencyDomainChannelizer whose step runs over a mesh of ranks.

    Usage::

        mesh = make_mesh(n_time=4, n_chan=2, devices=["cuda:0"] * 8)
        fdc = ShardedChannelizer(config, mesh=mesh)
        result = fdc.process(samples)   # the plain channelizer's results

    Requirements: ``config.batch_blocks % n_time == 0``. ``max_slots``,
    ``extract_budget`` and ``extract_budget_narrow`` round up to
    multiples of ``n_chan`` (as ``fdc_tpu``'s, so the slot tables match
    its sharded ones); channel rows are zero-padded per rank.
    """

    def __init__(self, config: Optional[ChannelizerConfig] = None,
                 mesh: Mesh = None, **kwargs):
        if mesh is None:
            raise ValueError("ShardedChannelizer requires a mesh")
        if set(mesh.axis_names) != {TIME_AXIS, CHAN_AXIS}:
            raise ValueError(
                f"mesh must have axes ({TIME_AXIS!r}, {CHAN_AXIS!r}), "
                f"got {mesh.axis_names}"
            )
        self.mesh = mesh
        self.n_time = mesh.shape[TIME_AXIS]
        self.n_chan = nc = mesh.shape[CHAN_AXIS]
        if config is None:
            config = ChannelizerConfig(**kwargs)
            kwargs = {}
        if kwargs:
            config = config.replace(**kwargs)
        if config.batch_blocks % self.n_time:
            raise ValueError(
                f"batch_blocks={config.batch_blocks} must be divisible by "
                f"the time axis size {self.n_time}"
            )
        # the slot table and the extraction budgets round up so each chan
        # rank extracts an equal slice of the plans (JAX:
        # parallel/sharded.py:145-163)
        config = config.replace(
            max_slots=_round_up(config.max_slots, nc),
            extract_budget=_round_up(config.extract_budget, nc),
            extract_budget_narrow=_round_up(config.extract_budget_narrow,
                                            nc),
        )
        devs = mesh.local_devices
        super().__init__(config, device=devs[0])
        self._init_lanes(devs)
        self.b_local = config.batch_blocks // self.n_time
        # with several chan ranks and segments, segment i's chain runs on
        # chan rank i % n_chan of the first local time rank
        self._set_owner_groups(list(range(nc)))
        views = {}
        self._views = []
        for lane, d in enumerate(devs):
            key = (d, lane % nc)
            if key not in views:
                views[key] = self._rank_view(d, lane % nc)
            self._views.append(views[key])

    # -- channel-split tables ---------------------------------------------------

    def _rank_view(self, device, c):
        """Chan rank ``c``'s module on ``device``: the device's replica
        with its throughput and burst banks row-sliced
        (``BucketTables.row_slice``) and every fused family's tables
        sliced alike, its throughput and burst rows separately (so each
        rank keeps the plain step's split of them); the segments and the
        other tables are the replica's. Its ``_extract_static`` then
        extracts only the rank's rows."""
        nc = self.n_chan
        base = self._replicas[device]
        if nc == 1:
            return base
        rep = copy.copy(base)
        rep.__dict__["_modules"] = dict(base._modules)
        rep.__dict__["_buffers"] = dict(base._buffers)
        for k in ("throughput", "power_bank"):
            if base._modules.get(k) is not None:
                rep._modules[k] = base._modules[k].row_slice(c, nc)
        fused = {}
        for w, (name, tb) in base._fused.items():
            n_tp = len(tb.channel_ids)
            for key in (f"{name}_starts", f"{name}_folded",
                        f"{name}_windows"):
                t = base._buffers.get(key)
                # a shared matrix is every rank's (the FFT route's
                # windows are a row each)
                if t is not None and not (key.endswith("_folded")
                                          and t.dim() == 2):
                    rep._buffers[key] = torch.cat(
                        [split_rows(t[:n_tp], nc)[c],
                         split_rows(t[n_tp:], nc)[c]])
            fused[w] = (name, next(b for b in rep.throughput.buckets
                                   if b.width == w))
        rep._fused = fused
        return rep

    # -- the step -----------------------------------------------------------------

    def _lane(self, t: int, c: int = 0) -> int:
        return t * self.n_chan + c

    def _local_run(self, x, per_block: int, what: str):
        """This process's run of a step input: ``x`` holds the whole
        batch (``B * per_block`` leading entries, then sliced) or this
        process's run of it."""
        n_loc = self.mesh.n_time_local * self.b_local * per_block
        if x.shape[0] == n_loc:
            return x
        p = self.mesh.process_index
        if x.shape[0] == n_loc * self.mesh.process_count:
            return x[p * n_loc:(p + 1) * n_loc]
        raise ValueError(
            f"the sharded step takes the batch's {what} or this process's "
            f"run of them ({n_loc}), got {x.shape[0]}"
        )

    def _device_step(self, carry, x: torch.Tensor, t0: int):
        """One step over the batch: ``x`` [B * inplen] complex64 samples
        (or, with several processes, this process's contiguous run of
        them, ``multihost.host_local_batch``) on the first rank's device;
        ``t0`` the global index of the batch's first block. Returns
        (new_carry, outputs) in the plain step's layout."""
        x = self._local_run(x, self.config.inplen, "samples")
        return self._step(carry, t0, x=x)

    def _device_step_spectra(self, carry, spec: torch.Tensor, t0: int):
        """Pre-FFT'd step: ``spec`` [B, N] complex64 spectra (or this
        process's run of the rows); the framing history is left as it
        is."""
        spec = self._local_run(spec, 1, "spectrum rows")
        return self._step(carry, t0, spec_in=spec)

    def _step(self, carry, t0, x=None, spec_in=None):
        """The body of both entry points: samples ``x`` or spectra
        ``spec_in``, this process's run of the batch."""
        cfg = self.config
        nt, b = self.mesh.n_time_local, self.b_local
        self._adopt(carry)
        new_carry = dict(carry)
        # the process's first run: its history tail and reach-back row
        # come from the carry, or from the previous process
        hist0, prev0 = carry["hist"], carry["prev_spec"]
        for t in range(nt):
            self._from_caller(spec_in if x is None else x, self._lane(t))
        if x is not None:
            new_carry["hist"], hist0 = self._boundary(
                x[-cfg.ovllen:].clone(), hist0)
        specs = self._front(x, spec_in, hist0)
        last = self._handoff(specs[-1][b:], self._lane(nt - 1), 0)
        with self._on(0):
            last = last[0].clone()
        new_carry["prev_spec"], prev0 = self._boundary(last, prev0)
        for t in range(nt):
            lane = self._lane(t)
            row = (self._handoff(prev0, 0, lane) if t == 0 else
                   self._handoff(specs[t - 1][b], self._lane(t - 1), lane))
            with self._on(lane):
                specs[t][0].copy_(row)

        # every rank's flag-independent extraction; the time ranks'
        # measures and packs on their first chan rank
        t_first = t0 + self.mesh.time_offset * b
        ranks = {}
        for t in range(nt):
            for c in range(self.n_chan):
                lane = self._lane(t, c)
                spec_ext = (specs[t] if c == 0 else
                            self._handoff(specs[t], self._lane(t), lane))
                with self._on(lane):
                    ranks[t, c] = (spec_ext, self._views[lane]._extract_static(
                        spec_ext[1:], spec_ext, t_first + t * b,
                        detect=(c == 0)))

        pa_powers, seg_packed = self._detection_stats(ranks)
        new_carry, scans = self._scan(new_carry, 0, pa_powers, seg_packed)
        extracts = self._slots(ranks, scans)
        self._to_caller((ranks, extracts, scans, new_carry))
        return new_carry, self._join(ranks, extracts, scans, specs)

    def _boundary(self, mine, first):
        """The value at a process boundary of the time axis: ``mine`` is
        this process's last run's (the history tail, the last spectrum
        row), ``first`` the carried value for the mesh's first run.
        Returns (the value of the mesh's last run: the new carry's, the
        value before this process's first run). One process: (mine,
        first)."""
        if self.mesh.process_count == 1:
            return mine, first
        from fdc_tpu_torch.parallel.multihost import allgather

        self._to_caller(mine)
        every = allgather([mine])[0]
        p = self.mesh.process_index
        before = first if p == 0 else every[p - 1]
        self._from_caller(every, 0)
        return every[-1], before

    def _front(self, x, spec_in, hist0):
        """Each local time rank's extended spectrum [b + 1, N] on its
        first chan rank: kernel F over its run's blocks into rows 1..b
        (row 0, the reach-back row, is filled by the caller)."""
        cfg = self.config
        b, inplen = self.b_local, cfg.inplen
        specs = []
        for t in range(self.mesh.n_time_local):
            lane = self._lane(t)
            dev = self.devices[lane]
            with self._on(lane):
                spec_ext = torch.empty((b + 1, cfg.blocksize),
                                       dtype=torch.complex64, device=dev)
                if x is None:
                    spec_ext[1:].copy_(spec_in[t * b:(t + 1) * b])
                else:
                    lo = t * b * inplen
                    hist = (self._handoff(hist0, 0, lane) if t == 0
                            else x[lo - cfg.ovllen:lo].to(dev))
                    blocks, _ = frame_blocks(x[lo:lo + b * inplen].to(dev),
                                             hist, cfg.blocksize)
                    forward_spectrum(blocks, use_mxu=cfg.use_mxu_fft,
                                     out=spec_ext[1:])
            specs.append(spec_ext)
        return specs

    def _detection_stats(self, ranks):
        """The burst powers [B, C] and the segments' candidate packs (G
        [B, 7K] views of one flat buffer in kernel C's layout) of the
        whole batch on the first rank, gathered over the time ranks (and
        the processes)."""
        nt = self.mesh.n_time_local
        firsts = [(self._lane(t), ranks[t, 0][1]) for t in range(nt)]
        pa_powers = (self._gather_rows([(ln, r[1]) for ln, r in firsts], 0)
                     if self.power_bank else None)
        seg_packed = (self._gather_packs([(ln, r[4]) for ln, r in firsts], 0)
                      if len(self.segments) else [])
        if self.mesh.process_count == 1:
            return pa_powers, seg_packed
        from fdc_tpu_torch.parallel.multihost import allgather

        local = ([pa_powers] if pa_powers is not None else []) + seg_packed
        self._to_caller(local)
        whole = self._from_caller([e.reshape((-1,) + tuple(e.shape[2:]))
                                   for e in allgather(local)], 0)
        if pa_powers is not None:
            pa_powers = whole.pop(0)
        if seg_packed:
            seg_packed = self._gather_packs([(0, whole)], 0)
        return pa_powers, seg_packed

    def _slots(self, ranks, scans):
        """Stage C: rank (t, c) extracts its chan slice of every
        segment's replicated plans over its time run's spectrum."""
        nc = self.n_chan
        out = {}
        for (t, c), (spec_ext, _) in ranks.items():
            lane = self._lane(t, c)
            states, plans = [], []
            for i, (st, so) in enumerate(scans["segs"]):
                plan = {}
                for k in ("slot_ids", "slot_ids_narrow"):
                    if k in so:
                        e = so[k].shape[0] // nc
                        plan[k] = so[k][c * e:(c + 1) * e]
                st, plan = self._handoff((st, plan), self._seg_lane[i], lane)
                states.append(st)
                plans.append(plan)
            with self._on(lane):
                out[t, c] = self._views[lane]._extract_slots_all(
                    spec_ext, states, plans)
        return out

    def _join(self, ranks, extracts, scans, specs):
        """The ranks' outputs in the plain step's layout on the first
        rank's device (the caller's stream): channel rows joined over
        chan ranks and padding dropped, block rows joined over time ranks
        (and processes) with each run's duplicated reach-back row
        dropped."""
        nt, nc = self.mesh.n_time_local, self.n_chan
        dev = self.device

        def chan_cat(ts, n):
            ts = [t.to(dev) for t in ts]
            return (torch.cat(ts) if len(ts) > 1 else ts[0])[:n]

        def grid(get, n):
            """[time][chan] tensors -> per time rank, chans joined."""
            return [chan_cat([get(t, c) for c in range(nc)], n)
                    for t in range(nt)]

        rows, cats = {}, {}  # row families, tensors joined along dim dd
        out = {}
        if self.throughput:
            for k, bucket in enumerate(self.throughput.buckets):
                cats["tp", k] = (1, torch.cat(grid(
                    lambda t, c: ranks[t, c][1][0]["throughput_buckets"][k],
                    len(bucket.channel_ids)), dim=1))
        if self.power_bank:
            for bucket in self.power_bank.buckets:
                w = bucket.width
                rows["pa", w] = merge_rows(grid(
                    lambda t, c: ranks[t, c][1][2][w],
                    len(bucket.channel_ids)))
        for i, (st, so) in enumerate(scans["segs"]):
            for k in extracts[0, 0][i]:
                rows["seg", i, k] = merge_rows(grid(
                    lambda t, c: extracts[t, c][i][k], None))
            cats["pw", i] = (0, torch.cat(
                [ranks[t, 0][1][3][i].to(dev) for t in range(nt)]))
        if self.config.debug:
            cats["dbg"] = (0, torch.view_as_real(
                torch.cat([s[1:].to(dev) for s in specs])))
        if self.mesh.process_count > 1:
            rows, cats = self._join_processes(rows, cats)
        if self.throughput:
            out["throughput_buckets"] = [
                cats["tp", k][1] for k in range(len(self.throughput.buckets))]
        pa_ext = ({b.width: rows["pa", b.width]
                   for b in self.power_bank.buckets}
                  if self.power_bank else None)
        seg_ext = [{k[2]: v for k, v in rows.items()
                    if k[0] == "seg" and k[1] == i}
                   for i in range(len(self.segments))]
        self._assemble_detections(
            out, scans, seg_ext, pa_ext,
            [cats["pw", i][1] for i in range(len(self.segments))])
        if self.config.debug:
            out["debug_spectrum"] = cats["dbg"][1]
        return out

    def _join_processes(self, rows, cats):
        """The processes' joined outputs: one all-gather, then row
        families merged and the rest concatenated in process order."""
        from fdc_tpu_torch.parallel.multihost import allgather

        keys_r, keys_c = list(rows), list(cats)
        every = allgather([rows[k] for k in keys_r]
                          + [cats[k][1] for k in keys_c])
        rows = {k: merge_rows(list(e)) for k, e in zip(keys_r, every)}
        out = {}
        for k, e in zip(keys_c, every[len(keys_r):]):
            dim = cats[k][0]
            out[k] = (dim, torch.cat(list(e), dim=dim))
        return rows, out
