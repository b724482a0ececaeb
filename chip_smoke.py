#!/usr/bin/env python3
"""Smoke test of fdc_tpu_torch on one CUDA card (an H100).

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc`` (the kernels are built from ``fdc_tpu_torch/csrc``
on first use), imports neither JAX nor fdc_tpu, and exits non-zero on
any failure. It drives nine paths at full width, B=512 (and in phase
10 the flagship at blocksize 32768 and five of them with
``use_mxu_fft=False``): the flagship
(``_flagship``), the upstream example (``reference_example``: fused
throughput + burst buckets, one detection segment), BASELINE config 3
(``powact32``: 32 burst channels, the standalone burst chain), config 2
(``cfg2_dama16``: 16 throughput channels, kernel A's quarter-turn phase
fold), configs 4, 5 and 5b (two-tier slot extraction, 32, 512 and 4 x
128 slots), config 5 split into 4 parts (``cfg5s_burst_hunter_split4``:
the cut reconciliation), and the multi-segment vcm detector built from
config 5b as ``python -m fdc_tpu vcm`` maps a configuration, fed spectra
that the port's own front end makes on the card. Every path's front end
is kernel F, a radix FFT. Phases, one or more lines each, each ending
with its wall seconds:

1. the card (nvidia-smi name and power limit), torch / CUDA versions, and
   the kernel build;
2. each hand-written kernel against its plain PyTorch version on the card,
   on the inputs of every call it gets in each path's second step (the
   first leaves the slot tables and burst states busy; kernel B's
   acceptance chain alone on each recorded call's first segment), kernel
   D on the init / floor edges and its warp scan at B in {1, 31, 33,
   512} x R in {1, 2, 4, 8}, kernel B on its edge cases
   (``tests/test_torch_kernels.py`` ``PACK_EDGES``: every position a
   rise, ratio ties, 0/0 with and without zero_floor, K below the ratio
   count, touching intervals, empty blocks, a negative ext_start, 2048
   cells), kernel F at every N from 256 to 16384 and into
   rows 1..B of an extended spectrum, kernel P on every FFT probe's
   inputs, kernel E on the function of ``tools/pallas_extract_proto.py``
   (the flagship's throughput bucket 0 with a matrix per channel), and
   kernel A and its fold on ``EXTRACT_EDGES`` (odd starts, ragged shapes,
   a k split, partly used masks with and without their extent);
3. each path: ``FrequencyDomainChannelizer(cfg, device="cuda")`` (the
   vcm path: its front end + ``ActivityDetectionRunner``) over a scripted
   capture, process + flush, with the kernels' launch counts zeroed just
   before and read just after that run; configs 4 and 5 also through
   ``process_spectra`` on spectra framed on the card, with the same
   events;
4. each path through ``device="cpu"`` (the plain versions) for two
   batches, compared with the card's step outputs and events;
5. timing with CUDA events: each path's step on the kernel path (with
   its host enqueue time, its device busy time with the stream held and
   the idle share that leaves, the aten operations a step dispatches
   (views and allocations left out) beside the hand-written kernels'
   launches, and a torch.profiler breakdown where the
   profiler sees the card: device launches, kernel time, the heaviest
   kernels; a profiler that records no device time is reported, not a
   failure), with the ``torch.fft``
   front end in place of kernel F (between two kernel-path timings), and
   on the plain path,
   and each phase-2 case's kernel against its plain version and, where
   one PyTorch call computes the same function, that call (by CUDA
   events over back-to-back calls, wrappers included; for kernels A-F
   also the device time alone, by CUDA graph replay); kernel B's cases
   name each segment's ratio chunks and acceptance chain (paired ranked
   candidates a block), kernel C's their blocks with candidates and the
   mean valid candidates of such a block, and A's and E's their
   extraction error relative to the output's max;
6. kernel A's and kernel E's tile and k split rules
   (``extract_fused.gemm_plan``, ``static_plan``): on their buckets of
   the paths, every tile width and 1-8 k splits (E: also with and
   without its tail rows folded into the last tile), each held against
   the plain version and timed by CUDA graph replay, with the rule's
   choice ranked among them and each k split's error relative to the
   output's max (``plan_sweep``);
7. the host runtime (``runtime_phase``): the flagship and hunter4seg
   through process() + flush() with the native and the Python emitters
   (equal events, both host walls); ``python -m fdc_tpu_torch run`` on
   the flagship in a process of its own, then split by ``--checkpoint`` /
   ``--resume`` in this one; ``vcm`` on config 5b; and
   ``StreamDriver.run_file`` over the native file source — events,
   streams and event files equal to process() + flush() (vcm:
   ``VcmPath.stream``), and the path's kernels launched in each
   in-process run (counts zeroed just before, read just after);
8. the MPMD batch pipeline (``pipeline_phase``): the flagship through
   ``PipelineChannelizer`` on one lane, two lanes (two streams on the
   card) and three with a dedicated owner, hunter4seg and split4 with a
   dedicated owner and two scan owners (kernel C over each group's
   packs; split4's cut views cross the owners), powact32 (D on the
   owner) and the example (E in stage A) on two lanes, segdet's
   ``process_spectra`` on the card's spectra, the checkpoint split
   plain -> pipeline and pipeline -> plain, and a ``HostPipelineOwner``
   here with a ``python -m fdc_tpu_torch run --hostpipe-worker 1:2``
   process on the same card; every run equal to phase 3's process() +
   flush(), each with its host wall beside the plain run's and its
   launches, the stage-A reach-back row bit-equal to the plain step's
   carried row, and the hostpipe's bytes a batch each way;
9. the sharded step (``sharded_phase``): ``ShardedChannelizer`` over
   meshes of ranks that are streams of the card, each run cold then warm:
   the flagship at 4x1, 2x2, 1x2 and 8x1 (time x chan ranks), hunter4seg
   and split4 at 2x2 (scan ownership and cut views across chan ranks),
   the example at 2x2 (kernel E's fused rows split), powact32 at 4x1
   (kernel D), dama16 at 2x2 (kernel A's fold on every rank), segdet's
   ``process_spectra`` at 2x2, the checkpoint split plain -> sharded ->
   plain, the flagship through ``PipelineChannelizer(shard_time=2)`` on
   four lanes, ``tools_torch/multihost_worker.py`` as two processes on
   the card over the flagship's capture (gloo, host-staged) and the
   CLI's ``--time-shards 2`` on this one card (the mesh's error). Every
   run equal to phase 3's process() + flush(), with its host wall beside
   the plain run's and its launches a step equal to the predicted ones
   (``sharded_prediction``); every kernel call of each mesh run's second
   step, and of the shard_time pipeline's first two batches, held
   against its plain version (rank-local shapes).
10. the FFT route, blocksizes above 16384 and the utilities
   (``large_n_phase``): kernel F's two-pass form
   (``csrc/forward_fft_2pass.cu``) against its plain version at
   [512, 32768], [256, 65536], [128, 131072] and into rows 1..B of an
   extended spectrum, timed beside the plain version, the ``torch.fft``
   route and its bound; the flagship at blocksize 32768, B=512, through
   process() + flush() (F's two-pass form, A, B, C) and against the CPU
   plain path; the flagship, the example, powact32, hunter4seg and
   vcm4seg with ``use_mxu_fft=False`` (every subband transform on
   ``torch.fft``: no A, E or F launched, B and C or D once a step), each
   with its events equal to phase 3's, against the CPU plain path and
   with its step time; vcm4seg's step with its slots on the product
   route and on the FFT route, in turns; ``utils.profiling``
   (``time_scanned_stats``, ``measure_samples_per_sec``) on the flagship
   beside its step time; ``utils.resample`` on the card against the CPU.

In the kernel summary JSON, ``ms``, ``plain_ms``, ``bound_ms`` and
``library_ms`` are sums over the kernel's phase-2 cases (for
``forward_fft_2pass``, phase 10's), and ``launches`` are phase 3's (for
``forward_fft_2pass``, the 32768-point flagship's in phase 10).

The line before the last is the kernel summary JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

# extraction / stream tolerance (relative to each tensor's max magnitude)
# and the power tolerance: rtol elementwise on a common spectrum (the
# accumulation order differs), of the tensor's max end to end (kernel F
# and the CPU's four-step FFT also round differently, at ~1e-7 of the
# spectrum's scale)
RTOL, ATOL, PRTOL = 2e-4, 2e-5, 1e-5
TONE_BIN = -589  # exact bin near the centre of throughput channel 20
N_BATCHES = 5
BURST_TONE = 0.2  # tone amplitude in the burst paths' throughput channels
GATES_END = 3.4   # batches: every burst carrier is off after this
# detection captures: a comb of exact-bin tones of one amplitude in every
# bin (a floor whose cells all have the same power: no noise edge is ever
# near a ratio threshold) and carriers 27-34 dB over it, each at its own
# amplitude (0.6 dB apart: no two edges of equal strength); waves of
# carriers (first batch, last batch, carriers per segment)
FLOOR, CARRIER = 0.01, 0.2
WAVES = ((0.10, 0.45, 12), (0.60, 0.95, 12), (1.20, 2.60, 6),
         (3.00, GATES_END, 4))
# carrier widths in detection cells: <= 4 fit the 64-bin narrow bucket
# (40 bins x 1.4 = 56), 8 and 16 take 128 and 256 bins in the wide one
WIDTHS = (2, 8, 1, 3, 4, 16, 2, 1, 3, 8, 2, 4)
# kernel F's tolerance: of the spectrum's max (its radix passes round
# otherwise than the plain version's four-step matmuls, ~1e-7 of the max)
FFT_TOL = 1e-5
# the split path's cut carriers, per cut: (first cell relative to the
# cut, width in cells, first batch, last batch). The first two join
# mid-batch into one carrier over the cut: the upper part owns the first
# cell's candidates, the lower part the joined carrier's as it starts,
# so both spawn a slot; the next batch's kill rule discards the upper
# one and the ownership rule suppresses its candidates. The third sits
# on the cut.
CUT_CARRIERS = ((0, 1, 0.30, 2.60), (-1, 1, 0.55, 2.60),
                (-1, 2, 3.00, 4.40))
# the card's published peaks (H100 SXM data sheet, 700 W): fp32 outside
# the tensor cores, and HBM bandwidth
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
FLT_MIN, FLT_MAX = np.float32(1.1754944e-38), np.float32(3.4028235e38)


def log(*a):
    print(*a, flush=True)


def close(a, b, rtol, atol):
    """|a - b| <= atol * max|b| + rtol * |b| elementwise; max abs error."""
    a = np.asarray(a, np.complex128)  # real or complex inputs
    b = np.asarray(b, np.complex128)
    err = np.abs(a - b)
    scale = np.max(np.abs(b)) if b.size else 0.0
    ok = bool(np.all(err <= atol * scale + rtol * np.abs(b)))
    return ok, float(err.max()) if err.size else 0.0


def flatten(tree, pre=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{pre}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{pre}/{i}"))
    elif hasattr(tree, "detach"):
        out[pre] = tree.detach().cpu().numpy()
    return out


def nbytes(tree):
    return sum(v.nbytes for v in flatten(tree).values())


def compare_outputs(a, b, what):
    """Step-output dicts: integers/bools exact, powers within PRTOL,
    everything else within the stream tolerance."""
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys(), f"{what}: keys differ {set(fa) ^ set(fb)}"
    worst = worst_rel = 0.0
    for k in fa:
        x, y = fa[k], fb[k]
        assert x.shape == y.shape and x.dtype == y.dtype, (what, k)
        if x.dtype.kind in "biu":
            assert np.array_equal(x, y), f"{what}: {k} differs"
        else:
            rtol, atol = (0.0, PRTOL) if k.endswith("/power") else (RTOL, ATOL)
            ok, err = close(x, y, rtol, atol)
            assert ok, f"{what}: {k} max abs err {err}"
            worst = max(worst, err)
            if not k.endswith("/power") and y.size and np.abs(y).max() > 0:
                worst_rel = max(worst_rel, err / float(np.abs(y).max()))
    return worst, worst_rel


def event_meta(ev):
    d = ev.to_dict()
    d["ID"] = d["ID"].split(".", 1)[1]  # drop the timestamp prefix
    return d


def compare_events(ea, eb, what):
    """Metadata exact; the samples of all events as one stream (the FFT
    rounding differences scale with the capture, not with each burst)."""
    assert len(ea) == len(eb), f"{what}: {len(ea)} vs {len(eb)} events"
    for x, y in zip(ea, eb):
        assert event_meta(x) == event_meta(y), (what, event_meta(x),
                                                event_meta(y))
    if ea:
        ok, err = close(np.concatenate([e.data for e in ea]),
                        np.concatenate([e.data for e in eb]), RTOL, ATOL)
        assert ok, f"{what}: event samples max abs err {err}"


def _synth(cfg, n_samples):
    """(periodic, gate): exact-bin multi-tones repeating every block, and
    gates in units of batches, 0/1 or with raised-cosine edges of
    ``ramp`` samples."""
    n = cfg.blocksize
    blk = cfg.batch_blocks * cfg.inplen

    def periodic(bins, amps):
        # exact-bin tones repeat every n samples: synthesize one period
        spec = np.zeros(n, np.complex128)
        spec[np.asarray(bins) % n] = amps
        return np.resize(np.fft.ifft(spec) * n, n_samples)

    def gate(a, b, ramp=0):
        g = np.zeros(n_samples, np.float32)
        i, j = int(a * blk), int(b * blk)
        g[i:j] = 1.0
        if ramp:
            edge = 0.5 - 0.5 * np.cos(np.pi * (np.arange(ramp) + 0.5) / ramp)
            g[i:i + ramp] = edge
            g[j - ramp:j] = edge[::-1]
        return g

    return periodic, gate


def scripted_capture(cfg, n_samples, seed=0):
    """The flagship's capture. Noise, two exact-bin tones in throughput
    channels, an on/off carrier in the burst band, and band-limited
    carriers that appear and vanish in the detection segment — every
    power ratio the detectors see is far from their thresholds except at
    the carrier edges."""
    rng = np.random.default_rng(seed)
    n = cfg.blocksize
    periodic, gate = _synth(cfg, n_samples)
    x = 0.01 * (rng.standard_normal(n_samples)
                + 1j * rng.standard_normal(n_samples))
    x += periodic([TONE_BIN, 1000], [1.0, 1.0])
    x += gate(1 / 3, 2.5) * periodic([int(-0.45 * n)], [0.5])
    seg_lo = int(0.91 * n) - n // 2  # segment (0.41, 0.49) in bins
    for off, a, b in ((20, 0.1, 1.6), (150, 0.7, 3.3), (260, 2.2, 4.4)):
        ph = np.exp(1j * rng.uniform(0.0, 2 * np.pi, 24))
        x += gate(a, b) * periodic(seg_lo + off + np.arange(24), 0.3 * ph)
    return x.astype(np.complex64)


def burst_capture(cfg, n_samples, seed=1):
    """The burst paths' capture. Noise; an exact-bin tone (amplitude
    BURST_TONE) at the centre of every throughput and burst channel; in
    every burst channel a multi-tone carrier gated on for one batch, the
    channels staggered between 0.2 and 2.4 batches; in every detection
    segment band-limited carriers appearing and vanishing. A burst carrier
    is R > 30 dB over the tone in its band. Its gate edges are
    raised-cosine ramps of 1/8 block, so at most two blocks see part of
    an edge and one of the power ratios across it is over sqrt(0.75 R) >
    10: each channel sees exactly one burst. The ramps and the tones keep
    the edges' leakage into the other channels far under their tones."""
    rng = np.random.default_rng(seed)
    n = cfg.blocksize
    periodic, gate = _synth(cfg, n_samples)
    x = 0.01 * (rng.standard_normal(n_samples)
                + 1j * rng.standard_normal(n_samples))
    chans = cfg.activity_controlled_channels
    tones = {round(f * n) for f, _ in cfg.throughput_channels + chans}
    x += periodic(sorted(tones), BURST_TONE)
    for i, (f, bw) in enumerate(chans):
        a = 0.2 + 2.2 * i / max(len(chans) - 1, 1)
        k = max(2, int(bw * n / 4))
        ph = np.exp(1j * rng.uniform(0.0, 2 * np.pi, k))
        x += gate(a, a + 1.0, ramp=n // 8) * periodic(
            round(f * n) - k // 2 + np.arange(k), 2.0 * ph)
    for lo, hi in cfg.activity_detection_segments:
        for frac, a, b in ((0.1, 0.1, 1.6), (0.45, 0.7, 3.3),
                           (0.75, 2.2, 4.4)):
            ph = np.exp(1j * rng.uniform(0.0, 2 * np.pi, 24))
            x += gate(a, b) * periodic(
                round((lo + frac * (hi - lo)) * n) + np.arange(24), 0.3 * ph)
    return x.astype(np.complex64)


def carrier_capture(fdc, n_samples, seed=2):
    """The detection paths' capture. The comb floor (FLOOR in every bin,
    random phases) and, in every detection segment, the WAVES of
    band-limited carriers on the segment's own cell grid (so a carrier's
    edge cells are all carrier or all floor), CARRIER * 0.6 dB steps over
    the floor's phases, gated with raised-cosine ramps of 1/8 block.
    Returns (samples, number of carriers)."""
    return _carriers(fdc.config, [sd.geometry for sd in fdc.segments],
                     n_samples, seed)


def _carriers(cfg, grids, n_samples, seed, cuts=None):
    """:func:`carrier_capture` on cell grids (start bin, n_cells,
    decimation), plus ``cuts`` = (grid, cell indices): the CUT_CARRIERS
    at each of those cells of that grid."""
    n = cfg.blocksize
    periodic, gate = _synth(cfg, n_samples)
    rng = np.random.default_rng(seed)
    phase = np.exp(1j * rng.uniform(0.0, 2 * np.pi, n))
    x = periodic(np.arange(n), FLOOR * phase)
    n_carriers = 0

    def lay(g, cell, w, a, b, amp):
        bins = g.start + cell * g.decimation - n // 2 + np.arange(
            w * g.decimation)  # fftshifted index -> FFT bin
        return gate(a, b, ramp=n // 8) * periodic(bins,
                                                  amp * phase[bins % n])

    for g in grids:
        for a, b, count in WAVES:
            count = min(count, g.n_cells // 20)
            space = g.n_cells // count
            for i in range(count):
                w = min(WIDTHS[i % len(WIDTHS)], space - 2)
                x += lay(g, i * space + (space - w) // 2, w, a, b,
                         CARRIER * 10 ** (0.03 * i))
                n_carriers += 1
    if cuts is not None:
        g, cells = cuts
        for j, cut in enumerate(cells):
            for k, (off, w, a, b) in enumerate(CUT_CARRIERS):
                x += lay(g, cut + off, w, a, b,
                         CARRIER * 10 ** (0.03 * (12 + 3 * j + k)))
            n_carriers += 2  # the joined pair is one carrier
    return x.astype(np.complex64), n_carriers


def split_capture(fdc, n_samples, seed=2):
    """The split path's capture on the parent segment's cell grid: the
    comb floor, the WAVES inside every part's core (4 cells clear of the
    cuts) and the CUT_CARRIERS at each cut."""
    parts = fdc.segments
    dec = parts[0].geometry.decimation
    start = parts[0].geometry.start  # the parent's first cell
    cores = [((lo - start) // dec, (hi - start) // dec)
             for lo, hi in (sd.core_bins for sd in parts)]
    grids = [SimpleNamespace(start=start + (lo + 4) * dec,
                             n_cells=hi - lo - 8, decimation=dec)
             for lo, hi in cores]
    parent = SimpleNamespace(start=start, decimation=dec)
    return _carriers(fdc.config, grids, n_samples, seed,
                     cuts=(parent, [hi for _, hi in cores[:-1]]))


def card_spectra(cfg, x, device):
    """The [B, N] spectra of each whole batch of samples in ``x``, framed
    and transformed on ``device`` by the port's front end
    (``frame_blocks`` + ``forward_spectrum`` on the configuration's
    route, kernel F) one batch at a time, the shapes ``process`` uses; a
    list of host arrays."""
    import torch

    from fdc_tpu_torch.ops.fft import forward_spectrum
    from fdc_tpu_torch.ops.framing import frame_blocks

    bs = cfg.batch_blocks * cfg.inplen
    hist = torch.zeros(cfg.ovllen, dtype=torch.complex64, device=device)
    spectra = []
    for i in range(len(x) // bs):
        blocks, hist = frame_blocks(
            torch.from_numpy(x[i * bs:(i + 1) * bs]).to(device), hist,
            cfg.blocksize)
        spectra.append(forward_spectrum(blocks, use_mxu=cfg.use_mxu_fft)
                       .cpu().numpy())
    return spectra


class VcmPath:
    """The multi-segment vcm detector behind the port's own front end:
    ``ActivityDetectionChannelizer`` built from a configuration as
    ``fdc_tpu/__main__.py:506-529`` maps one, and its runner. ``stream``
    feeds it :func:`card_spectra` as the vcm command does; the step
    interface (``_device_init``, ``_device_step``) is the channelizer's,
    so phases 2, 4 and 5 drive it alike."""

    def __init__(self, cfg, device):
        from fdc_tpu_torch import ActivityDetectionChannelizer

        self.config, self.device = cfg, device
        self.adc = ActivityDetectionChannelizer(
            blocklen=cfg.blocksize,
            segments=[list(s) for s in cfg.fdc_activity_detection_segments()],
            thresh_db=cfg.act_det_threshold, relinvovl=cfg.relinvovl,
            minchandist=cfg.minchandist,
            channel_deactivation_delay=cfg.act_det_deactivation_delay,
            window_flank_puffer=cfg.minchanflankpuffer,
            max_slots=cfg.max_slots, max_candidates=cfg.max_candidates,
            max_extract_width=cfg.max_extract_width, verbose=cfg.verbose,
            extract_budget=cfg.extract_budget,
            extract_width_split=cfg.extract_width_split,
            extract_budget_narrow=cfg.extract_budget_narrow, device=device)
        self.segments = self.adc.segments
        self.batch_samples = cfg.batch_blocks * cfg.inplen
        self._steps = self.adc.make_runner()  # its step functions only

    def stream(self, x):
        """A fresh runner over the capture: the tail zero-padded to a whole
        batch, then silent batches while a slot is open (the vcm command's
        end of stream). Returns (events, blocks with samples)."""
        from fdc_tpu_torch.models.channelizer import finalize_rounds_bound

        cfg, bs, n = self.config, self.batch_samples, len(x)
        runner = self.adc.make_runner(maxblocks=cfg.act_det_maxblocks)
        n_real = -(-n // bs)
        rounds = finalize_rounds_bound(self.segments, cfg.batch_blocks)
        x = np.concatenate([x, np.zeros((n_real + rounds) * bs - n,
                                        np.complex64)])
        events = []
        for i, spec in enumerate(card_spectra(cfg, x, self.device)):
            if i >= n_real and not runner.has_open_slots():
                break
            events += runner.process_spectra(spec)
        return events, -(-n // cfg.inplen)

    def _device_init(self):
        import torch

        return {"hist": torch.zeros(self.config.ovllen,
                                    dtype=torch.complex64,
                                    device=self.device),
                "run": self._steps._device_init()}

    def _device_step(self, carry, x, t0):
        from fdc_tpu_torch.ops.fft import forward_spectrum
        from fdc_tpu_torch.ops.framing import frame_blocks

        blocks, hist = frame_blocks(x, carry["hist"], self.config.blocksize)
        run, outs = self._steps._device_step(
            carry["run"],
            forward_spectrum(blocks, use_mxu=self.config.use_mxu_fft))
        return ({"hist": hist, "run": run},
                {f"seg{i}": o for i, o in enumerate(outs)})


def drive(fdc, x):
    """The whole capture through a path's streaming entry point: process +
    flush, or the vcm path's stream. Returns (the whole batches' result,
    the flush's result)."""
    from fdc_tpu_torch import ProcessResult

    if isinstance(fdc, VcmPath):
        events, blocks = fdc.stream(x)
        return (ProcessResult(events=events, blocks_processed=blocks),
                ProcessResult())
    return fdc.process(x), fdc.flush()


def cuda_time(fn, iters):
    """Mean milliseconds per call of fn() with CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_time(fn, iters=20):
    """Device milliseconds per call of fn(): ``iters`` calls captured in
    one CUDA graph and replayed, so no host time is in it (the wrappers'
    host glue can outlast a short kernel). None if the capture fails."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    except RuntimeError as e:
        log(f"  graph capture failed: {str(e)[:200]}")
        torch.cuda.synchronize()
        return None
    ms = cuda_time(graph.replay, 10) / iters
    del graph
    return ms


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


# kernels whose phase-5 cases also get their device time by graph_time
# (not greedy_accept: its wrapper checks its intervals on the host)
GRAPHED = ("forward_fft", "extract_shared", "extract_shared_fold",
           "extract_static", "slot_lifecycle", "candidate_packs", "powact")


def held_time(fn, hold_ms):
    """Device milliseconds of one call of fn() with no host gaps, by CUDA
    events alone: a spin kernel holds the stream for ``hold_ms`` while the
    host enqueues the call, so the call's kernels then run back to back.
    None when the host was not done before the spin ended (the time would
    hold host gaps)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    torch.cuda._sleep(1 << 20)
    t1.record()
    torch.cuda.synchronize()
    cycles = int(hold_ms / t0.elapsed_time(t1) * (1 << 20))
    torch.cuda._sleep(cycles)
    t0.record()
    fn()
    t1.record()
    held = not t0.query()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) if held else None


def wrappers():
    """(kernel name, module, attribute) of every kernel wrapper. Callers
    reach each wrapper through its module, each carries ``.launches`` and
    has a plain twin ``<attribute>_plain`` in the same module."""
    from fdc_tpu_torch.ops import (
        detect,
        extract_fused,
        fft,
        lifecycle,
        powact,
        probes,
    )

    return (("extract_shared", extract_fused, "extract_shared"),
            ("candidate_packs", detect, "candidate_packs"),
            ("greedy_accept", detect, "greedy_accept_batch"),
            ("slot_lifecycle", lifecycle, "slot_lifecycle_multi"),
            ("powact", powact, "powact_flags"),
            ("extract_static", extract_fused, "extract_static"),
            ("extract_shared_fold", extract_fused, "extract_shared_fold"),
            ("forward_fft", fft, "forward_spectrum_four_step"),
            ("forward_fft_2pass", fft, "forward_spectrum_two_pass"),
            ("tile_probe", probes, "tile_probe"))


def counters():
    """Every kernel wrapper, by kernel name."""
    return {k: getattr(m, a) for k, m, a in wrappers()}


# name: (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "extract_shared": ("fdc_tpu_torch/csrc/extract_shared.cu",
                       "fdc_tpu/ops/extract_pallas.py:96"),
    "candidate_packs": ("fdc_tpu_torch/csrc/candidate_packs.cu",
                        "fdc_tpu/ops/detect.py:183"),
    # the same source's acceptance chain alone (greedy_accept_batch), off
    # the paths since the candidate packs took the stage in
    "greedy_accept": ("fdc_tpu_torch/csrc/candidate_packs.cu",
                      "fdc_tpu/ops/detect.py:183"),
    "slot_lifecycle": ("fdc_tpu_torch/csrc/lifecycle.cu",
                       "fdc_tpu/ops/lifecycle_pallas.py:53"),
    "powact": ("fdc_tpu_torch/csrc/powact.cu",
               "fdc_tpu/ops/lifecycle_pallas.py:1319"),
    "extract_static": ("fdc_tpu_torch/csrc/extract_static.cu",
                       "fdc_tpu/ops/extract_pallas.py:62"),
    "extract_shared_fold": ("fdc_tpu_torch/csrc/extract_shared.cu",
                            "fdc_tpu/ops/extract_pallas.py:142"),
    "forward_fft": ("fdc_tpu_torch/csrc/forward_fft.cu",
                    "tools/pallas_fft_proto.py:83,99; "
                    "tools/pallas_fft_proto2.py:90"),
    # kernel F's two-pass form, blocksizes above 16384 (phase 10)
    "forward_fft_2pass": ("fdc_tpu_torch/csrc/forward_fft_2pass.cu",
                          "tools/pallas_fft_proto.py:83,99; "
                          "tools/pallas_fft_proto2.py:90"),
    "tile_probe": ("fdc_tpu_torch/csrc/fft_probes.cu",
                   "tools/pallas_fft_micro.py:39-90; "
                   "tools/pallas_fft_micro2.py:44-92"),
}


@contextlib.contextmanager
def swapped(make):
    """Replace every kernel wrapper in its module by
    ``make(name, wrapper, plain)`` while the block runs."""
    ws = wrappers()
    saved = [getattr(m, a) for _, m, a in ws]
    for (k, m, a), fn in zip(ws, saved):
        setattr(m, a, make(k, fn, getattr(m, a + "_plain")))
    try:
        yield
    finally:
        for (_, m, a), fn in zip(ws, saved):
            setattr(m, a, fn)


def plain_path():
    """Route the main paths through the plain PyTorch versions (for the
    plain-path timing on the card)."""
    return swapped(lambda k, fn, plain: plain)


def cufft_front_end():
    """Route the main paths' forward FFT through ``torch.fft`` (shifted
    and scaled) instead of kernel F, the other kernels unchanged: the
    step's cost of F over cuFFT, within one run."""
    from fdc_tpu_torch.ops import fft

    def make(k, fn, plain):
        if k != "forward_fft":
            return fn
        return lambda blocks, out=None: fft.forward_spectrum(
            blocks, use_mxu=False, out=out)
    return swapped(make)


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(clone(v) for v in tree)  # named tuples: as given
    return tree.clone() if hasattr(tree, "clone") else tree


def recorded_calls(drive):
    """Every kernel call ``drive()`` makes on the card: [(name, wrapper,
    plain, args, kwargs)], the arguments cloned on the caller's stream
    just before the call."""
    import torch

    calls = []

    def record(k, fn, plain):
        def rec(*a, **kw):
            calls.append((k, fn, plain, clone(a), clone(kw)))
            return fn(*a, **kw)
        rec.launches = 0  # fn counts through its module's name, i.e. rec
        return rec

    with swapped(record):
        drive()
    torch.cuda.synchronize()
    return calls


def step_calls(fdc, x):
    """Every kernel call of the path's second step on the card, the first
    having left its carry (slot tables, burst states) busy."""
    import torch

    cfg, dev, bs = fdc.config, fdc.device, fdc.batch_samples
    carry, _ = fdc._device_step(fdc._device_init(),
                                torch.from_numpy(x[:bs]).to(dev), 0)
    return recorded_calls(lambda: fdc._device_step(
        carry, torch.from_numpy(x[bs:2 * bs]).to(dev), cfg.batch_blocks))


def case(name, kern, plain, cmp, shape, bytes_, flops=0.0, library=None):
    """One kernel case: its calls, comparator and the work it must do
    (bytes moved, each input read once and each output written once;
    fp32 operations) for the bound."""
    return dict(name=name, kern=kern, plain=plain, cmp=cmp, shape=shape,
                bytes=float(bytes_), flops=float(flops), library=library)


def slice_bins(starts, l):
    """The spectrum bins the slices read (their union)."""
    bins = set()
    for s in starts.cpu().tolist():
        bins.update(range(s, s + l))
    return bins


def cmp_close(what, rtol=RTOL, atol=ATOL):
    def cmp(a, b):
        ok, e = close(a.cpu(), b.cpu(), rtol, atol)
        assert ok, (what, e)
        return e
    return cmp


def cmp_exact(a, b):
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k
    return 0.0


def cmp_measured(a, b):
    ok1, e1 = close(a[0].cpu(), b[0].cpu(), RTOL, ATOL)
    ok2, e2 = close(a[1].cpu(), b[1].cpu(), PRTOL, 0.0)
    assert ok1 and ok2, ("extract_shared + measures", e1, e2)
    return max(e1, e2)


def extract_work(spec, starts, mats, masks=None, extent=None):
    """(description, bytes, fp32 operations, library call, comparator) of
    kernel A (``mats`` [2l, 2k]) or E ([C, 2l, 2k]) on these inputs. The
    measures count only the mask columns in use (the rest is zero
    padding to 128), and their spectrum reads and operations only the bins
    those columns cover (``extent``, the part kernel A is told to
    multiply, does not change the function)."""
    import torch

    from fdc_tpu_torch.ops.extract_fused import gather_pairs

    rows, n = spec.shape
    c = starts.numel()
    l2, k2 = mats.shape[-2:]
    bins = slice_bins(starts, l2 // 2)
    z = gather_pairs(spec, starts, l2 // 2)
    flops = 2.0 * c * rows * l2 * k2
    out_bytes = c * rows * k2 * 4
    what = f"[{c}, {rows}, {k2 // 2}, 2]"
    if mats.dim() == 3:
        return (what, len(bins) * rows * 8 + nbytes((starts, mats))
                + out_bytes, flops, lambda: torch.bmm(z, mats),
                cmp_close("extract_static"))
    z = z.reshape(-1, l2)
    if masks is None:
        return (what, len(bins) * rows * 8 + nbytes((starts, mats))
                + out_bytes, flops, lambda: torch.matmul(z, mats),
                cmp_close("extract_shared"))
    used = (masks != 0).any(0)
    cm = int(used.sum())
    m_bins = torch.nonzero((masks[:, used] != 0).any(1)).flatten().tolist()
    bins |= set(m_bins)
    sf = torch.view_as_real(spec)
    sq = sf[..., 0] ** 2 + sf[..., 1] ** 2
    return (f"{what} + powers [{rows}, {cm} of {masks.shape[1]}]",
            len(bins) * rows * 8 + nbytes((starts, mats)) + n * cm * 4
            + out_bytes + rows * cm * 4,
            flops + 2.0 * rows * len(m_bins) * cm,
            lambda: (torch.matmul(z, mats), torch.matmul(sq, masks)),
            cmp_measured)


def fft_case(what, blocks, kern, plain, out=None):
    """Kernel F on [B, N] blocks (into ``out`` if given). The bound is the
    function's, a shifted and scaled DFT: the blocks read and the spectrum
    written once, and an FFT's 5 N log2 N fp32 operations a block; the
    library call is ``torch.fft.fft`` on the same blocks (no shift, no
    scale)."""
    import torch

    rows, n = blocks.shape
    return case("forward_fft", lambda: kern(blocks, out=out),
                lambda: plain(blocks), cmp_close("forward_fft", 0.0, FFT_TOL),
                what, 2 * blocks.numel() * 8,
                5.0 * n * math.log2(n) * rows,
                lambda: torch.fft.fft(blocks))


def fft_cases():
    """Kernel F at every N it covers, B = 64 blocks of seeded noise, and
    at [512, 4096] into rows 1..B of an extended spectrum (row 0 must
    keep its value)."""
    import torch

    from fdc_tpu_torch.ops import fft

    rng = np.random.default_rng(4)

    def noise(b, n):
        return torch.from_numpy(
            (rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
             ).astype(np.complex64)).to("cuda")

    out = [fft_case(f"N={n} [64, {n}]", noise(64, n),
                    fft.forward_spectrum_four_step,
                    fft.forward_spectrum_four_step_plain)
           for n in (1 << e for e in range(8, 15))]
    ext = torch.full((513, 4096), 3 + 4j, dtype=torch.complex64,
                     device="cuda")
    cs = fft_case("into spec_ext[1:] [512, 4096]", noise(512, 4096),
                  fft.forward_spectrum_four_step,
                  fft.forward_spectrum_four_step_plain, out=ext[1:])
    cmp = cs["cmp"]

    def cmp_ext(a, b):
        assert bool((ext[0] == 3 + 4j).all()), "row 0 of spec_ext written"
        return cmp(a, b)
    cs["cmp"] = cmp_ext
    return out + [cs]


def probe_cases():
    """Kernel P on every FFT probe's own inputs (numpy seed 0)."""
    import torch

    from fdc_tpu_torch.ops import probes

    out = []
    for name in probes.PROBES:
        ins = [torch.from_numpy(a).to("cuda")
               for a in probes.probe_inputs(name)]
        res = probes.tile_probe_plain(name, *ins)
        out.append(case(
            "tile_probe",
            lambda name=name, ins=ins: probes.tile_probe(name, *ins),
            lambda name=name, ins=ins: probes.tile_probe_plain(name, *ins),
            cmp_close(name, 0.0, FFT_TOL),
            f"{name} {[list(v.shape) for v in ins]} -> {list(res.shape)}",
            nbytes(ins) + nbytes(res), probes.probe_flops(name)))
    return out


# kernel A's edge cases: (rows, N, l, C, odd starts, mask columns in use
# of 128, the masks' extent passed, fold R); the output is 1.5 l pairs
# wide
EXTRACT_EDGES = {
    "odd starts": (37, 1024, 64, 6, True, 0, False, 0),
    "513 rows, nout 96": (513, 4096, 64, 3, True, 0, False, 0),
    "513 rows, nout 192": (513, 4096, 128, 5, False, 0, False, 0),
    "C = 1, K = 2048 + 54 of 128 measures": (512, 4096, 1024, 1, False, 54,
                                             True, 0),
    "C = 64, 34 of 128 measures": (512, 4096, 64, 64, True, 34, True, 0),
    "C = 64, 34 of 128 measures, whole masks": (512, 4096, 64, 64, True, 34,
                                                False, 0),
    "fold R = 2, odd starts": (513, 4096, 128, 5, True, 0, False, 2),
    "fold R = 4, C = 1, K = 2048": (512, 4096, 1024, 1, True, 0, False, 4),
}

# kernel A's buckets on the paths at B = 512, for the plan sweep: (rows,
# l, C, fold R, mask columns in use of 128)
PLAN_BUCKETS = {
    "flagship": (512, 64, 64, 0, 34),
    "flagship burst": (513, 128, 1, 0, 0),
    "example": (512, 1024, 1, 0, 54),
    "powact32": (513, 128, 32, 0, 0),
    "dama16": (512, 256, 16, 4, 0),
}


# kernel E's buckets: the example's fused w256 and w512 and the function
# of tools/pallas_extract_proto.py (the flagship's bucket 0 with a matrix
# per channel): (rows, l, C); the output is 1.5 l pairs wide
STATIC_BUCKETS = {
    "example w256": (513, 256, 2),
    "example w512": (513, 512, 5),
    "prototype": (512, 64, 64),
}


def kernel_e_inputs(rng, rows, n, l, c):
    """Seeded inputs of kernel E on the card: [rows, n] spectra, C sorted
    even starts and a folded [2l, 1.5 l * 2] matrix a channel, each of its
    own window."""
    import torch

    from fdc_tpu_torch.ops import extract

    spec = (rng.standard_normal((rows, n))
            + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
    starts = (np.sort(rng.choice((n - l) // 2, c, replace=False)) * 2
              ).astype(np.int32)
    wins = rng.random((c, l)).astype(np.float32) + 0.1
    mats = extract.static_folded_matrices(n, starts, wins, l // 4, float(l))
    return [torch.from_numpy(np.ascontiguousarray(v)).to("cuda")
            for v in (spec, starts, mats)]


def kernel_a_inputs(rng, rows, n, l, c, odd, used):
    """Seeded inputs of kernel A on the card: [rows, n] spectra, C sorted
    starts (all odd or all even), a folded [2l, 1.5 l * 2] matrix, and
    [n, 128] band masks with ``used`` leading columns in use (None if
    ``used`` is 0)."""
    import torch

    from fdc_tpu_torch.ops.fft import _rr_idft_matrix, interleave_rows

    spec = (rng.standard_normal((rows, n))
            + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
    starts = (np.sort(rng.choice((n - l) // 2, c, replace=False)) * 2
              + int(odd)).astype(np.int32)
    win = np.tile(rng.random(l).astype(np.float32) + 0.1, 2)
    mat = interleave_rows((win[:, None] * _rr_idft_matrix(
        l, l // 4, True, float(l), pairs=True)).astype(np.float32))
    masks = None
    if used:
        masks = np.zeros((n, 128), np.float32)
        for col in range(used):
            lo = int(rng.integers(n // 8, n - n // 8))
            masks[lo:lo + int(rng.integers(4, 40)), col] = 1.0
    return [torch.from_numpy(v).to("cuda") if v is not None else None
            for v in (spec, starts, mat, masks)]


def extract_edge_cases():
    """Kernel A (and its fold) on EXTRACT_EDGES: odd starts (8-byte
    copies), rows and nout that are no multiple of a tile, the example's
    C = 1 bucket (a k split), masks with some columns in use, with their
    extent (the main path's route) and without it (the whole masks); the
    padding columns must come back exactly 0. Seeded."""
    from fdc_tpu_torch.ops import extract_fused

    rng = np.random.default_rng(5)
    out = []
    for what, (rows, n, l, c, odd, used, ext, r) in EXTRACT_EDGES.items():
        spec, starts, mat, masks = kernel_a_inputs(rng, rows, n, l, c, odd,
                                                   used)
        a, kw = (spec, starts, mat), {}
        name = "extract_shared_fold" if r else "extract_shared"
        if r:
            a += (r,)
        elif used:
            a += (masks,)
            if ext:
                kw["extent"] = extract_fused.mask_extent(masks.cpu())
        cs = call_case(f"edge: {what}", name, getattr(extract_fused, name),
                       getattr(extract_fused, name + "_plain"), a, kw)
        if used:
            cmp = cs["cmp"]

            def cmp_pad(x, y, cmp=cmp, used=used):
                assert not bool(x[1][:, used:].any()), "padding powers != 0"
                return cmp(x, y)
            cs["cmp"] = cmp_pad
        out.append(cs)
    return out


def sweep(name, what, plan_fn, plans, chosen, run, ref, cmp, library,
          card):
    """Time ``run`` under each plan in place of ``extract_fused.<plan_fn>``
    (graph_time, device time), each held against the plain result ``ref``
    (its extraction's max error relative to the output's max printed
    beside it: the k split's summation order), and rank the rule's choice
    ``chosen`` among them."""
    from unittest import mock

    from fdc_tpu_torch.ops import extract_fused as ef

    r0 = ref[0] if isinstance(ref, tuple) else ref
    scale = float(r0.abs().max())
    times = []
    for plan in sorted(plans):
        with mock.patch.object(ef, plan_fn, lambda *_, p=plan: p):
            got = run()
            cmp(got, ref)
            g0 = got[0] if isinstance(got, tuple) else got
            rel = float((g0 - r0).abs().max()) / scale
            ms = graph_time(run)
        times.append((math.inf if ms is None else ms, plan, rel))
    times.sort()
    rank = [p for _, p, _ in times].index(chosen) + 1
    t_chosen, _, rel_chosen = next(t for t in times if t[1] == chosen)
    log(f"phase 6: {name} {what}: {plan_fn} {chosen} {t_chosen:.4f} ms "
        f"(err {rel_chosen:.3g} of max), rank {rank} of {len(times)}; "
        f"library {fmt_ms(graph_time(library))}; fastest: "
        + ", ".join(f"{'x'.join(map(str, p[:2]))}/{p[2]}"
                    f"{'' if len(p) < 5 else f' tail {p[4]}'} {t:.4f} ms "
                    f"({e:.2g})" for t, p, e in times[:5])
        + f"; by splits: " + ", ".join(
            f"{p[2]} splits {e:.3g}" for t, p, e in
            sorted(times, key=lambda t: t[1][2]) if p[1] == chosen[1]
            and p[4:] == chosen[4:]) + f" {card}")


def plan_sweep(card):
    """Kernel A on PLAN_BUCKETS (seeded inputs at the paths' shapes) under
    every tile width of TILE_N and 1, 2, 4 or 8 k splits, in place of
    ``extract_fused.gemm_plan``'s choice, and kernel E on STATIC_BUCKETS
    under every width, 1, 2, 3, 4, 6 or 8 k splits and the tail folded
    into the last tile or not, in place of ``static_plan``'s: each plan
    held against the plain version and timed by graph_time (device time),
    beside the choice and the library call. The check of both rules on
    this card."""
    from fdc_tpu_torch.ops import extract_fused as ef

    rng = np.random.default_rng(6)
    for name, (rows, l, c, r, used) in PLAN_BUCKETS.items():
        spec, starts, mat, masks = kernel_a_inputs(rng, rows, 4096, l, c,
                                                   False, used)
        if r:
            def run():
                return ef.extract_shared_fold(spec, starts, mat, r)
            ref = ef.extract_shared_fold_plain(spec, starts, mat, r)
            _, _, _, library, _ = extract_work(spec, starts, mat)
            cmp = cmp_close("extract_shared_fold")
        else:
            a = (spec, starts, mat) + ((masks,) if used else ())
            kw = {"extent": ef.mask_extent(masks.cpu())} if used else {}

            def run():
                return ef.extract_shared(*a, **kw)
            ref = ef.extract_shared_plain(*a)
            _, _, _, library, cmp = extract_work(*a)
        m, k, nout = c * rows, mat.shape[0], mat.shape[1]
        chosen = ef.gemm_plan(m, nout, k)
        stages = k // ef.BK
        plans = {chosen}
        for bn in ef.TILE_N:
            for want in (1, 2, 4, 8):
                if want <= max(1, stages // ef.MIN_SPLIT_STAGES):
                    chunk = -(-stages // want)
                    plans.add((ef.TILE_M, bn, -(-stages // chunk),
                               chunk * ef.BK))
        sweep(name, f"[{m}, {k}] x [{k}, {nout}]"
              f"{f' + {used} measure columns' if used else ''}"
              f"{f', fold R={r}' if r else ''}", "gemm_plan", plans, chosen,
              run, ref, cmp, library, card)
    for name, (rows, l, c) in STATIC_BUCKETS.items():
        spec, starts, mats = kernel_e_inputs(rng, rows, 4096, l, c)
        k, nout = mats.shape[1:]
        chosen = ef.static_plan(c, rows, k, nout)
        stages = k // ef.BK
        plans = {chosen}
        for bn in ef.TILE_N:
            for want in (1, 2, 3, 4, 6, 8):
                if want <= max(1, stages // ef.MIN_SPLIT_STAGES):
                    chunk = -(-stages // want)
                    for tail in {chosen[4], 0}:
                        plans.add((ef.TILE_M, bn, -(-stages // chunk),
                                   chunk * ef.BK, tail))
        _, _, _, library, cmp = extract_work(spec, starts, mats)
        sweep(name, f"{c} x [{rows}, {k}] x [{k}, {nout}]", "static_plan",
              plans, chosen, lambda: ef.extract_static(spec, starts, mats),
              ef.extract_static_plain(spec, starts, mats), cmp, library,
              card)


def extract_proto_case(fdc, x):
    """Kernel E on the function of ``tools/pallas_extract_proto.py``
    (:52-68): the flagship's throughput bucket 0 with a folded matrix per
    channel, over the spectra of the capture's first batch."""
    import torch

    from fdc_tpu_torch.ops import extract, extract_fused
    from fdc_tpu_torch.ops.fft import forward_spectrum
    from fdc_tpu_torch.ops.framing import frame_blocks

    cfg, dev = fdc.config, fdc.device
    bucket = fdc.throughput.buckets[0]
    starts = torch.from_numpy(bucket.starts).to(dev)
    mats = torch.from_numpy(extract.static_folded_matrices(
        cfg.blocksize, bucket.starts, bucket.windows,
        bucket.width - bucket.out_len, float(bucket.width))).to(dev)
    blocks, _ = frame_blocks(
        torch.from_numpy(x[:fdc.batch_samples]).to(dev),
        torch.zeros(cfg.ovllen, dtype=torch.complex64, device=dev),
        cfg.blocksize)
    spec = forward_spectrum(blocks, use_mxu=True)
    what, bytes_, flops, library, cmp = extract_work(spec, starts, mats)
    return case("extract_static",
                lambda: extract_fused.extract_static(spec, starts, mats),
                lambda: extract_fused.extract_static_plain(spec, starts,
                                                           mats),
                cmp, f"tools/pallas_extract_proto.py: flagship bucket 0 "
                f"{what}", bytes_, flops, library)


def call_case(path, name, fn, plain, a, kw):
    """A kernel case from one recorded call of a path's step."""
    if name == "forward_fft":
        return fft_case(f"{path} {list(a[0].shape)}", a[0], fn, plain)
    if name in ("extract_shared", "extract_static", "extract_shared_fold"):
        # the fold's yardstick is the product alone, without the rotation
        fold = name == "extract_shared_fold"
        what, bytes_, flops, library, cmp = extract_work(
            *(a[:3] if fold else a), **kw)
        cs = case(name, lambda: fn(*a, **kw), lambda: plain(*a, **kw),
                  cmp, f"{path} {what}", bytes_, flops, library)
        if fold:
            # the same bucket unfolded: kernel A, then apply_phase_pairs
            from fdc_tpu_torch.ops import extract, extract_fused

            spec, starts, mat, r = a
            rows = extract._row_phases(starts, spec.shape[0], r)
            cs["shape"] += f", fold R={r}"
            cs["unfolded"] = lambda: extract.apply_phase_pairs(
                extract_fused.extract_shared(spec, starts, mat), rows, r)
        return cs
    if name == "candidate_packs":
        return pack_case(path, *a, kern=fn, plain=plain)
    out = plain(*a, **kw)
    if name == "slot_lifecycle":
        pa = kw.get("powact")
        what = (f"packs {[list(p.shape) for p in a[0]]}, S="
                f"{[int(st['active'].numel()) for st in a[1]]}, burst C="
                f"{pa['powers'].shape[1] if pa else 0}, "
                f"{candidate_stats(a[0], kw['n_cands'])}")
    else:
        what = f"powers {list(a[0].shape)}"
    flops = 2.0 * a[0].numel() if name == "powact" else 0.0  # two divisions
    return case(name, lambda: fn(*a, **kw), lambda: plain(*a, **kw),
                cmp_exact, f"{path} {what}", nbytes((a, kw)) + nbytes(out),
                flops)


def pack_case(what, powers, specs, kern=None, plain=None):
    """Kernel B on G segments' powers. The bound: the powers read and the
    packs written once, a division a ratio. The case names each segment's
    [B, n_cells], its K and its rows' dependent steps: ratio chunks, and
    the acceptance chain's one step a paired candidate among the ranked
    rises (mean and most a block)."""
    from fdc_tpu_torch.ops import detect

    kern = kern or detect.candidate_packs
    plain = plain or detect.candidate_packs_plain
    out = plain(powers, specs)
    segs = []
    for p, spec in zip(powers, specs):
        _, _, paired = detect.detect_edges(p, spec.thresh, spec.k_detect,
                                           spec.zero_floor)
        n = paired.sum(1).float()
        segs.append(f"[{p.shape[0]}, {p.shape[1]}] K={spec.k_pack} "
                    f"chunks {-(-(p.shape[1] - 1) // 32)} chain mean "
                    f"{float(n.mean()):.2f} max {int(n.max())}")
    rows = powers[0].shape[0]
    return case("candidate_packs", lambda: kern(powers, specs),
                lambda: plain(powers, specs), cmp_exact,
                f"{what} {'; '.join(segs)}",
                sum(p.shape[0] * p.shape[1] * 4 for p in powers)
                + nbytes(out),
                sum(rows * (p.shape[1] - 1) for p in powers))


def greedy_case(what, power, spec):
    """Kernel B's acceptance chain alone (``greedy_accept_batch``) on a
    segment's ranked, paired candidates (``detect_edges`` of its
    powers)."""
    from fdc_tpu_torch.ops import detect

    a = detect.detect_edges(power, spec.thresh, spec.k_detect,
                            spec.zero_floor)
    out = detect.greedy_accept_batch_plain(*a)
    return case("greedy_accept", lambda: detect.greedy_accept_batch(*a),
                lambda: detect.greedy_accept_batch_plain(*a), cmp_exact,
                f"{what} candidate rows {list(a[0].shape)}",
                nbytes(a) + nbytes(out))


def pack_edge_cases():
    """Kernel B on each edge case of ``tests/test_torch_kernels.py``
    (``PACK_EDGES``: every position a rise, equal and infinite ratio ties,
    0/0 with and without zero_floor, K below the ratio count, touching
    intervals, empty blocks, a negative ext_start, 2048 cells), 512
    blocks (64 at 2048 cells, where the plain version's K x K overlap
    tensor is large), and the acceptance chain alone on the first."""
    import torch

    from fdc_tpu_torch.models.segment_detection import SegmentDetector

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_kernels import PACK_EDGES, pack_edge

    out = []
    for name in PACK_EDGES:
        args, kw, power = pack_edge(name, 64 if name == "max-cells" else 512)
        spec = SegmentDetector(*args, **kw).pack_spec
        p = torch.from_numpy(power).to("cuda")
        out.append(pack_case(f"edge {name}", [p], [spec]))
        if name == "alternating":
            out.append(greedy_case(f"edge {name}", p, spec))
    return out


def powact_case(what, nb, c, r, seed, delta=None, thresh=10.0):
    """Kernel D on [nb, c] powers straddling the threshold, with the init
    (lastpower = FLT_MAX) and floor (FLT_MIN) edges, phases in [0, R)."""
    import torch

    from fdc_tpu_torch.ops import powact

    rng = np.random.default_rng(seed)
    pw = np.exp(rng.normal(0.0, 2.0, (nb, c))).astype(np.float32)
    pw[rng.random((nb, c)) < 0.02] = FLT_MIN  # floored silence
    lp = np.exp(rng.normal(0.0, 2.0, c)).astype(np.float32)
    lp[::3] = FLT_MAX  # freshly initialised channels
    if delta is None:
        delta = torch.from_numpy(rng.integers(-9, 10, c).astype(np.int32))
    state = {
        "active": torch.from_numpy(rng.random(c) < 0.5),
        "lastpower": torch.from_numpy(lp),
        "phase": torch.from_numpy(rng.integers(0, r, c).astype(np.int32)),
    }
    a = (torch.from_numpy(pw).to("cuda"),
         {k: v.to("cuda") for k, v in state.items()}, delta.to("cuda"))
    kw = dict(r=r, thresh=thresh)
    if nb >= 31:
        rise, fall = powact.powact_flags_plain(*a, **kw)[1][:2]
        assert bool(rise.any()) and bool(fall.any()), "powact case: no edge"
    return call_case(what, "powact", powact.powact_flags,
                     powact.powact_flags_plain, a, kw)


def powact_scan_cases():
    """Kernel D's warp scan at B in {1, 31, 33, 512} (a run of one block,
    lanes without blocks, whole runs) and R in {1, 2, 4, 8}, 32
    channels."""
    out = []
    for nb in (1, 31, 33, 512):
        for r in (1, 2, 4, 8):
            cs = powact_case("scan", nb, 32, r, seed=nb * 10 + r)
            cs["shape"] += f", R={r}"
            out.append(cs)
    return out


def candidate_stats(packs, n_cands):
    """Per segment of kernel C's call: the blocks with a valid candidate,
    the mean and the most valid candidates such a block holds (the list
    the chain walks), and whether they sit at the front of the pack."""
    out = []
    for p, k in zip(packs, n_cands):
        cv = (p[:, 2 * k:3 * k] != 0).cpu().numpy()
        nv = cv.sum(1)
        busy = nv > 0
        front = bool((cv == (np.arange(k)[None, :] < nv[:, None])).all())
        out.append(f"{int(busy.sum())} of {len(nv)} blocks busy, nv mean "
                   f"{nv[busy].mean() if busy.any() else 0.0:.2f} max "
                   f"{int(nv.max())}{'' if front else ' (not compacted)'}")
    return "; ".join(out)


def powact_edge_case(fdc_pa):
    """Kernel D at config 3's shapes and increments on powers straddling
    the threshold, with the init and floor edges."""
    pa = fdc_pa.power_bank
    cs = powact_case("powact32 edges", fdc_pa.config.batch_blocks,
                     pa.num_channels, pa.relinvovl, 3, delta=pa.delta.cpu(),
                     thresh=pa.thresh)
    cs["shape"] += ", FLT_MAX / FLT_MIN edges"
    return cs


def tone_check(res, fdc, tone_bin, from_block=4):
    """Amplitude and SNR of an exact-bin tone in the throughput channel
    centred nearest to it, from block ``from_block`` on (a tone at the
    channel's offset frequency)."""
    tp = fdc.throughput
    n = fdc.config.blocksize
    f0 = tone_bin / n
    chan = min(
        range(tp.num_channels),
        key=lambda i: abs((tp.geometry[i].start + tp.geometry[i].width / 2)
                          - (f0 + 0.5) * n),
    )
    bucket = next(b for b in tp.buckets if chan in b.channel_ids)
    # float64: float32 phases unwrapped over the 32768-point flagship's
    # 4e5 samples lose the fit (the unwrap's running sum rounds)
    y = res.throughput[chan][max(2000, from_block * bucket.out_len):].astype(
        np.complex128)
    ph = np.unwrap(np.angle(y))
    fit = np.polyfit(np.arange(len(ph)), ph, 1)
    amp = float(np.abs(y).mean())
    tone = np.exp(1j * np.polyval(fit, np.arange(len(ph))))
    snr = float(-10 * np.log10(np.mean(np.abs(y / amp - tone) ** 2) + 1e-30))
    return chan, amp, snr


def event_kinds(events):
    """{source: count} and {burst channel: finished bursts}."""
    kinds, fins = {}, {}
    for ev in events:
        src = ev.ID.split(".")[1]
        kinds[src] = kinds.get(src, 0) + 1
        if src == "PowActChan" and ev.finalized:
            c = int(ev.ID.split(".")[2])
            fins[c] = fins.get(c, 0) + 1
    return kinds, fins


@contextlib.contextmanager
def plan_tally(fdc):
    """Count, over the steps run inside the block, the real (not
    sentinel) rows the detection segments' plans ship in the narrow and
    the wide bucket, and the largest ``ext_overflow``; on a split
    segment also the slots its cut reconciliation killed and the
    candidates it suppressed."""
    tally = {"narrow": 0, "wide": 0, "overflow": 0}
    segs = list(getattr(fdc, "segments", ()))
    split = [segs[i] for i in getattr(fdc, "_split_neighbors", ())]
    if split:
        tally.update(killed=0, suppressed=0)
    for sd in split:
        def reconcile(state, packed, kill_from, suppress_from, sd=sd,
                      orig=sd.reconcile_split):
            st, pk, killed = orig(state, packed, kill_from, suppress_from)
            k = sd.k_pack
            tally["killed"] += int(killed.sum())
            tally["suppressed"] += int((packed[:, 2 * k:3 * k] != 0).sum()
                                       - (pk[:, 2 * k:3 * k] != 0).sum())
            return st, pk, killed
        sd.reconcile_split = reconcile
    for sd in segs:
        def plan(seg_state, flags, sd=sd, orig=sd.plan_outputs):
            so = orig(seg_state, flags)
            s = sd.max_slots
            tally["wide"] += int((so["slot_ids"] < s).sum())
            if "slot_ids_narrow" in so:
                tally["narrow"] += int((so["slot_ids_narrow"] < s).sum())
            tally["overflow"] = max(tally["overflow"],
                                    int(so["ext_overflow"]))
            return so
        sd.plan_outputs = plan
    try:
        yield tally
    finally:
        for sd in segs:
            del sd.plan_outputs
        for sd in split:
            del sd.reconcile_split


def run_path(name, fdc, x, expect, tag="phase 3"):
    """Phase 3 for one path: :func:`drive` with the launch counts zeroed
    just before and read just after; checks that every kernel of the path
    ran, blocks and finite events. Returns the whole batches' result,
    the event kinds, the finished bursts per burst channel, the launches
    and the detection plans' tally."""
    import torch

    cfg = fdc.config
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    t = time.perf_counter()
    with plan_tally(fdc) as tally:
        res, fin = drive(fdc, x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in cnt.items()}
    events = res.events + fin.events
    blocks = res.blocks_processed + fin.blocks_processed
    assert blocks == math.ceil(len(x) / cfg.inplen), (name, blocks)
    for k in expect:
        assert launches[k] > 0, f"{k} was not launched on the {name} path"
    assert all(ev.blockend >= ev.blockstart >= 0 for ev in events)
    assert all(np.all(np.isfinite(ev.data)) for ev in events)
    for s in res.throughput:
        assert np.all(np.isfinite(s)), name
    kinds, chans = event_kinds(events)
    fins = sum(ev.finalized for ev in events)
    log(f"{tag}: {name}: {blocks} blocks in {wall:.2f} s (host clock); "
        f"events {kinds}, {fins} finalized; launches {launches}"
        + (f"; plans {tally}" if fdc.segments else ""))
    return res, kinds, chans, launches, tally, fins, fin


def spectra_check(name, fdc, x, res):
    """Phase 3 for configs 4 and 5: ``process_spectra`` on the same
    channelizer, fed :func:`card_spectra` of the capture's whole batches:
    the same events as ``process`` gave."""
    spectra = card_spectra(fdc.config, x, fdc.device)
    fdc.reset()
    ev = fdc.process_spectra(np.concatenate(spectra)).events
    compare_events(ev, res.events, f"{name} process_spectra")
    fdc.flush()
    fdc.reset()
    log(f"phase 3: {name}: process_spectra on the card's spectra of "
        f"{len(spectra)} batches: {len(ev)} events, equal to process()")


def compare_cpu(name, make, x, tag="phase 4"):
    """Phase 4 for one path: two steps and two batches' events, card
    against the CPU plain path."""
    import torch

    cpu, gpu = make("cpu"), make("cuda")
    cfg, dev = gpu.config, gpu.device
    cc, gc = cpu._device_init(), gpu._device_init()
    bs = gpu.batch_samples
    worst = worst_rel = 0.0
    for step in range(2):
        chunk = torch.from_numpy(x[step * bs:(step + 1) * bs])
        cc, co = cpu._device_step(cc, chunk, step * cfg.batch_blocks)
        gc, go = gpu._device_step(gc, chunk.to(dev), step * cfg.batch_blocks)
        err, rel = compare_outputs(go, co, f"{name} step {step}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        compare_outputs(gc, cc, f"{name} carry after step {step}")
    ev_c, ev_g = ([e for r in drive(f, x[:2 * bs]) for e in r.events]
                  for f in (cpu, gpu))
    compare_events(ev_g, ev_c, f"{name} events")
    log(f"{tag}: {name}: 2 steps card == cpu plain (max abs err "
        f"{worst:.3g}; streams and extractions within {worst_rel:.3g} of "
        f"their max), {len(ev_g)} events identical")


def dispatched(fn):
    """(aten operations one call of fn() dispatches, views and
    allocations left out: on CUDA tensors each other one launches a
    kernel or a copy; the hand-written kernels' launches)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not (func.is_view or str(func).startswith("aten.empty")):
                self.n += 1
            return func(*args, **(kwargs or {}))

    cnt = counters()
    before = sum(f.launches for f in cnt.values())
    with Count() as c:
        fn()
    return c.n, sum(f.launches for f in cnt.values()) - before


def time_step(name, fdc, x, card, top=8):
    """Phase 5 for one path: the step time by CUDA events (carry fed
    forward), then the same with the cuFFT front end and with kernel F
    again, the host time to enqueue one step, the device busy time of a
    step with the stream held (``held_time``) and its idle share of the
    step time, a torch.profiler breakdown of 3 of the same steps (device
    launches, busy time, the heaviest kernels) where the profiler sees
    the card, and the plain path's step time."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    xb = torch.from_numpy(x[:fdc.batch_samples]).to(fdc.device)
    carry = [fdc._device_init()]

    def step():
        carry[0], _ = fdc._device_step(carry[0], xb, 0)

    ms = cuda_time(step, 20)
    with cufft_front_end():
        ms_cufft = cuda_time(step, 20)
    ms_again = cuda_time(step, 20)
    enqueue = []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        enqueue.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    held = [held_time(step, 3 * max(enqueue) + 5.0) for _ in range(5)]
    held = [h for h in held if h is not None]
    if held:
        busy = statistics.median(held)
        held_txt = (f"device busy {busy:.4f} ms/step with the stream held "
                    f"({len(held)} of 5 steps), idle share "
                    f"{1 - busy / ms:.3f}")
    else:
        held_txt = ("device busy with the stream held: not measured (the "
                    "host was still enqueueing when the hold ended)")
    n_steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if dev:
        busy = sum(by_name.values()) / 1e3 / n_steps
        prof_txt = (f"profiler: {len(dev) / n_steps:.0f} device "
                    f"launches/step, kernels busy {busy:.4f} ms/step, idle "
                    f"share {1 - busy / ms:.3f}")
    else:
        prof_txt = "profiler: recorded no device time on this card"
    ops, kern = dispatched(step)
    with plain_path():
        ms_plain = cuda_time(step, 3)
    bs = fdc.batch_samples
    log(f"phase 5: {name} step B={fdc.config.batch_blocks}: kernel path "
        f"{ms:.4f} ms ({bs / ms / 1e3:.1f} MS/s), plain path "
        f"{ms_plain:.4f} ms ({bs / ms_plain / 1e3:.1f} MS/s); cuFFT front "
        f"end {ms_cufft:.4f} ms between kernel F's {ms:.4f} and "
        f"{ms_again:.4f} ms; host enqueue "
        f"median {statistics.median(enqueue):.4f} ms; {held_txt}; "
        f"{prof_txt}; dispatched {ops} aten ops + {kern} hand-written "
        f"launches/step {card}")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {us / 1e3 / n_steps:.4f} ms/step  {kname[:110]}")


def channelizer(cfg):
    """A maker of the path's channelizer on a device."""
    def make(device):
        from fdc_tpu_torch import FrequencyDomainChannelizer

        return FrequencyDomainChannelizer(cfg, device=device)
    return make


def path_table():
    """(name, maker, capture, kernels it must launch) of every path; a
    capture maps (channelizer, samples) to (samples, scripted detection
    carriers or None)."""
    from fdc_tpu_torch.flagship import (
        _flagship,
        cfg2_dama16,
        cfg4_segdet,
        cfg5_burst_hunter512,
        cfg5b_burst_hunter_4seg,
        cfg5s_burst_hunter_split4,
        powact32,
        reference_example,
    )

    def on_config(capture):
        return lambda fdc, n: (capture(fdc.config, n), None)

    # every path's front end is kernel F
    detection = ("forward_fft", "candidate_packs", "slot_lifecycle")
    return (
        ("flagship", channelizer(_flagship(batch_blocks=512)),
         on_config(scripted_capture),
         ("forward_fft", "extract_shared", "candidate_packs",
          "slot_lifecycle")),
        ("example", channelizer(reference_example()),
         on_config(burst_capture),
         ("forward_fft", "extract_static", "extract_shared",
          "candidate_packs", "slot_lifecycle")),
        ("powact32", channelizer(powact32()), on_config(burst_capture),
         ("forward_fft", "powact", "extract_shared")),
        ("dama16", channelizer(cfg2_dama16()), on_config(burst_capture),
         ("forward_fft", "extract_shared_fold")),
        ("segdet", channelizer(cfg4_segdet()), carrier_capture, detection),
        ("hunter512", channelizer(cfg5_burst_hunter512()), carrier_capture,
         detection),
        ("hunter4seg", channelizer(cfg5b_burst_hunter_4seg()),
         carrier_capture, detection),
        ("split4", channelizer(cfg5s_burst_hunter_split4()), split_capture,
         detection),
        ("vcm4seg", lambda device: VcmPath(cfg5b_burst_hunter_4seg(),
                                           device),
         carrier_capture, detection),
    )


def check_path(name, p, res, kinds, chans, tally, fins):
    """Phase 3's checks of what each path's capture scripted."""
    fdc = p["fdc"]
    cfg = fdc.config
    if name == "flagship":
        chan, amp, snr = tone_check(res, fdc, TONE_BIN)
        assert abs(amp - 1.0) < 0.05 and snr > 25.0, (amp, snr)
        assert kinds.get("PowActChan", 0) >= 1
        assert kinds.get("DETECTED", 0) >= 3
        log(f"phase 3: flagship tone in channel {chan}: amp {amp:.4f}, "
            f"SNR {snr:.1f} dB")
        return
    if p["carriers"] is not None:
        # every scripted carrier finished as a detection; both buckets
        # shipped real slots, and config 4's budgets overflowed
        assert fins >= p["carriers"], (name, fins, p["carriers"])
        assert tally["narrow"] > 0 and tally["wide"] > 0, (name, tally)
        if name == "segdet":
            assert tally["overflow"] > 0, (name, tally)
        if name == "split4":
            # the cut carriers made duplicates that the kill rule
            # discarded, and candidates the ownership rule suppressed
            assert tally["killed"] > 0 and tally["suppressed"] > 0, tally
        log(f"phase 3: {name}: {fins} finished detections of "
            f"{p['carriers']} scripted carriers")
        return
    n_pa = len(cfg.activity_controlled_channels)
    # each burst channel's one scripted carrier, and nothing else
    assert chans == {c: 1 for c in range(n_pa)}, (name, chans)
    if cfg.activity_detection_segments:
        assert kinds.get("DETECTED", 0) >= 3, (name, kinds)
    tones = []
    for f, _ in cfg.throughput_channels:
        chan, amp, snr = tone_check(
            res, fdc, round(f * cfg.blocksize),
            from_block=int((GATES_END + 0.2) * cfg.batch_blocks))
        assert abs(amp - BURST_TONE) < 0.05 * BURST_TONE and snr > 25.0, (
            name, chan, amp, snr)
        tones.append((amp, snr))
    if tones:
        amps, snrs = zip(*tones)
        log(f"phase 3: {name} tones in {len(tones)} channels: amp "
            f"{min(amps):.4f}-{max(amps):.4f}, SNR >= {min(snrs):.1f} dB")


# -- phase 7: the host runtime -------------------------------------------

# the detection path's kernels, and the flagship's (kernel A's measures)
DETECT_KERNELS = ("forward_fft", "candidate_packs", "slot_lifecycle")
FLAGSHIP_KERNELS = DETECT_KERNELS + ("extract_shared",)


def counted(what, expect, fn):
    """fn() with every kernel's launch count zeroed just before and read
    just after; fails if a kernel of ``expect`` was not launched.
    Returns (fn's result, host seconds)."""
    import torch

    cnt = counters()
    for f in cnt.values():
        f.launches = 0
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: f.launches for k, f in cnt.items() if f.launches}
    for k in expect:
        assert launches.get(k, 0) > 0, f"{k} was not launched by {what}"
    log(f"phase 7: {what}: {wall:.2f} s (host clock); launches {launches}")
    return out, wall


def cli_outputs(*dirs):
    """The joined outputs of command-line runs, each an ``--out-dir`` with
    its ``--events-jsonl`` beside it (``<dir>.jsonl``): (event dicts with
    nsamples and without the timestamped ID prefix, {throughput file:
    samples}, {payload file without the prefix: samples})."""
    events, streams, payloads = [], {}, {}
    for d in dirs:
        for line in d.with_suffix(".jsonl").read_text().splitlines():
            ev = json.loads(line)
            ev["ID"] = ev["ID"].split(".", 1)[1]
            events.append(ev)
        for f in sorted(d.iterdir()):
            x = np.fromfile(f, np.complex64)
            if f.name.startswith("throughput_ch"):
                streams[f.name] = np.concatenate(
                    [streams.get(f.name, np.zeros(0, np.complex64)), x])
            else:
                payloads[f.name.split(".", 1)[1]] = x
    return events, streams, payloads


def reference_outputs(results, payload_dir=None):
    """:func:`cli_outputs` of in-process results (``payload_dir``: where
    their channelizer's FileSink wrote the payloads, if it did)."""
    events = []
    for ev in (e for r in results for e in r.events):
        d = event_meta(ev)
        d["nsamples"] = int(len(ev.data))
        events.append(d)
    streams = {f"throughput_ch{i}.c64": np.concatenate(
        [r.throughput[i] for r in results])
        for i in range(len(results[0].throughput))}
    payloads = {} if payload_dir is None else {
        f.name.split(".", 1)[1]: np.fromfile(f, np.complex64)
        for f in sorted(Path(payload_dir).iterdir())}
    return events, streams, payloads


def compare_cli(what, got, ref):
    """Event metadata exact; streams within the stream tolerance of each
    file's max; payloads as one stream."""
    ev, streams, payloads = got
    ev_ref, streams_ref, payloads_ref = ref
    assert len(ev) == len(ev_ref), f"{what}: {len(ev)} vs {len(ev_ref)}"
    for a, b in zip(ev, ev_ref):
        assert a == b, (what, a, b)
    assert streams.keys() == streams_ref.keys(), what
    worst = 0.0
    for name in streams:
        assert streams[name].shape == streams_ref[name].shape, (what, name)
        ok, err = close(streams[name], streams_ref[name], RTOL, ATOL)
        assert ok, f"{what}: {name} max abs err {err}"
        worst = max(worst, err)
    assert sorted(payloads) == sorted(payloads_ref), what
    if payloads:
        ok, err = close(np.concatenate([payloads[k] for k in sorted(payloads)]),
                        np.concatenate([payloads_ref[k]
                                        for k in sorted(payloads)]),
                        RTOL, ATOL)
        assert ok, f"{what}: event files max abs err {err}"
        worst = max(worst, err)
    log(f"phase 7: {what}: {len(ev)} events, {len(streams)} streams, "
        f"{len(payloads)} event files equal to the reference (max abs err "
        f"{worst:.3g})")


def emitter_walls(name, p, card):
    """The path's process() + flush() with the Python and the native
    emitters, alternated twice: equal events, and each run's host
    seconds. Returns the native run's results."""
    import torch

    from fdc_tpu_torch import FrequencyDomainChannelizer
    from fdc_tpu_torch.runtime.emission import NativeSegmentDetectionEmitter

    walls, events, results = {False: [], True: []}, {}, None
    for native in (False, True, False, True):
        fdc = FrequencyDomainChannelizer(
            p["fdc"].config.replace(native_emission=native), device="cuda")
        assert isinstance(fdc.segment_emitters[0],
                          NativeSegmentDetectionEmitter) == native
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = [fdc.process(p["x"]), fdc.flush()]
        torch.cuda.synchronize()
        walls[native].append(time.perf_counter() - t)
        events[native] = [e for r in res for e in r.events]
        if native:
            results = res
    compare_events(events[True], events[False], f"{name} native emitters")
    fmt = ", ".join
    log(f"phase 7: {name}: process() + flush() of {len(p['x'])} samples, "
        f"{len(events[True])} events equal: Python emitters "
        f"{fmt(f'{w:.4f}' for w in walls[False])} s, native emitters "
        f"{fmt(f'{w:.4f}' for w in walls[True])} s (host clock) {card}")
    return results


def runtime_phase(paths, card):
    """Phase 7: the host runtime on the card. The flagship and hunter4seg
    with the native and the Python emitters (equal events, both host
    walls); ``python -m fdc_tpu_torch run`` on the flagship in a process of
    its own, and split by ``--checkpoint`` / ``--resume`` in this one;
    ``vcm`` on config 5b; ``StreamDriver.run_file`` over the native file
    source. Every run's outputs equal process() + flush() (VcmPath.stream
    for vcm); the native emitters and the native ring are asked for
    explicitly (``native_emission=True``, ``use_native=True``), so a g++
    failure fails the phase instead of falling back."""
    import io
    import tempfile

    from fdc_tpu_torch import (
        FrequencyDomainChannelizer,
        ProcessResult,
        StreamDriver,
    )
    from fdc_tpu_torch.__main__ import main as cli

    from fdc_tpu_torch.runtime import native

    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()[:1]
    log(f"phase 7: native runtime {native._build()} ({'; '.join(gxx)})")
    flag = paths["flagship"]
    emitter_walls("flagship", flag, card)
    emitter_walls("hunter4seg", paths["hunter4seg"], card)

    def quiet(argv):
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli(argv) == 0, argv

    cfg = flag["fdc"].config.replace(native_emission=True)
    x = flag["x"]
    cut = 2 * cfg.batch_blocks * cfg.inplen + 777  # a burst open, slots live
    with tempfile.TemporaryDirectory(prefix="fdc_phase7_") as tmp:
        tmp = Path(tmp)
        (tmp / "flagship.json").write_text(cfg.to_json())
        x.tofile(tmp / "cap.c64")
        x[:cut].tofile(tmp / "a.c64")
        x[cut:].tofile(tmp / "b.c64")
        ref_dir = tmp / "ref"
        ref_dir.mkdir()
        fdc = FrequencyDomainChannelizer(
            cfg.replace(fileoutput=True, outputpath=str(ref_dir)),
            device="cuda")
        ref = reference_outputs([fdc.process(x), fdc.flush()], ref_dir)

        def run_args(capture, out, *extra):
            return ["run", str(tmp / "flagship.json"), str(tmp / capture),
                    "--out-dir", str(tmp / out), "--events-jsonl",
                    str(tmp / f"{out}.jsonl"), *extra]

        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "fdc_tpu_torch",
             *run_args("cap.c64", "cli")],
            cwd=Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        log(f"phase 7: python -m fdc_tpu_torch run (flagship, a process of "
            f"its own): {time.perf_counter() - t:.2f} s (host clock, "
            f"start-up included); "
            + "; ".join(proc.stdout.strip().splitlines()[:5]))
        compare_cli("run", cli_outputs(tmp / "cli"), ref)

        ck = str(tmp / "state.ckpt")
        counted("run --checkpoint, then run --resume (flagship)",
                FLAGSHIP_KERNELS,
                lambda: (quiet(run_args("a.c64", "head", "--checkpoint",
                                        ck)),
                         quiet(run_args("b.c64", "tail", "--resume", ck))))
        compare_cli("run --checkpoint / --resume",
                    cli_outputs(tmp / "head", tmp / "tail"), ref)

        fdc = FrequencyDomainChannelizer(cfg, device="cuda")
        drv = StreamDriver(fdc, use_native=True)
        res, _ = counted("StreamDriver.run_file (flagship)", FLAGSHIP_KERNELS,
                         lambda: drv.run_file(str(tmp / "cap.c64")))
        assert drv.stats.samples_in == len(x)
        compare_cli("StreamDriver.run_file", reference_outputs(res),
                    (*ref[:2], {}))

        vp = paths["vcm4seg"]
        vcfg = vp["fdc"].config.replace(native_emission=True)
        xv = vp["x"][:len(vp["x"]) // vcfg.inplen * vcfg.inplen]
        (tmp / "cfg5b.json").write_text(vcfg.to_json())
        xv.tofile(tmp / "vcm.c64")
        counted("vcm (config 5b)", DETECT_KERNELS, lambda: quiet([
            "vcm", str(tmp / "cfg5b.json"), str(tmp / "vcm.c64"),
            "--out-dir", str(tmp / "vcm"), "--events-jsonl",
            str(tmp / "vcm.jsonl")]))
        events, _ = vp["fdc"].stream(xv)
        ref_v = reference_outputs([ProcessResult(events=events)])
        compare_cli("vcm", cli_outputs(tmp / "vcm"), (
            *ref_v[:2], {e.filename.split(".", 1)[1]: e.data
                         for e in events}))


# -- phase 8: the MPMD batch pipeline and its cross-process leg ----------


def run_outputs(results):
    """(events, throughput streams, segment powers) of a run's results."""
    events = [e for r in results for e in r.events]
    streams = [np.concatenate([r.throughput[i] for r in results])
               for i in range(len(results[0].throughput))]
    powers = [np.concatenate([r.segment_power[i] for r in results])
              for i in range(len(results[0].segment_power))]
    return events, streams, powers


def compare_runs(what, got, ref):
    """Events as phase 4 (metadata exact, samples as one stream), streams
    within the stream tolerance, segment powers within PRTOL of their
    max; the largest error."""
    ev, streams, powers = run_outputs(got)
    ev_ref, streams_ref, powers_ref = run_outputs(ref)
    compare_events(ev, ev_ref, what)
    worst = 0.0
    for a, b, (rtol, atol) in (
            [(a, b, (RTOL, ATOL)) for a, b in zip(streams, streams_ref)]
            + [(a, b, (0.0, PRTOL)) for a, b in zip(powers, powers_ref)]):
        assert a.shape == b.shape, what
        ok, err = close(a, b, rtol, atol)
        assert ok, f"{what}: max abs err {err}"
        worst = max(worst, err)
    if ev:
        worst = max(worst, close(np.concatenate([e.data for e in ev]),
                                 np.concatenate([e.data for e in ev_ref]),
                                 RTOL, ATOL)[1])
    return len(ev), worst


def timed(fn):
    """fn() with every kernel's launch count zeroed just before and read
    just after: (result, host seconds, launches)."""
    import torch

    cnt = counters()
    for f in cnt.values():
        f.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return out, wall, {k: f.launches for k, f in cnt.items() if f.launches}


def plain_wall(p):
    """process() + flush() of the path on a new plain channelizer: the
    host wall the pipeline runs stand beside (phase 3's run paid each
    path's first-call costs)."""
    fdc = p["make"]("cuda")
    res, wall, _ = timed(lambda: [fdc.process(p["x"]), fdc.flush()])
    compare_runs("plain again", res, p["ref"])
    return wall


def restart(fdc):
    """A new stream on ``fdc``: ``reset()`` and the emitters' state of
    construction (``reset()`` keeps their counters, which name events)."""
    emitters = [fdc.power_emitter, *fdc.segment_emitters]
    if not hasattr(fdc, "_fresh_emitters"):
        fdc._fresh_emitters = [e and e.get_state() for e in emitters]
    fdc.reset()
    for e, st in zip(emitters, fdc._fresh_emitters):
        if e is not None:
            e.set_state(st)


def pipe_run(what, fdc, drive, ref, expect, plain, card, warm=True,
             tag="phase 8"):
    """One phase-8 (or ``tag``) run: ``drive()``'s results (``fdc`` the
    channelizer that ends the run) held against ``ref``; its wall beside
    ``plain``'s. With ``warm``, the stream again on the same channelizer
    (its lanes' new CUDA streams paid their first-use costs in the first
    run), held and timed the same way. Returns the last run's launches
    and steps."""
    walls = []
    for _ in range(2 if warm else 1):
        restart(fdc)
        res, wall, launches = timed(drive)
        for k in expect:
            assert launches.get(k, 0) > 0, f"{k} was not launched by {what}"
        n_ev, err = compare_runs(what, res, ref)
        walls.append(f"{wall:.4f}")
    steps = fdc._t0 // fdc.config.batch_blocks
    log(f"{tag}: {what}: {' then '.join(walls)} s (host clock) against "
        f"plain {plain:.4f} s; {n_ev} events equal to phase 3 (max abs err "
        f"{err:.3g}); {steps} steps, launches {launches} {card}")
    return launches, steps


def reach_back_check(p):
    """Stage A's [1, N] reach-back row (kernel F) against row B of the
    previous batch's [B, N] call and the plain step's carried prev_spec:
    bit-equal (max abs err 0)."""
    import torch

    from fdc_tpu_torch.parallel import PipelineChannelizer

    cfg = p["fdc"].config
    bs = cfg.batch_blocks * cfg.inplen
    x = p["x"]
    pipe = PipelineChannelizer(cfg, devices=["cuda:0"])
    rows = []
    for b in range(2):
        rows.append(pipe._pipe_front(0, x[b * bs:(b + 1) * bs],
                                     b * cfg.batch_blocks)[5])
    plain = p["make"]("cuda")
    carry, _ = plain._device_step(plain._device_init(),
                                  torch.from_numpy(x[:bs]).cuda(), 0)
    torch.cuda.synchronize()
    err_body = float((rows[1][0] - rows[0][-1]).abs().max())
    err_carry = float((rows[1][0] - carry["prev_spec"]).abs().max())
    assert err_body == 0.0 and err_carry == 0.0, (err_body, err_carry)
    log(f"phase 8: flagship reach-back row: the [1, {cfg.blocksize}] "
        f"call equals row {cfg.batch_blocks} of the [{cfg.batch_blocks}, "
        f"{cfg.blocksize}] call and the carried prev_spec (max abs err "
        f"{err_body:.1f}, {err_carry:.1f})")


def hostpipe_run(p, tmp, plain, card):
    """A HostPipelineOwner here and ``python -m fdc_tpu_torch run
    --hostpipe-worker 1:2`` in a process of its own on the same card:
    batches 1, 3, ... run stages A and C in the worker. The owner's
    results equal phase 3's; the bytes of each message kind a batch."""
    from fdc_tpu_torch.parallel.hostpipe import HostPipelineOwner

    cfg = p["fdc"].config
    (tmp / "flagship.json").write_text(cfg.to_json())
    p["x"].tofile(tmp / "hostpipe.c64")
    owner = HostPipelineOwner(cfg, n_workers=1, devices=["cuda:0"],
                              timeout=300.0)
    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "fdc_tpu_torch", "run",
         str(tmp / "flagship.json"), str(tmp / "hostpipe.c64"),
         "--hostpipe-worker", "1:2", "--hostpipe-connect",
         f"127.0.0.1:{owner.port}"],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    sizes = {"PACKS": [], "OUT": [], "PLANS": []}
    waited = [0.0]
    try:
        owner.accept_workers()
        t_up = time.perf_counter() - t
        conn = owner._conns[0]
        get, send = conn.get, conn.send

        def counted_get(kind, timeout):
            t_get = time.perf_counter()
            b, payload = get(kind, timeout)
            waited[0] += time.perf_counter() - t_get
            sizes[kind].append(nbytes_np(payload))
            return b, payload

        def counted_send(kind, b, payload):
            sizes[kind].append(nbytes_np(payload))
            send(kind, b, payload)

        conn.get, conn.send = counted_get, counted_send
        res, wall, launches = timed(lambda: [owner.process(p["x"]),
                                             owner.flush()])
    finally:
        owner.close()
        try:
            out, _ = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert proc.returncode == 0, out[-4000:]
    for k in FLAGSHIP_KERNELS:
        assert launches.get(k, 0) > 0, f"{k} was not launched by the owner"
    n_ev, err = compare_runs("hostpipe", res, p["ref"])
    remote = len(sizes["OUT"])
    assert remote == len(sizes["PACKS"]) == len(sizes["PLANS"]) >= 1
    per = {k: sum(v) / max(1, len(v)) for k, v in sizes.items()}
    log(f"phase 8: hostpipe (flagship, owner here + a worker process on "
        f"the same card, worker start-up {t_up:.2f} s): {wall:.4f} s "
        f"(host clock) against plain {plain:.4f} s; {n_ev} events equal "
        f"to phase 3 (max abs err {err:.3g}); {remote} of "
        f"{owner._t0 // cfg.batch_blocks} batches in the worker, bytes a "
        f"batch: PACKS {per['PACKS']:.0f}, PLANS {per['PLANS']:.0f}, OUT "
        f"{per['OUT']:.0f}; the owner waited {waited[0]:.4f} s on the "
        f"worker's messages; owner launches {launches} {card}")
    log("phase 8: hostpipe worker: "
        + "; ".join(out.strip().splitlines()[-6:-3]))


def nbytes_np(tree):
    """Bytes of the numpy leaves of a decoded message."""
    if isinstance(tree, dict):
        return sum(nbytes_np(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes_np(v) for v in tree)
    return tree.nbytes if isinstance(tree, np.ndarray) else 0


def pipeline_phase(paths, card):
    """Phase 8: the MPMD batch pipeline on the card. Every run is held
    against its path's phase-3 process() + flush() and prints its host
    wall beside a new plain channelizer's process() + flush() of this
    phase, and the kernels it launched (counts zeroed just before the
    run, read just after). One card: every lane shares it, and one host
    thread enqueues every stage but the hostpipe worker's."""
    import tempfile

    from fdc_tpu_torch.parallel import PipelineChannelizer
    from fdc_tpu_torch.runtime.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    def lanes(n, **kw):
        return lambda p: lambda: PipelineChannelizer(
            p["fdc"].config, devices=["cuda:0"] * n, **kw)

    runs = (
        ("flagship", "1 lane", lanes(1), FLAGSHIP_KERNELS),
        ("flagship", "2 lanes", lanes(2), FLAGSHIP_KERNELS),
        ("flagship", "3 lanes, dedicated owner",
         lanes(3, dedicated_owner=True), FLAGSHIP_KERNELS),
        ("hunter4seg", "3 lanes, dedicated owner, 2 scan owners",
         lanes(3, dedicated_owner=True, scan_owners=2), DETECT_KERNELS),
        ("split4", "3 lanes, dedicated owner, 2 scan owners",
         lanes(3, dedicated_owner=True, scan_owners=2), DETECT_KERNELS),
        ("powact32", "2 lanes", lanes(2),
         ("forward_fft", "extract_shared", "powact")),
        ("example", "2 lanes", lanes(2),
         ("forward_fft", "extract_static", "extract_shared",
          "candidate_packs", "slot_lifecycle")),
    )
    walls = {}
    for name, what, make, expect in runs:
        p = paths[name]
        if name not in walls:
            walls[name] = plain_wall(p)
        fdc = make(p)()
        if "scan owners" in what:
            assert len(fdc._owner_groups) == 2, fdc._owner_groups
        pipe_run(f"{name}, {what}", fdc,
                 lambda f=fdc, x=p["x"]: [f.process(x), f.flush()],
                 p["ref"], expect, walls[name], card)
    reach_back_check(paths["flagship"])

    # segdet's vector mode, as phase 3's spectra_check
    p = paths["segdet"]
    spectra = np.concatenate(card_spectra(p["fdc"].config, p["x"], "cuda"))
    pipe = PipelineChannelizer(p["fdc"].config, devices=["cuda:0"] * 2)
    res, wall, launches = timed(lambda: pipe.process_spectra(spectra))
    compare_events(res.events, p["ref"][0].events, "segdet process_spectra")
    assert all(launches.get(k, 0) for k in DETECT_KERNELS[1:]), launches
    log(f"phase 8: segdet process_spectra, 2 lanes: {wall:.4f} s (host "
        f"clock); {len(res.events)} events equal to phase 3's process(); "
        f"launches {launches} {card}")

    flag = paths["flagship"]
    cfg = flag["fdc"].config
    x = flag["x"]
    cut = 2 * cfg.batch_blocks * cfg.inplen + 777  # a burst open, slots live
    with tempfile.TemporaryDirectory(prefix="fdc_phase8_") as tmp:
        tmp = Path(tmp)
        def make(kind):
            if kind == "plain":
                return flag["make"]("cuda")
            return PipelineChannelizer(cfg, devices=["cuda:0"] * 2)

        def split(a, b):
            head = a.process(x[:cut])
            save_checkpoint(a, str(tmp / "split.ckpt"))
            load_checkpoint(b, str(tmp / "split.ckpt"))
            return [head, b.process(x[cut:]), b.flush()]

        for save_kind, load_kind in (("plain", "pipeline"),
                                     ("pipeline", "plain")):
            a, b = make(save_kind), make(load_kind)
            restart(a)
            pipe_run(f"flagship checkpoint split {save_kind} -> "
                     f"{load_kind}", b, lambda a=a, b=b: split(a, b),
                     flag["ref"], FLAGSHIP_KERNELS, walls["flagship"], card,
                     warm=False)
        hostpipe_run(flag, tmp, walls["flagship"], card)


# -- phase 9: the sharded step over a mesh of ranks ----------------------


def flagship_prediction(t, c):
    """The flagship's launches a step at a T x C mesh: F on each time
    rank, kernel A's measured throughput bucket on each time rank's
    first chan rank and its fold on the others, the one-channel burst
    bucket (padded to a row a chan rank) on every rank, B on each time
    rank, C once."""
    pred = {"forward_fft": t, "extract_shared": t + t * c,
            "candidate_packs": t, "slot_lifecycle": 1}
    if c > 1:
        pred["extract_shared_fold"] = t * (c - 1)
    return pred


def sharded_prediction(name, t, c):
    """Launches a step of a phase-9 run at a T x C mesh of one process.
    hunter4seg / split4: no throughput bucket, C once an owner group (a
    chan rank, four segments). The example: E's two fused buckets on
    every rank, A's measured 1024 bucket on each time rank's first chan
    rank and its fold on the others. powact32: its burst bucket (no
    measures) on every rank, D once. dama16: the fold on every rank
    (b % R == 0)."""
    if name == "flagship":
        return flagship_prediction(t, c)
    common = {"forward_fft": t, "candidate_packs": t}
    if name in ("hunter4seg", "split4"):
        return {**common, "slot_lifecycle": min(c, 4)}
    if name == "example":
        pred = {**common, "extract_static": 2 * t * c, "extract_shared": t,
                "slot_lifecycle": 1}
        if c > 1:
            pred["extract_shared_fold"] = t * (c - 1)
        return pred
    if name == "powact32":
        return {"forward_fft": t, "extract_shared": t * c, "powact": 1}
    assert name == "dama16", name
    return {"forward_fft": t, "extract_shared_fold": t * c}


def per_step(launches, steps):
    return {k: v / steps for k, v in launches.items()}


def assert_predicted(what, launches, steps, pred):
    """The run's launches are ``steps`` times the predicted launches a
    step, kernel by kernel."""
    want = {k: v * steps for k, v in pred.items()}
    assert launches == want, (
        f"{what}: launches a step {per_step(launches, steps)}, predicted "
        f"{pred}")


def hold_calls(what, calls, expect, summary):
    """Every recorded kernel call (rank-local shapes) against its plain
    version on the same inputs, with phase 2's comparators; every kernel
    of ``expect`` must be among them. The errors join the kernel
    summary's."""
    import torch

    worst = {}
    for call in calls:
        cs = call_case(what, *call)
        got = cs["kern"]()
        torch.cuda.synchronize()
        err = cs["cmp"](got, cs["plain"]())
        ent = summary[cs["name"]]
        ent["max_abs_err"] = max(ent["max_abs_err"], err)
        worst[cs["name"]] = max(worst.get(cs["name"], 0.0), err)
    missing = set(expect) - set(worst)
    assert not missing, f"{what}: no call of {sorted(missing)} recorded"
    log(f"phase 9: {what}: its {len(calls)} kernel calls match their plain "
        f"versions; max abs err by kernel {worst}")


def multihost_run(p, tmp, plain, card):
    """``tools_torch/multihost_worker.py`` as two processes on the card
    over the flagship's config and capture: a 4x2 mesh whose time axis
    crosses the processes (gloo, host-staged). Both processes' events
    equal (their samples' hashes too); process 0's results equal phase
    3's."""
    import pickle

    cfg = p["fdc"].config
    (tmp / "mh.json").write_text(cfg.to_json())
    p["x"].tofile(tmp / "mh.c64")
    worker = Path(__file__).resolve().parent / "tools_torch" / (
        "multihost_worker.py")
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), "2",
         f"file://{tmp / 'mh_store'}", "--cuda", "--config",
         str(tmp / "mh.json"), "--capture", str(tmp / "mh.c64"), "--out",
         str(tmp / "mh.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    wall = time.perf_counter() - t
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-4000:]
    assert "PROC0 MULTIHOST==SINGLE OK" in outs[0], outs[0][-4000:]
    lines = [[ln for ln in out.splitlines() if ln.startswith(key)]
             for key, out in (("PROC0", outs[0]), ("PROC1", outs[1]))]
    ev = [[ln.split("EVENTS", 1)[1] for ln in ls if " EVENTS " in ln]
          for ls in lines]
    assert ev[0] and ev[0] == ev[1], "the processes' events differ"
    with open(tmp / "mh.pkl", "rb") as f:
        res = pickle.load(f)
    n_ev, err = compare_runs("multihost", res, p["ref"])
    walls = []
    for pid, ls in enumerate(lines):
        m = next(re.match(r"PROC\d WALL (\S+) s STEPS (\d+) LAUNCHES (.*)$",
                          ln) for ln in ls if " WALL " in ln)
        walls.append(m.group(1))
        # each process holds two time ranks of the 4x2 mesh
        assert_predicted(f"multihost process {pid}",
                         ast.literal_eval(m.group(3)), int(m.group(2)),
                         flagship_prediction(2, 2))
    log(f"phase 9: multihost (flagship, 2 processes x 4 ranks on the card, "
        f"a 4x2 mesh, gloo): {n_ev} events equal to phase 3 (max abs err "
        f"{err:.3g}) and equal in both processes; process() + flush() "
        f"in each process: {walls} s against plain {plain:.4f} s; both "
        f"processes {wall:.2f} s with start-up; each process's launches "
        f"a step as predicted, {flagship_prediction(2, 2)} {card}")


def idle_chain(fdc, card):
    """Kernel C's chain alone: the flagship segment's slot table over
    batches of blocks without a candidate, device time by CUDA graph
    replay at three batch lengths; the slope is the chain's cost a block
    (the wrapper's fixed kernels cancel)."""
    import torch

    from fdc_tpu_torch.ops import lifecycle

    sd = fdc.segments[0]
    times = {}
    for nb in (32, 512, 2048):
        packs = (torch.zeros((nb, 7 * sd.k_pack), dtype=torch.int32,
                             device="cuda"),)
        states = (sd.init_state("cuda"),)
        times[nb] = graph_time(lambda p=packs, s=states: (
            lifecycle.slot_lifecycle_multi(
                p, s, n_cands=(sd.k_pack,), rs=(sd.relinvovl,),
                delays=(sd.deactivation_delay,))))
    slope = (None if None in times.values() else
             (times[2048] - times[32]) / (2048 - 32) * 1e6)
    log(f"phase 9: kernel C's idle chain (S={sd.max_slots}, "
        f"K={sd.k_pack}, no candidates): device "
        f"{', '.join(f'{nb} blocks {fmt_ms(t)}' for nb, t in times.items())}"
        f"; {'not measured' if slope is None else f'{slope:.2f} ns'} a "
        f"block {card}")


def sharded_phase(paths, card, summary):
    """Phase 9: the sharded step on the card, its ranks streams of the
    one card. Every run is held against its path's phase-3 process() +
    flush() and prints its host wall beside a new plain channelizer's and
    the kernels it launched a step (counts zeroed just before the run,
    read just after), which must equal the predicted ones; its kernel
    calls are then held against their plain versions."""
    import tempfile

    import torch

    from fdc_tpu_torch.parallel import (
        PipelineChannelizer,
        ShardedChannelizer,
        make_mesh,
    )
    from fdc_tpu_torch.runtime.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    def sharded(p, t, c):
        return ShardedChannelizer(p["fdc"].config, mesh=make_mesh(
            t, c, ["cuda:0"] * (t * c)))

    fold = FLAGSHIP_KERNELS + ("extract_shared_fold",)
    runs = (
        ("flagship", 4, 1, FLAGSHIP_KERNELS),
        ("flagship", 2, 2, fold),
        ("flagship", 1, 2, fold),
        ("flagship", 8, 1, FLAGSHIP_KERNELS),
        ("hunter4seg", 2, 2, DETECT_KERNELS),
        ("split4", 2, 2, DETECT_KERNELS),
        ("example", 2, 2, ("forward_fft", "extract_static",
                           "extract_shared", "candidate_packs",
                           "slot_lifecycle")),
        ("powact32", 4, 1, ("forward_fft", "powact", "extract_shared")),
        ("dama16", 2, 2, ("forward_fft", "extract_shared_fold")),
    )
    walls = {}
    for name, t, c, expect in runs:
        p = paths[name]
        if name not in walls:
            walls[name] = plain_wall(p)
        fdc = sharded(p, t, c)
        if name in ("hunter4seg", "split4"):
            assert [o for o, _ in fdc._owner_groups] == [0, 1], (
                fdc._owner_groups)
        launches, steps = pipe_run(
            f"{name}, {t}x{c} mesh", fdc,
            lambda f=fdc, x=p["x"]: [f.process(x), f.flush()], p["ref"],
            expect, walls[name], card, tag="phase 9")
        pred = sharded_prediction(name, t, c)
        assert_predicted(f"{name} {t}x{c}", launches, steps, pred)
        log(f"phase 9: {name} {t}x{c}: launches a step "
            f"{per_step(launches, steps)}, as predicted")
        hold_calls(f"{name} {t}x{c}, its second step",
                   step_calls(fdc, p["x"]), expect, summary)
    flag = paths["flagship"]
    idle_chain(flag["fdc"], card)

    # segdet's vector mode, as phase 3's spectra_check
    p = paths["segdet"]
    spectra = np.concatenate(card_spectra(p["fdc"].config, p["x"], "cuda"))
    sh = sharded(p, 2, 2)
    res, wall, launches = timed(lambda: sh.process_spectra(spectra))
    compare_events(res.events, p["ref"][0].events, "segdet process_spectra")
    assert_predicted("segdet process_spectra 2x2", launches,
                     sh._t0 // sh.config.batch_blocks,
                     {"candidate_packs": 2, "slot_lifecycle": 1})
    log(f"phase 9: segdet process_spectra, 2x2 mesh: {wall:.4f} s (host "
        f"clock); {len(res.events)} events equal to phase 3's process(); "
        f"launches {launches}, as predicted {card}")

    cfg = flag["fdc"].config
    x = flag["x"]
    bs = cfg.batch_blocks * cfg.inplen
    cuts = (bs + 555, 3 * bs + 777)  # bursts open, slots live
    with tempfile.TemporaryDirectory(prefix="fdc_phase9_") as tmp:
        tmp = Path(tmp)

        def split():
            a, b, c = flag["make"]("cuda"), sharded(flag, 2, 2), (
                flag["make"]("cuda"))
            head = a.process(x[:cuts[0]])
            save_checkpoint(a, str(tmp / "a.ckpt"))
            load_checkpoint(b, str(tmp / "a.ckpt"))
            mid = b.process(x[cuts[0]:cuts[1]])
            save_checkpoint(b, str(tmp / "b.ckpt"))
            load_checkpoint(c, str(tmp / "b.ckpt"))
            return [head, mid, c.process(x[cuts[1]:]), c.flush()]

        res, wall, launches = timed(split)
        n_ev, err = compare_runs("checkpoint split", res, flag["ref"])
        log(f"phase 9: flagship checkpoint split plain -> 2x2 sharded -> "
            f"plain: {wall:.4f} s (host clock, three channelizers built "
            f"in it); {n_ev} events equal to phase 3 (max abs err "
            f"{err:.3g}); launches {launches} {card}")

        pipe = PipelineChannelizer(cfg, devices=["cuda:0"] * 4,
                                   shard_time=2)
        assert [len(g) for g in pipe.groups] == [2, 2]
        launches, steps = pipe_run(
            "flagship, pipeline of 4 lanes, shard_time 2", pipe,
            lambda: [pipe.process(x), pipe.flush()], flag["ref"],
            FLAGSHIP_KERNELS, walls["flagship"], card, tag="phase 9")
        # a lane frames its run plus the reach-back block: F [b, N] and
        # [1, N], the measured and the burst bucket; B a lane, C once
        assert_predicted("pipeline shard_time 2", launches, steps,
                         {"forward_fft": 4, "extract_shared": 4,
                          "candidate_packs": 2, "slot_lifecycle": 1})
        log(f"phase 9: flagship pipeline shard_time 2: launches a step "
            f"{per_step(launches, steps)}, as predicted")
        restart(pipe)
        hold_calls("flagship pipeline shard_time 2, its first two batches",
                   recorded_calls(lambda: pipe.process(x[:2 * bs])),
                   FLAGSHIP_KERNELS, summary)
        multihost_run(flag, tmp, walls["flagship"], card)

        # the CLI on this card: a mesh larger than the devices
        (tmp / "cli.json").write_text(cfg.to_json())
        x[:bs].tofile(tmp / "cli.c64")
        if torch.cuda.device_count() < 2:
            t = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "fdc_tpu_torch", "run",
                 str(tmp / "cli.json"), str(tmp / "cli.c64"),
                 "--time-shards", "2"],
                cwd=Path(__file__).resolve().parent, capture_output=True,
                text=True, timeout=300)
            msg = "mesh 2x1 needs 2 devices, have 1"
            assert r.returncode != 0 and msg in r.stderr, (
                r.returncode, r.stderr[-2000:])
            log(f"phase 9: python -m fdc_tpu_torch run --time-shards 2 on "
                f"one card: exit {r.returncode}, \"{msg}\" "
                f"({time.perf_counter() - t:.1f} s)")


# -- phase 10: the FFT route, blocksizes above 16384, the utilities -----

# the paths phase 10 runs again with use_mxu_fft=False, and the kernels
# each must launch there: no A, E or F (every transform is torch.fft),
# B and C once a step on the detection paths, D once a step on powact32
FFT_ROUTE_PATHS = {
    "flagship": ("candidate_packs", "slot_lifecycle"),
    "example": ("candidate_packs", "slot_lifecycle"),
    "powact32": ("powact",),
    "hunter4seg": ("candidate_packs", "slot_lifecycle"),
    "vcm4seg": ("candidate_packs", "slot_lifecycle"),
}
PRODUCT_KERNELS = ("extract_shared", "extract_shared_fold", "extract_static",
                   "forward_fft", "forward_fft_2pass")


def two_pass_cases():
    """Kernel F's two-pass form at [512, 32768], [256, 65536] and
    [128, 131072], B blocks of seeded noise, and at [512, 32768] into rows
    1..B of an extended spectrum (row 0 must keep its value). The bound
    is the function's (the blocks read and the spectrum written once, an
    FFT's 5 N log2 N operations a block); the library call is
    ``torch.fft.fft`` + ``fftshift`` + the 1/N scale (the port's
    ``torch.fft`` route)."""
    import torch

    from fdc_tpu_torch.ops import fft

    rng = np.random.default_rng(10)

    def noise(b, n):
        return torch.from_numpy(
            (rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
             ).astype(np.complex64)).to("cuda")

    def f2_case(what, blocks, out=None):
        rows, n = blocks.shape
        return case("forward_fft_2pass",
                    lambda: fft.forward_spectrum_two_pass(blocks, out=out),
                    lambda: fft.forward_spectrum_two_pass_plain(blocks),
                    cmp_close("forward_fft_2pass", 0.0, FFT_TOL), what,
                    2 * blocks.numel() * 8, 5.0 * n * math.log2(n) * rows,
                    lambda: fft.forward_spectrum(blocks, use_mxu=False))

    out = [f2_case(f"[{b}, {n}]", noise(b, n))
           for b, n in ((512, 32768), (256, 65536), (128, 131072))]
    ext = torch.full((513, 32768), 3 + 4j, dtype=torch.complex64,
                     device="cuda")
    cs = f2_case("into spec_ext[1:] [512, 32768]", noise(512, 32768),
                 out=ext[1:])
    cmp = cs["cmp"]

    def cmp_ext(a, b):
        assert bool((ext[0] == 3 + 4j).all()), "row 0 of spec_ext written"
        return cmp(a, b)
    cs["cmp"] = cmp_ext
    return out + [cs]


@contextlib.contextmanager
def counted_steps(fdc):
    """Count the steps a path runs inside the block: the channelizer's
    ``_device_step`` calls, or the vcm detector's ``step`` calls."""
    obj, attr = ((fdc.adc, "step") if isinstance(fdc, VcmPath)
                 else (fdc, "_device_step"))
    orig, n = getattr(obj, attr), [0]

    def step(*a, **kw):
        n[0] += 1
        return orig(*a, **kw)
    setattr(obj, attr, step)
    try:
        yield n
    finally:
        delattr(obj, attr)


def product_slots(adc, on):
    """Put the vcm detector's slot extraction on the product route (``on``:
    each segment's W-point IDFT matrix, as the segments of a channelizer
    with ``use_mxu_fft`` hold it) or back on the FFT route (no matrix):
    the vcm detector's former route, timed beside its FFT route."""
    import torch

    from fdc_tpu_torch.ops.fft import _rr_idft_matrix, interleave_rows

    for sd in adc.segments:
        for w, name in sd._idft_of.items():
            mat = None
            if on:
                mat = torch.from_numpy(interleave_rows(_rr_idft_matrix(
                    w, 0, False, 1.0, pairs=True))).to(adc.device)
            sd.register_buffer(name, mat)


def step_ms(fdc, x, iters=20, busy=False):
    """Milliseconds a step by CUDA events over ``iters`` steps, the carry
    fed forward (phase 5's step time); with ``busy`` also the device busy
    milliseconds of a step with the stream held (phase 5's, the median
    of 3 ``held_time`` readings, None if none held)."""
    import statistics

    import torch

    xb = torch.from_numpy(x[:fdc.batch_samples]).to(fdc.device)
    carry = [fdc._device_init()]

    def step():
        carry[0], _ = fdc._device_step(carry[0], xb, 0)
    ms = cuda_time(step, iters)
    if not busy:
        return ms
    held = [h for h in (held_time(step, 3 * ms + 5.0) for _ in range(3))
            if h is not None]
    return ms, statistics.median(held) if held else None


def fft_route_path(name, p, card):
    """One path with use_mxu_fft=False on the card: process() + flush()
    with the launch counts zeroed just before and read just after (no A,
    E or F; B and C, or D, once a step), its events equal to phase 3's
    product-route run, two steps and two batches against the CPU plain
    path, and its step time. Returns the step milliseconds."""
    import torch

    cfg = p["fdc"].config.replace(use_mxu_fft=False)
    make = ((lambda device: VcmPath(cfg, device)) if name == "vcm4seg"
            else channelizer(cfg))
    fdc = make("cuda")
    expect = FFT_ROUTE_PATHS[name]
    with counted_steps(fdc) as steps:
        res, kinds, chans, got, tally, fins, fin = run_path(
            f"{name} use_mxu_fft=False", fdc, p["x"], expect,
            tag="phase 10")
    for k in PRODUCT_KERNELS:
        assert got[k] == 0, f"{name} FFT route launched {k}"
    for k in expect:
        assert got[k] == steps[0], (name, k, got[k], steps[0])
    others = set(KERNELS) - set(expect)
    assert not any(got[k] for k in others), (name, got)
    ref = p["ref"][0].events + p["ref"][1].events
    compare_events(res.events + fin.events, ref,
                   f"{name} FFT route against phase 3")
    compare_cpu(f"{name} use_mxu_fft=False", make, p["x"], tag="phase 10")
    ms, busy = step_ms(fdc, p["x"], busy=True)
    torch.cuda.synchronize()
    log(f"phase 10: {name} use_mxu_fft=False: {steps[0]} steps, "
        f"{', '.join(f'{k} {got[k]}' for k in expect)} (one a step), no A, "
        f"E or F; {len(ref)} events equal to phase 3's product route; "
        f"step B={cfg.batch_blocks} {ms:.4f} ms "
        f"({fdc.batch_samples / ms / 1e3:.1f} MS/s), device busy "
        f"{fmt_ms(busy)} with the stream held {card}")
    return fdc, ms


def large_n_phase(paths, card, summary, launches):
    """Phase 10: kernel F's two-pass form against its plain version (and
    timed beside it, its bound, the library call and by graph replay);
    the flagship at blocksize 32768, B = 512, through process() + flush()
    on the card (two-pass F, A, B, C) and against the CPU plain path; the
    flagship, the example, powact32, hunter4seg and vcm4seg with
    use_mxu_fft=False; the vcm detector's step with its slots on the
    product route (its former one) and the FFT route, in turns;
    ``utils.profiling`` on the flagship beside its step time; and
    ``utils.resample`` on the card against the CPU."""
    two_pass_kernel(summary["forward_fft_2pass"], card)
    flagship_32768(launches, card)
    fft_route_phase(paths, card)
    utilities_phase(paths, card)


def two_pass_kernel(ent, card):
    """Phase 10's kernel cases (:func:`two_pass_cases`), summed into the
    kernel summary's entry ``ent``."""
    import torch

    for cs in two_pass_cases():
        got = cs["kern"]()
        torch.cuda.synchronize()
        err = cs["cmp"](got, cs["plain"]())
        t_bytes = cs["bytes"] / PEAK_BYTES * 1e3
        t_ops = cs["flops"] / PEAK_FP32 * 1e3
        bound = max(t_bytes, t_ops)
        k_ms, p_ms = cuda_time(cs["kern"], 20), cuda_time(cs["plain"], 3)
        l_ms = cuda_time(cs["library"], 20)
        ent["max_abs_err"] = max(ent["max_abs_err"], err)
        ent["ms"] += k_ms
        ent["plain_ms"] += p_ms
        ent["library_ms"] += l_ms
        ent["bound_ms"] += bound
        if bound > ent["bound_max"]:
            ent["bound_max"] = bound
            ent["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"phase 10: forward_fft_2pass {cs['shape']}: matches plain, max "
            f"abs err {err:.3g}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"library {l_ms:.4f} ms; device (graph): kernel "
            f"{fmt_ms(graph_time(cs['kern']))}, library "
            f"{fmt_ms(graph_time(cs['library']))}; bound {bound:.5f} ms "
            f"({cs['bytes'] / 1e6:.1f} MB, {cs['flops'] / 1e9:.3f} GFLOP; "
            f"the two passes move {2 * cs['bytes'] / 1e6:.1f} MB, "
            f"{2 * t_bytes:.5f} ms) {card}")


def flagship_32768(launches, card, batch_blocks=512):
    """The flagship at blocksize 32768: kernel F's two-pass form on the
    path, its launches added to the kernel summary's."""
    import torch

    from fdc_tpu_torch.flagship import _flagship

    cfg = _flagship(blocksize=32768, batch_blocks=batch_blocks)
    make = channelizer(cfg)
    fdc = make("cuda")
    x = scripted_capture(cfg, 2 * fdc.batch_samples + 7 * cfg.inplen + 1234)
    with counted_steps(fdc) as steps:
        res, kinds, chans, got, tally, fins, fin = run_path(
            "flagship blocksize=32768", fdc, x,
            ("forward_fft_2pass", "extract_shared", "candidate_packs",
             "slot_lifecycle"), tag="phase 10")
    assert got["forward_fft"] == 0 and got["forward_fft_2pass"] == steps[0]
    launches["forward_fft_2pass"] += got["forward_fft_2pass"]
    assert kinds.get("PowActChan", 0) >= 1 and kinds.get("DETECTED", 0) >= 1
    compare_cpu("flagship blocksize=32768", make, x, tag="phase 10")
    chan, amp, snr = tone_check(res, fdc, TONE_BIN)
    assert abs(amp - 1.0) < 0.05 and snr > 25.0, (amp, snr)
    ms = step_ms(fdc, x, 10)
    log(f"phase 10: flagship blocksize=32768: {steps[0]} steps, F2 once a "
        f"step; tone in channel {chan}: amp {amp:.4f}, SNR {snr:.1f} dB; "
        f"step B={batch_blocks} {ms:.4f} ms "
        f"({fdc.batch_samples / ms / 1e3:.1f} MS/s) {card}")
    del fdc, res, fin
    torch.cuda.empty_cache()


def fft_route_phase(paths, card):
    """The FFT route (use_mxu_fft=False) on five paths, then vcm4seg's
    step with its slots on either route."""
    routes = {name: fft_route_path(name, paths[name], card)
              for name in FFT_ROUTE_PATHS}

    # vcm4seg's slots: the product route (before) and the FFT route
    # (after), in turns on one detector
    vcm, x = routes["vcm4seg"][0], paths["vcm4seg"]["x"]
    times = {"product": [], "fft": []}
    for route in ("product", "fft", "fft", "product"):
        product_slots(vcm.adc, route == "product")
        times[route].append(step_ms(vcm, x, busy=True))
    product_slots(vcm.adc, False)

    def fmt(route):
        return " / ".join(f"{ms:.4f} ms (busy {fmt_ms(b)})"
                          for ms, b in times[route])
    log(f"phase 10: vcm4seg step B={vcm.config.batch_blocks} by CUDA events "
        f"(device busy with the stream held), slots on the product route "
        f"{fmt('product')}, on the FFT route {fmt('fft')} (product, FFT, "
        f"FFT, product) {card}")


def utilities_phase(paths, card):
    """``utils.profiling`` on the flagship beside its step time, and
    ``utils.resample`` on the card against the CPU."""
    import torch

    from fdc_tpu_torch.utils.profiling import (
        measure_samples_per_sec,
        time_scanned_stats,
    )
    from fdc_tpu_torch.utils.resample import rational_resample

    flag = paths["flagship"]
    ms = step_ms(flag["fdc"], flag["x"])
    xb = torch.from_numpy(flag["x"][:flag["fdc"].batch_samples]).to("cuda")
    bb = flag["fdc"].config.batch_blocks
    st = time_scanned_stats(
        lambda c, xin, t: flag["fdc"]._device_step(c, xin, t * bb),
        flag["fdc"]._device_init(), xb, k=8, repeats=5)
    rate = measure_samples_per_sec(flag["fdc"])
    assert np.isfinite(rate) and rate > 0 and st["median"] > 0
    log(f"phase 10: utils.profiling on the flagship: time_scanned_stats "
        f"(K = 8 against 2K, timer: {st['timer']}) median "
        f"{st['median'] * 1e3:.4f} ms/step (q25 {st['q25'] * 1e3:.4f}, q75 "
        f"{st['q75'] * 1e3:.4f}); measure_samples_per_sec "
        f"{rate / 1e6:.1f} MS/s; the step by CUDA events {ms:.4f} ms "
        f"({flag['fdc'].batch_samples / ms / 1e3:.1f} MS/s) {card}")

    # utils.resample on the card against the CPU
    rng = np.random.default_rng(11)
    t = np.arange(1 << 16)
    xs = (np.exp(2j * np.pi * 0.05 * t)[None]
          + 0.1 * (rng.standard_normal((8, t.size))
                   + 1j * rng.standard_normal((8, t.size)))
          ).astype(np.complex64)
    for up, down in ((3, 2), (1, 4)):
        got = rational_resample(torch.from_numpy(xs).to("cuda"), up, down)
        ref = rational_resample(torch.from_numpy(xs), up, down)
        ok, err = close(got.cpu(), ref, RTOL, ATOL)
        assert ok and got.shape == ref.shape, (up, down, err)
        r_ms = cuda_time(lambda: rational_resample(
            torch.from_numpy(xs).to("cuda"), up, down), 5)
        log(f"phase 10: rational_resample {up}/{down} [8, {t.size}] on the "
            f"card == CPU (max abs err {err:.3g}); {r_ms:.4f} ms a call, "
            f"host-to-card copy included {card}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (this check runs only on the "
              "card)", file=sys.stderr)
        return 1
    from fdc_tpu_torch import kernels

    # -- phase 1: the card and the build ----------------------------------
    t_run = t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    log(smi)
    log(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    t = time.perf_counter()
    info = kernels.build_info()
    log(f"phase 1: kernels built in {time.perf_counter() - t:.1f} s "
        f"(nvcc {info['seconds']:.1f} s) -> {info['path']}")
    for line in info.get("ptxas", "").splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            log("  ptxas:", line.strip())

    def phase_done(n):
        nonlocal t_phase
        now = time.perf_counter()
        log(f"phase {n}: {now - t_phase:.1f} s wall")
        t_phase = now

    paths = {}
    for name, make, capture, expect in path_table():
        fdc = make("cuda")
        cfg = fdc.config
        n_samples = N_BATCHES * fdc.batch_samples + 7 * cfg.inplen + 1234
        x, carriers = capture(fdc, n_samples)
        paths[name] = dict(fdc=fdc, x=x, carriers=carriers, make=make,
                           expect=expect)
    phase_done(1)

    # -- phase 2: kernels against their plain versions --------------------
    # every kernel call of each path's step, replayed on the same inputs,
    # and kernel D on the init / floor edges
    cases = []
    for name, p in paths.items():
        for call in step_calls(p["fdc"], p["x"]):
            cases.append(call_case(name, *call))
            if call[0] == "candidate_packs":  # the acceptance chain alone
                powers, specs = call[3]
                cases.append(greedy_case(name, powers[0], specs[0]))
    cases.append(powact_edge_case(paths["powact32"]["fdc"]))
    cases += powact_scan_cases() + pack_edge_cases()
    cases.append(extract_proto_case(paths["flagship"]["fdc"],
                                    paths["flagship"]["x"]))
    cases += fft_cases() + probe_cases() + extract_edge_cases()
    summary = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "bound_by": "bytes", "bound_max": 0.0,
                   "library_ms": 0.0, "has_library": True}
               for k in KERNELS}
    for cs in cases:
        got = cs["kern"]()
        torch.cuda.synchronize()
        ref = cs["plain"]()
        err = cs["cmp"](got, ref)
        ent = summary[cs["name"]]
        ent["max_abs_err"] = max(ent["max_abs_err"], err)
        t_bytes = cs["bytes"] / PEAK_BYTES * 1e3
        t_ops = cs["flops"] / PEAK_FP32 * 1e3
        cs["bound_ms"] = max(t_bytes, t_ops)
        ent["bound_ms"] += cs["bound_ms"]
        if cs["bound_ms"] > ent["bound_max"]:
            ent["bound_max"] = cs["bound_ms"]
            ent["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        rel = ""
        if cs["name"].startswith("extract"):
            # the extraction's error relative to its output's max
            g0, r0 = ((got[0], ref[0]) if isinstance(ref, tuple)
                      else (got, ref))
            rel = (f" (extraction {float((g0 - r0).abs().max()):.3g}, "
                   f"{float((g0 - r0).abs().max() / r0.abs().max()):.3g} "
                   f"of its max)")
        log(f"phase 2: {cs['name']} {cs['shape']}: matches plain, max abs "
            f"err {err:.3g}{rel}; bound {cs['bound_ms'] * 1e3:.2f} us "
            f"({cs['bytes'] / 1e6:.3f} MB, {cs['flops'] / 1e9:.4f} GFLOP)")
    phase_done(2)

    # -- phase 3: each path on the card -----------------------------------
    launches = {k: 0 for k in KERNELS}
    for name, p in paths.items():
        res, kinds, chans, got, tally, fins, fin = run_path(
            name, p["fdc"], p["x"], p["expect"])
        p["ref"] = [res, fin]
        for k, n in got.items():
            launches[k] += n
        check_path(name, p, res, kinds, chans, tally, fins)
        if name in ("segdet", "hunter512"):
            spectra_check(name, p["fdc"], p["x"], res)
    phase_done(3)

    # -- phase 4: plain versions on the CPU, same captures -----------------
    for name, p in paths.items():
        compare_cpu(name, p["make"], p["x"])
    phase_done(4)

    # -- phase 5: timing ---------------------------------------------------
    for name, p in paths.items():
        time_step(name, p["fdc"], p["x"], card)
    for cs in cases:
        slow = cs["name"] in ("slot_lifecycle", "powact", "candidate_packs",
                              "greedy_accept")
        k_ms = cuda_time(cs["kern"], 50)
        p_ms = cuda_time(cs["plain"], 3 if slow else 50)
        ent = summary[cs["name"]]
        ent["ms"] += k_ms
        ent["plain_ms"] += p_ms
        lib = ""
        if cs["library"] is None:
            ent["has_library"] = False
        else:
            l_ms = cuda_time(cs["library"], 50)
            ent["library_ms"] += l_ms
            lib = f", library {l_ms:.4f} ms"
        if "unfolded" in cs:
            lib += (f", unfolded A + apply_phase_pairs "
                    f"{cuda_time(cs['unfolded'], 50):.4f} ms")
        if cs["name"] in GRAPHED:
            lib += (f"; device (graph): kernel "
                    f"{fmt_ms(graph_time(cs['kern']))}")
            if cs["library"] is not None:
                lib += f", library {fmt_ms(graph_time(cs['library']))}"
        log(f"phase 5: {cs['name']} {cs['shape']}: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms{lib}, bound {cs['bound_ms']:.5f} ms "
            f"{card}")
    phase_done(5)

    # -- phase 6: kernel A's tile and split rule against the others --------
    plan_sweep(card)
    phase_done(6)

    # -- phase 7: the host runtime: CLI, checkpoint, StreamDriver ----------
    runtime_phase(paths, card)
    phase_done(7)

    # -- phase 8: the MPMD batch pipeline and the hostpipe -----------------
    pipeline_phase(paths, card)
    phase_done(8)

    # -- phase 9: the sharded step over meshes of ranks ---------------------
    sharded_phase(paths, card, summary)
    phase_done(9)

    # -- phase 10: the FFT route, blocksizes above 16384, the utilities ----
    large_n_phase(paths, card, summary, launches)
    phase_done(10)
    log(f"total: {time.perf_counter() - t_run:.1f} s wall")

    rows = []
    for name, (src, replaces) in KERNELS.items():
        ent = summary[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": ent["max_abs_err"], "ms": ent["ms"],
            "plain_ms": ent["plain_ms"], "bound_ms": ent["bound_ms"],
            "bound_by": ent["bound_by"],
            "library_ms": ent["library_ms"] if ent["has_library"] else None,
        })
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
