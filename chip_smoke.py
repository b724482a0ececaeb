#!/usr/bin/env python3
"""Smoke test of fdc_tpu_torch on one CUDA card (an H100).

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc`` (the kernels are built from ``fdc_tpu_torch/csrc``
on first use), imports neither JAX nor fdc_tpu, and exits non-zero on
any failure. It drives nine paths at full width, B=512: the flagship
(``_flagship``), the upstream example (``reference_example``: fused
throughput + burst buckets, one detection segment), BASELINE config 3
(``powact32``: 32 burst channels, the standalone burst chain), config 2
(``cfg2_dama16``: 16 throughput channels, kernel A's quarter-turn phase
fold), configs 4, 5 and 5b (two-tier slot extraction, 32, 512 and 4 x
128 slots), config 5 split into 4 parts (``cfg5s_burst_hunter_split4``:
the cut reconciliation), and the multi-segment vcm detector built from
config 5b as ``python -m fdc_tpu vcm`` maps a configuration, fed spectra
that the port's own front end makes on the card. Every path's front end
is kernel F, the four-step forward FFT. Phases, one or more lines each,
each ending with its wall seconds:

1. the card (nvidia-smi name and power limit), torch / CUDA versions, and
   the kernel build;
2. each hand-written kernel against its plain PyTorch version on the card,
   on the inputs of every call it gets in each path's second step (the
   first leaves the slot tables and burst states busy), kernel D on the
   init / floor edges, kernel F at every N from 256 to 16384, kernel P on
   every FFT probe's inputs, and kernel E on the function of
   ``tools/pallas_extract_proto.py`` (the flagship's throughput bucket 0
   with a matrix per channel);
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
   the idle share that leaves, and a torch.profiler breakdown where the
   profiler sees the card: device launches, kernel time, the heaviest
   kernels; a profiler that records no device time is reported, not a
   failure), with the ``torch.fft``
   front end in place of kernel F (between two kernel-path timings), and
   on the plain path,
   and each phase-2 case's kernel against its plain version and, where
   one PyTorch call computes the same function, that call.

In the kernel summary JSON, ``ms``, ``plain_ms``, ``bound_ms`` and
``library_ms`` are sums over the kernel's phase-2 cases.

The line before the last is the kernel summary JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

# extraction / stream tolerance (relative to each tensor's max magnitude)
# and the power tolerance: rtol elementwise on a common spectrum (the
# accumulation order differs), of the tensor's max end to end (cuFFT and
# the CPU FFT also round differently, at ~1e-7 of the spectrum's scale)
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
# kernel F's tolerance: of the spectrum's max (the summation order of
# its products differs from the plain version's matmuls)
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
    worst = 0.0
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
    return worst


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
            ("greedy_accept", detect, "greedy_accept_batch"),
            ("slot_lifecycle", lifecycle, "slot_lifecycle_multi"),
            ("powact", powact, "powact_flags"),
            ("extract_static", extract_fused, "extract_static"),
            ("extract_shared_fold", extract_fused, "extract_shared_fold"),
            ("forward_fft", fft, "forward_spectrum_four_step"),
            ("tile_probe", probes, "tile_probe"))


def counters():
    """Every kernel wrapper, by kernel name."""
    return {k: getattr(m, a) for k, m, a in wrappers()}


# name: (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "extract_shared": ("fdc_tpu_torch/csrc/extract_shared.cu",
                       "fdc_tpu/ops/extract_pallas.py:96"),
    "greedy_accept": ("fdc_tpu_torch/csrc/greedy_accept.cu",
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
        return lambda blocks: fft.forward_spectrum(blocks, use_mxu=False)
    return swapped(make)


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone(v) for v in tree)
    return tree.clone() if hasattr(tree, "clone") else tree


def step_calls(fdc, x):
    """Every kernel call of the path's second step on the card, the first
    having left its carry (slot tables, burst states) busy: [(name,
    wrapper, plain, args, kwargs)], the arguments cloned."""
    import torch

    calls = []

    def record(k, fn, plain):
        def rec(*a, **kw):
            calls.append((k, fn, plain, clone(a), clone(kw)))
            return fn(*a, **kw)
        rec.launches = 0  # fn counts through its module's name, i.e. rec
        return rec

    cfg, dev, bs = fdc.config, fdc.device, fdc.batch_samples
    carry, _ = fdc._device_step(fdc._device_init(),
                                torch.from_numpy(x[:bs]).to(dev), 0)
    with swapped(record):
        fdc._device_step(carry, torch.from_numpy(x[bs:2 * bs]).to(dev),
                         cfg.batch_blocks)
    torch.cuda.synchronize()
    return calls


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


def extract_work(spec, starts, mats, masks=None):
    """(description, bytes, fp32 operations, library call, comparator) of
    kernel A (``mats`` [2l, 2k]) or E ([C, 2l, 2k]) on these inputs. The
    measures count only the mask columns in use (the rest is zero
    padding to 128) and the bins they cover."""
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
    bins |= set(torch.nonzero((masks[:, used] != 0).any(1))
                .flatten().tolist())
    sf = torch.view_as_real(spec)
    sq = sf[..., 0] ** 2 + sf[..., 1] ** 2
    return (f"{what} + powers [{rows}, {cm} of {masks.shape[1]}]",
            len(bins) * rows * 8 + nbytes((starts, mats)) + n * cm * 4
            + out_bytes + rows * cm * 4,
            flops + 2.0 * rows * n * cm,
            lambda: (torch.matmul(z, mats), torch.matmul(sq, masks)),
            cmp_measured)


def fft_case(what, blocks, kern, plain):
    """Kernel F on [B, N] blocks. The bound is the function's, a shifted
    and scaled DFT: the blocks read and the spectrum written once, and an
    FFT's 5 N log2 N fp32 operations a block (not the 8 N (m1 + m2) of
    the DFT-as-product form F computes it by); the library call is
    ``torch.fft.fft`` on the same blocks (no shift, no scale)."""
    import torch

    rows, n = blocks.shape
    return case("forward_fft", lambda: kern(blocks), lambda: plain(blocks),
                cmp_close("forward_fft", 0.0, FFT_TOL), what,
                2 * blocks.numel() * 8,
                5.0 * n * math.log2(n) * rows,
                lambda: torch.fft.fft(blocks))


def fft_cases():
    """Kernel F at every N it covers, B = 64 blocks of seeded noise."""
    import torch

    from fdc_tpu_torch.ops import fft

    rng = np.random.default_rng(4)
    out = []
    for log2n in range(8, 15):
        n = 1 << log2n
        x = (rng.standard_normal((64, n))
             + 1j * rng.standard_normal((64, n))).astype(np.complex64)
        out.append(fft_case(f"N={n} [64, {n}]",
                            torch.from_numpy(x).to("cuda"),
                            fft.forward_spectrum_four_step,
                            fft.forward_spectrum_four_step_plain))
    return out


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
    out = plain(*a, **kw)
    if name == "greedy_accept":
        what = f"candidate rows {list(a[0].shape)}"
    elif name == "slot_lifecycle":
        pa = kw.get("powact")
        what = (f"packs {[list(p.shape) for p in a[0]]}, S="
                f"{[int(st['active'].numel()) for st in a[1]]}, burst C="
                f"{pa['powers'].shape[1] if pa else 0}")
    else:
        what = f"powers {list(a[0].shape)}"
    flops = 2.0 * a[0].numel() if name == "powact" else 0.0  # two divisions
    return case(name, lambda: fn(*a, **kw), lambda: plain(*a, **kw),
                cmp_exact, f"{path} {what}", nbytes((a, kw)) + nbytes(out),
                flops)


def powact_edge_case(fdc_pa):
    """Kernel D at config 3's shapes on powers straddling the threshold,
    with the init (lastpower = FLT_MAX) and floor (FLT_MIN) edges."""
    import torch

    from fdc_tpu_torch.ops import powact

    dev = fdc_pa.device
    pa = fdc_pa.power_bank
    rng = np.random.default_rng(3)
    nb, c = fdc_pa.config.batch_blocks, pa.num_channels
    pw = np.exp(rng.normal(0.0, 2.0, (nb, c))).astype(np.float32)
    pw[rng.random((nb, c)) < 0.02] = FLT_MIN  # floored silence
    lp = np.exp(rng.normal(0.0, 2.0, c)).astype(np.float32)
    lp[::3] = FLT_MAX  # freshly initialised channels
    state = {
        "active": torch.from_numpy(rng.random(c) < 0.5).to(dev),
        "lastpower": torch.from_numpy(lp).to(dev),
        "phase": torch.from_numpy(rng.integers(0, 4, c).astype(np.int32)
                                  ).to(dev),
    }
    a = (torch.from_numpy(pw).to(dev), state, pa.delta)
    kw = dict(r=pa.relinvovl, thresh=pa.thresh)
    rise, fall = powact.powact_flags_plain(*a, **kw)[1][:2]
    assert bool(rise.any()) and bool(fall.any()), "powact case has no edges"
    cs = call_case("powact32 edges", "powact", powact.powact_flags,
                   powact.powact_flags_plain, a, kw)
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
    y = res.throughput[chan][max(2000, from_block * bucket.out_len):]
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


def run_path(name, fdc, x, expect):
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
    log(f"phase 3: {name}: {blocks} blocks in {wall:.2f} s (host clock); "
        f"events {kinds}, {fins} finalized; launches {launches}"
        + (f"; plans {tally}" if fdc.segments else ""))
    return res, kinds, chans, launches, tally, fins


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


def compare_cpu(name, make, x):
    """Phase 4 for one path: two steps and two batches' events, card
    against the CPU plain path."""
    import torch

    cpu, gpu = make("cpu"), make("cuda")
    cfg, dev = gpu.config, gpu.device
    cc, gc = cpu._device_init(), gpu._device_init()
    bs = gpu.batch_samples
    worst = 0.0
    for step in range(2):
        chunk = torch.from_numpy(x[step * bs:(step + 1) * bs])
        cc, co = cpu._device_step(cc, chunk, step * cfg.batch_blocks)
        gc, go = gpu._device_step(gc, chunk.to(dev), step * cfg.batch_blocks)
        worst = max(worst, compare_outputs(go, co, f"{name} step {step}"))
        compare_outputs(gc, cc, f"{name} carry after step {step}")
    ev_c, ev_g = ([e for r in drive(f, x[:2 * bs]) for e in r.events]
                  for f in (cpu, gpu))
    compare_events(ev_g, ev_c, f"{name} events")
    log(f"phase 4: {name}: 2 steps card == cpu plain (max abs err "
        f"{worst:.3g}), {len(ev_g)} events identical")


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
    with plain_path():
        ms_plain = cuda_time(step, 3)
    bs = fdc.batch_samples
    log(f"phase 5: {name} step B={fdc.config.batch_blocks}: kernel path "
        f"{ms:.4f} ms ({bs / ms / 1e3:.1f} MS/s), plain path "
        f"{ms_plain:.4f} ms ({bs / ms_plain / 1e3:.1f} MS/s); cuFFT front "
        f"end {ms_cufft:.4f} ms between kernel F's {ms:.4f} and "
        f"{ms_again:.4f} ms; host enqueue "
        f"median {statistics.median(enqueue):.4f} ms; {held_txt}; "
        f"{prof_txt} {card}")
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
    detection = ("forward_fft", "greedy_accept", "slot_lifecycle")
    return (
        ("flagship", channelizer(_flagship(batch_blocks=512)),
         on_config(scripted_capture),
         ("forward_fft", "extract_shared", "greedy_accept",
          "slot_lifecycle")),
        ("example", channelizer(reference_example()),
         on_config(burst_capture),
         ("forward_fft", "extract_static", "extract_shared",
          "greedy_accept", "slot_lifecycle")),
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
        if "registers" in line or "Compiling entry" in line:
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
    cases = [call_case(name, *call)
             for name, p in paths.items()
             for call in step_calls(p["fdc"], p["x"])]
    cases.append(powact_edge_case(paths["powact32"]["fdc"]))
    cases.append(extract_proto_case(paths["flagship"]["fdc"],
                                    paths["flagship"]["x"]))
    cases += fft_cases() + probe_cases()
    summary = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "bound_by": "bytes", "bound_max": 0.0,
                   "library_ms": 0.0, "has_library": True}
               for k in KERNELS}
    for cs in cases:
        got = cs["kern"]()
        torch.cuda.synchronize()
        err = cs["cmp"](got, cs["plain"]())
        ent = summary[cs["name"]]
        ent["max_abs_err"] = max(ent["max_abs_err"], err)
        t_bytes = cs["bytes"] / PEAK_BYTES * 1e3
        t_ops = cs["flops"] / PEAK_FP32 * 1e3
        cs["bound_ms"] = max(t_bytes, t_ops)
        ent["bound_ms"] += cs["bound_ms"]
        if cs["bound_ms"] > ent["bound_max"]:
            ent["bound_max"] = cs["bound_ms"]
            ent["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"phase 2: {cs['name']} {cs['shape']}: matches plain, max abs "
            f"err {err:.3g}; bound {cs['bound_ms'] * 1e3:.2f} us "
            f"({cs['bytes'] / 1e6:.3f} MB, {cs['flops'] / 1e9:.4f} GFLOP)")
    phase_done(2)

    # -- phase 3: each path on the card -----------------------------------
    launches = {k: 0 for k in KERNELS}
    for name, p in paths.items():
        res, kinds, chans, got, tally, fins = run_path(
            name, p["fdc"], p["x"], p["expect"])
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
        slow = cs["name"] in ("slot_lifecycle", "powact")
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
        log(f"phase 5: {cs['name']} {cs['shape']}: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms{lib}, bound {cs['bound_ms']:.5f} ms "
            f"{card}")
    phase_done(5)
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
