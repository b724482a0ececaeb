#!/usr/bin/env python3
"""Smoke test of fdc_tpu_torch on one CUDA card (an H100).

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc`` (the kernels are built from ``fdc_tpu_torch/csrc``
on first use), imports neither JAX nor fdc_tpu, and exits non-zero on
any failure. It drives three paths at full width, B=512: the flagship
(``_flagship``), the upstream example (``reference_example``: fused
throughput + burst buckets, one detection segment) and BASELINE config 3
(``powact32``: 32 burst channels, the standalone burst chain). Phases,
one or more lines each:

1. the card (nvidia-smi name and power limit), torch / CUDA versions, and
   the kernel build;
2. each hand-written kernel against its plain PyTorch version on the card,
   on the inputs of every call it gets in each path's second step (the
   first leaves the slot tables and burst states busy), and kernel D on
   the init / floor edges;
3. each path: ``FrequencyDomainChannelizer(cfg, device="cuda")`` over a
   scripted capture, process + flush, with the kernels' launch counts
   zeroed just before and read just after that run;
4. each path through ``device="cpu"`` (the plain versions) for two
   batches, compared with the card's step outputs and events;
5. timing with CUDA events: each path's step on the kernel path (with
   its host enqueue time and a torch.profiler breakdown: device launches,
   busy time, idle share, the heaviest kernels) and on the plain path,
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


def wrappers():
    """(kernel name, module, attribute) of every kernel wrapper. Callers
    reach each wrapper through its module, each carries ``.launches`` and
    has a plain twin ``<attribute>_plain`` in the same module."""
    from fdc_tpu_torch.ops import detect, extract_fused, lifecycle, powact

    return (("extract_shared", extract_fused, "extract_shared"),
            ("greedy_accept", detect, "greedy_accept_batch"),
            ("slot_lifecycle", lifecycle, "slot_lifecycle_multi"),
            ("powact", powact, "powact_flags"),
            ("extract_static", extract_fused, "extract_static"))


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


def call_case(path, name, fn, plain, a, kw):
    """A kernel case from one recorded call of a path's step."""
    if name in ("extract_shared", "extract_static"):
        what, bytes_, flops, library, cmp = extract_work(*a, **kw)
        return case(name, lambda: fn(*a, **kw), lambda: plain(*a, **kw),
                    cmp, f"{path} {what}", bytes_, flops, library)
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


def run_path(name, fdc, x, expect):
    """Phase 3 for one path: process + flush with the launch counts
    zeroed just before and read just after; checks that every kernel of
    the path ran, blocks, finite events and the path's scripted events."""
    import torch

    cfg = fdc.config
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    t = time.perf_counter()
    res = fdc.process(x)
    fin = fdc.flush()
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
        f"events {kinds}, {fins} finalized; launches {launches}")
    return res, kinds, chans, launches


def compare_cpu(name, fdc, x):
    """Phase 4 for one path: two steps and two batches' events, card
    against the CPU plain path."""
    import torch

    cfg = fdc.config
    dev = fdc.device
    cpu = type(fdc)(cfg, device="cpu")
    gpu = type(fdc)(cfg, device=dev)
    cc, gc = cpu._device_init(), gpu._device_init()
    bs = fdc.batch_samples
    worst = 0.0
    for step in range(2):
        chunk = torch.from_numpy(x[step * bs:(step + 1) * bs])
        cc, co = cpu._device_step(cc, chunk, step * cfg.batch_blocks)
        gc, go = gpu._device_step(gc, chunk.to(dev), step * cfg.batch_blocks)
        worst = max(worst, compare_outputs(go, co, f"{name} step {step}"))
        compare_outputs(gc, cc, f"{name} carry after step {step}")
    ev_c = cpu.process(x[:2 * bs]).events + cpu.flush().events
    ev_g = gpu.process(x[:2 * bs]).events + gpu.flush().events
    compare_events(ev_g, ev_c, f"{name} events")
    log(f"phase 4: {name}: 2 steps card == cpu plain (max abs err "
        f"{worst:.3g}), {len(ev_g)} events identical")


def time_step(name, fdc, x, card, top=8):
    """Phase 5 for one path: the step time by CUDA events (carry fed
    forward), the host time to enqueue one step, a torch.profiler
    breakdown of 3 of the same steps (device launches, busy time, idle
    share of the step time, the heaviest kernels) and the plain path's
    step time."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    xb = torch.from_numpy(x[:fdc.batch_samples]).to(fdc.device)
    carry = [fdc._device_init()]

    def step():
        carry[0], _ = fdc._device_step(carry[0], xb, 0)

    ms = cuda_time(step, 20)
    enqueue = []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        enqueue.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    n_steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert dev, "torch.profiler recorded no device time on this card"
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e3 / n_steps
    with plain_path():
        ms_plain = cuda_time(step, 3)
    bs = fdc.batch_samples
    log(f"phase 5: {name} step B={fdc.config.batch_blocks}: kernel path "
        f"{ms:.4f} ms ({bs / ms / 1e3:.1f} MS/s), plain path "
        f"{ms_plain:.4f} ms ({bs / ms_plain / 1e3:.1f} MS/s); host enqueue "
        f"median {statistics.median(enqueue):.4f} ms; profiler: "
        f"{len(dev) / n_steps:.0f} device launches/step, device busy "
        f"{busy:.4f} ms/step, idle share {1 - busy / ms:.3f} {card}")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {us / 1e3 / n_steps:.4f} ms/step  {kname[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (this check runs only on the "
              "card)", file=sys.stderr)
        return 1
    from fdc_tpu_torch import FrequencyDomainChannelizer, kernels
    from fdc_tpu_torch.flagship import _flagship, powact32, reference_example

    # -- phase 1: the card and the build ----------------------------------
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

    dev = torch.device("cuda")
    paths = {}  # name: (fdc, capture, kernels the path must launch)
    for name, cfg, capture, expect in (
        ("flagship", _flagship(batch_blocks=512), scripted_capture,
         ("extract_shared", "greedy_accept", "slot_lifecycle")),
        ("example", reference_example(), burst_capture,
         ("extract_static", "extract_shared", "greedy_accept",
          "slot_lifecycle")),
        ("powact32", powact32(), burst_capture,
         ("powact", "extract_shared")),
    ):
        fdc = FrequencyDomainChannelizer(cfg, device=dev)
        n_samples = N_BATCHES * fdc.batch_samples + 7 * cfg.inplen + 1234
        paths[name] = (fdc, capture(cfg, n_samples), expect)

    # -- phase 2: kernels against their plain versions --------------------
    # every kernel call of each path's step, replayed on the same inputs,
    # and kernel D on the init / floor edges
    cases = [call_case(name, *call)
             for name, (fdc, x, _) in paths.items()
             for call in step_calls(fdc, x)]
    cases.append(powact_edge_case(paths["powact32"][0]))
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

    # -- phase 3: each path on the card -----------------------------------
    launches = {k: 0 for k in KERNELS}
    for name, (fdc, x, expect) in paths.items():
        res, kinds, chans, got = run_path(name, fdc, x, expect)
        for k, n in got.items():
            launches[k] += n
        if name == "flagship":
            chan, amp, snr = tone_check(res, fdc, TONE_BIN)
            assert abs(amp - 1.0) < 0.05 and snr > 25.0, (amp, snr)
            assert kinds.get("PowActChan", 0) >= 1
            assert kinds.get("DETECTED", 0) >= 3
            log(f"phase 3: flagship tone in channel {chan}: amp {amp:.4f}, "
                f"SNR {snr:.1f} dB")
            continue
        cfg = fdc.config
        n_pa = len(cfg.activity_controlled_channels)
        # each burst channel's one scripted carrier, and nothing else
        assert chans == {c: 1 for c in range(n_pa)}, (name, chans)
        if cfg.activity_detection_segments:
            assert kinds.get("DETECTED", 0) >= 3, (name, kinds)
        for f, _ in cfg.throughput_channels:
            chan, amp, snr = tone_check(
                res, fdc, round(f * cfg.blocksize),
                from_block=int((GATES_END + 0.2) * cfg.batch_blocks))
            assert abs(amp - BURST_TONE) < 0.05 * BURST_TONE and snr > 25.0, (
                name, chan, amp, snr)
            log(f"phase 3: {name} tone in channel {chan}: amp {amp:.4f}, "
                f"SNR {snr:.1f} dB")

    # -- phase 4: plain versions on the CPU, same captures -----------------
    for name, (fdc, x, _) in paths.items():
        compare_cpu(name, fdc, x)

    # -- phase 5: timing ---------------------------------------------------
    for name, (fdc, x, _) in paths.items():
        time_step(name, fdc, x, card)
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
        log(f"phase 5: {cs['name']} {cs['shape']}: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms{lib}, bound {cs['bound_ms']:.5f} ms "
            f"{card}")

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
