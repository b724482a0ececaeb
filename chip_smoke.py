#!/usr/bin/env python3
"""Smoke test of fdc_tpu_torch on one CUDA card (an H100).

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc`` (the kernels are built from ``fdc_tpu_torch/csrc``
on first use), imports neither JAX nor fdc_tpu, and exits non-zero on
any failure. Phases, one or more lines each:

1. the card (nvidia-smi name and power limit), torch / CUDA versions, and
   the kernel build;
2. each hand-written kernel against its plain PyTorch version on the card,
   at the flagship step's shapes;
3. the main path: ``FrequencyDomainChannelizer(_flagship(batch_blocks=512),
   device="cuda")`` over a scripted capture, process + flush, with the
   kernels' launch counts read over exactly that run;
4. the same capture through ``device="cpu"`` (the plain versions) for two
   batches, compared with the card's step outputs and events;
5. timing with CUDA events: the flagship step on the kernel path and on
   the plain path, and each kernel against its plain version.

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
    else:
        out[pre] = tree.detach().cpu().numpy()
    return out


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


def scripted_capture(cfg, n_samples, seed=0):
    """Noise, two exact-bin tones in throughput channels, an on/off
    carrier in the burst band, and band-limited carriers that appear and
    vanish in the detection segment — every power ratio the detectors
    see is far from their thresholds except at the carrier edges."""
    rng = np.random.default_rng(seed)
    n = cfg.blocksize
    blk = cfg.batch_blocks * cfg.inplen

    def periodic(bins, amps):
        # exact-bin tones repeat every n samples: synthesize one period
        spec = np.zeros(n, np.complex128)
        spec[np.asarray(bins) % n] = amps
        return np.resize(np.fft.ifft(spec) * n, n_samples)

    def gate(a, b):
        g = np.zeros(n_samples, np.float32)
        g[int(a * blk):int(b * blk)] = 1.0
        return g

    x = 0.01 * (rng.standard_normal(n_samples)
                + 1j * rng.standard_normal(n_samples))
    x += periodic([TONE_BIN, 1000], [1.0, 1.0])
    x += gate(1 / 3, 2.5) * periodic([int(-0.45 * n)], [0.5])
    seg_lo = int(0.91 * n) - n // 2  # segment (0.41, 0.49) in bins
    for off, a, b in ((20, 0.1, 1.6), (150, 0.7, 3.3), (260, 2.2, 4.4)):
        ph = np.exp(1j * rng.uniform(0.0, 2 * np.pi, 24))
        x += gate(a, b) * periodic(seg_lo + off + np.arange(24), 0.3 * ph)
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


@contextlib.contextmanager
def plain_path():
    """Route the main path through the plain PyTorch versions (for the
    plain-path timing on the card): the kernel wrappers are swapped for
    their plain twins in the modules that call them."""
    from fdc_tpu_torch.ops import detect, extract_fused, lifecycle

    saved = (extract_fused.extract_shared, detect.greedy_accept_batch,
             lifecycle.slot_lifecycle_multi)
    extract_fused.extract_shared = extract_fused.extract_shared_plain
    detect.greedy_accept_batch = detect.greedy_accept_batch_plain
    lifecycle.slot_lifecycle_multi = lifecycle.slot_lifecycle_multi_plain
    try:
        yield
    finally:
        (extract_fused.extract_shared, detect.greedy_accept_batch,
         lifecycle.slot_lifecycle_multi) = saved


def kernel_cases(fdc, x):
    """The three kernels' inputs at the flagship step's shapes, taken from
    the scripted capture's first batch: (name, kernel call, plain call,
    comparator) per kernel."""
    import torch

    from fdc_tpu_torch.ops import detect, extract_fused, lifecycle
    from fdc_tpu_torch.ops.fft import forward_spectrum
    from fdc_tpu_torch.ops.framing import frame_blocks

    cfg = fdc.config
    dev = fdc.device
    xt = torch.from_numpy(x[:fdc.batch_samples]).to(dev)
    hist = torch.zeros(cfg.ovllen, dtype=torch.complex64, device=dev)
    spec = forward_spectrum(frame_blocks(xt, hist, cfg.blocksize)[0])
    spec_ext = torch.cat([spec[-1:], spec])
    tp = fdc.throughput
    starts, folded = tp.tables(tp.buckets[0])
    pa = fdc.power_bank
    pa_starts, pa_folded = pa.tables(pa.buckets[0])
    masks = fdc.measure_masks
    sd = fdc.segments[0]

    _, powers = extract_fused.extract_shared_plain(spec, starts, folded,
                                                   masks)
    lo, hi = fdc._measure_cols["seg0"]
    seg_power = powers[:, lo:hi].contiguous()
    cs, ce, hp = detect.detect_edges(seg_power, sd.thresh, sd.k_detect)
    pack = sd._packed_candidates(seg_power)
    # a busy slot table entering the batch: a third of the slots live
    rng = np.random.default_rng(7)
    s = sd.max_slots
    g = sd.geometry
    es = rng.integers(g.start, g.stop - 64, s)
    state = sd.init_state(dev)
    state.update(
        active=torch.from_numpy(rng.random(s) < 0.33).to(dev),
        det_start=torch.from_numpy((es + 5).astype(np.int32)).to(dev),
        det_stop=torch.from_numpy(
            (es + 5 + rng.integers(10, 40, s)).astype(np.int32)).to(dev),
        ext_start=torch.from_numpy(es.astype(np.int32)).to(dev),
        wlog2=torch.from_numpy(rng.integers(4, 7, s).astype(np.int32)).to(dev),
        order=torch.arange(s, dtype=torch.int32, device=dev),
        alloc_counter=torch.tensor(s, dtype=torch.int32, device=dev),
    )
    pa_lo, pa_hi = fdc._measure_cols["powact"]
    powact = {
        "powers": torch.clamp(powers[:, pa_lo:pa_hi], min=1e-38).contiguous(),
        "lastpower": torch.ones(1, dtype=torch.float32, device=dev),
        "active": torch.zeros(1, dtype=torch.bool, device=dev),
        "phase": torch.zeros(1, dtype=torch.int32, device=dev),
        "delta": pa.delta,
    }
    lc_kw = dict(n_cands=(sd.k_pack,), rs=(sd.relinvovl,),
                 delays=(sd.deactivation_delay,), powact=powact,
                 pa_r=pa.relinvovl, pa_thresh=pa.thresh)

    def cmp_extract(a, b):
        ok1, e1 = close(a[0].cpu(), b[0].cpu(), RTOL, ATOL)
        ok2, e2 = close(a[1].cpu(), b[1].cpu(), PRTOL, 0.0)
        assert ok1 and ok2, ("extract_shared", e1, e2)
        return max(e1, e2)

    def cmp_burst(a, b):
        ok, e = close(a.cpu(), b.cpu(), RTOL, ATOL)
        assert ok, ("extract_shared burst bucket", e)
        return e

    def cmp_exact(a, b):
        fa, fb = flatten(a), flatten(b)
        for k in fa:
            assert np.array_equal(fa[k], fb[k]), k
        return 0.0

    return [
        ("extract_shared",
         lambda: extract_fused.extract_shared(spec, starts, folded, masks),
         lambda: extract_fused.extract_shared_plain(spec, starts, folded,
                                                    masks),
         cmp_extract, "throughput bucket [64, 512, 48, 2] + powers [512, 128]"),
        ("extract_shared",
         lambda: extract_fused.extract_shared(spec_ext, pa_starts, pa_folded),
         lambda: extract_fused.extract_shared_plain(spec_ext, pa_starts,
                                                    pa_folded),
         cmp_burst, "burst bucket [1, 513, 96, 2]"),
        ("greedy_accept",
         lambda: detect.greedy_accept_batch(cs, ce, hp),
         lambda: detect.greedy_accept_batch_plain(cs, ce, hp),
         cmp_exact, f"candidate rows {list(cs.shape)}"),
        ("slot_lifecycle",
         lambda: lifecycle.slot_lifecycle_multi((pack,), (state,), **lc_kw),
         lambda: lifecycle.slot_lifecycle_multi_plain((pack,), (state,),
                                                      **lc_kw),
         cmp_exact, f"pack {list(pack.shape)}, S={s}, burst C=1"),
    ]


KERNELS = {
    "extract_shared": ("fdc_tpu_torch/csrc/extract_shared.cu",
                       "fdc_tpu/ops/extract_pallas.py:96"),
    "greedy_accept": ("fdc_tpu_torch/csrc/greedy_accept.cu",
                      "fdc_tpu/ops/detect.py:183"),
    "slot_lifecycle": ("fdc_tpu_torch/csrc/lifecycle.cu",
                       "fdc_tpu/ops/lifecycle_pallas.py:53"),
}


def counters():
    from fdc_tpu_torch.ops import detect, extract_fused, lifecycle

    return {
        "extract_shared": extract_fused.extract_shared,
        "greedy_accept": detect.greedy_accept_batch,
        "slot_lifecycle": lifecycle.slot_lifecycle_multi,
    }


def tone_check(res, fdc):
    """Amplitude and SNR of the exact-bin tone in its throughput channel
    (a tone at the channel's offset frequency, amplitude 1)."""
    tp = fdc.throughput
    n = fdc.config.blocksize
    f0 = TONE_BIN / n
    chan = min(
        range(tp.num_channels),
        key=lambda i: abs((tp.geometry[i].start + tp.geometry[i].width / 2)
                          - (f0 + 0.5) * n),
    )
    y = res.throughput[chan][2000:]
    ph = np.unwrap(np.angle(y))
    fit = np.polyfit(np.arange(len(ph)), ph, 1)
    amp = float(np.abs(y).mean())
    tone = np.exp(1j * np.polyval(fit, np.arange(len(ph))))
    snr = float(-10 * np.log10(np.mean(np.abs(y / amp - tone) ** 2) + 1e-30))
    return chan, amp, snr


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (this check runs only on the "
              "card)", file=sys.stderr)
        return 1
    from fdc_tpu_torch import FrequencyDomainChannelizer, kernels
    from fdc_tpu_torch.flagship import _flagship

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
    cfg = _flagship(batch_blocks=512)
    fdc = FrequencyDomainChannelizer(cfg, device=dev)
    n_samples = N_BATCHES * fdc.batch_samples + 7 * cfg.inplen + 1234
    x = scripted_capture(cfg, n_samples)

    # -- phase 2: kernels against their plain versions --------------------
    summary = {}
    cases = kernel_cases(fdc, x)
    for name, kern, plain, cmp, shape in cases:
        got = kern()
        torch.cuda.synchronize()
        err = cmp(got, plain())
        ent = summary.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                        "plain_ms": 0.0})
        ent["max_abs_err"] = max(ent["max_abs_err"], err)
        log(f"phase 2: {name} {shape}: matches plain, max abs err {err:.3g}")

    # -- phase 3: the main path on the card -------------------------------
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
    assert blocks == math.ceil(n_samples / cfg.inplen), blocks
    chan, amp, snr = tone_check(res, fdc)
    assert abs(amp - 1.0) < 0.05 and snr > 25.0, (amp, snr)
    kinds = {}
    for ev in events:
        src = ev.ID.split(".")[1]
        kinds[src] = kinds.get(src, 0) + 1
    fins = [ev for ev in events if ev.finalized]
    assert kinds.get("PowActChan", 0) >= 1 and kinds.get("DETECTED", 0) >= 3
    assert all(ev.blockend >= ev.blockstart >= 0 for ev in events)
    assert all(np.all(np.isfinite(ev.data)) for ev in events)
    for name, n in launches.items():
        assert n > 0, f"{name} was not launched on the main path"
    log(f"phase 3: {blocks} blocks in {wall:.2f} s (host clock, build "
        f"excluded); tone in channel {chan}: amp {amp:.4f}, SNR "
        f"{snr:.1f} dB; events {kinds}, {len(fins)} finalized; "
        f"launches {launches}")

    # -- phase 4: plain versions on the CPU, same capture ------------------
    n_cpu = 2 * fdc.batch_samples
    cpu = FrequencyDomainChannelizer(cfg, device="cpu")
    gpu = FrequencyDomainChannelizer(cfg, device=dev)
    cc, gc = cpu._device_init(), gpu._device_init()
    worst = 0.0
    for step in range(2):
        chunk = torch.from_numpy(
            x[step * fdc.batch_samples:(step + 1) * fdc.batch_samples])
        cc, co = cpu._device_step(cc, chunk, step * cfg.batch_blocks)
        gc, go = gpu._device_step(gc, chunk.to(dev), step * cfg.batch_blocks)
        worst = max(worst, compare_outputs(go, co, f"step {step}"))
        compare_outputs(gc, cc, f"carry after step {step}")
    cpu.reset()
    gpu.reset()
    ev_c = cpu.process(x[:n_cpu]).events + cpu.flush().events
    ev_g = gpu.process(x[:n_cpu]).events + gpu.flush().events
    compare_events(ev_g, ev_c, "events")
    log(f"phase 4: 2 steps card == cpu plain (max abs err {worst:.3g}), "
        f"{len(ev_g)} events identical")

    # -- phase 5: timing ---------------------------------------------------
    xb = torch.from_numpy(x[:fdc.batch_samples]).to(dev)
    carry = [fdc._device_init()]

    def step():
        carry[0], _ = fdc._device_step(carry[0], xb, 0)

    ms = cuda_time(step, 20)
    with plain_path():
        ms_plain = cuda_time(step, 3)
    msps = fdc.batch_samples / ms / 1e3
    msps_plain = fdc.batch_samples / ms_plain / 1e3
    log(f"phase 5: flagship step B=512: kernel path {ms:.4f} ms "
        f"({msps:.1f} MS/s), plain path {ms_plain:.4f} ms "
        f"({msps_plain:.1f} MS/s) {card}")
    for name, kern, plain, _, shape in cases:
        k_ms = cuda_time(kern, 50)
        p_ms = cuda_time(plain, 3 if name == "slot_lifecycle" else 50)
        summary[name]["ms"] += k_ms
        summary[name]["plain_ms"] += p_ms
        log(f"phase 5: {name} {shape}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms {card}")

    rows = []
    for name, (src, replaces) in KERNELS.items():
        ent = summary[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": ent["max_abs_err"], "ms": ent["ms"],
                     "plain_ms": ent["plain_ms"]})
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
