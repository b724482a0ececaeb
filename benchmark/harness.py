"""The benchmark's run of one cell: build, warm up, measure, judge, report.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in ``BENCHMARK.json``: ``configs/<name>.json`` (the
channelizer's keyword arguments, frozen, with the name of the reference
module that judges it and the limits of its compared numbers),
``traffic/<mix>.json`` (laid by ``traffic/generator.py``) and
``metrics/<metric>.py`` (a ``read(ctx)`` that returns the metric, or None
where it finds nothing to read).

A run is one stream through ``FrequencyDomainChannelizer.process()`` on a
closed loop: call k gets batch ``k % P`` of the cell's ring of P
batches, as a host array, and the next call starts when the previous one
has returned. The first calls warm up (the first captures the step's
CUDA graph) and count as set-up; the window then runs for ``seconds``.
After it, ``flush()`` ends the stream, the device's peak memory is read,
the program is freed, and the reference judges a sample of the window's
calls, drawn from the seed, and every call's event count.

With ``trace``, the harness's spans time the program's copy-out and
emission (the device is synchronised after each step, so they hold no
device wait), and ``torch.profiler`` records a sub-window of calls.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from benchmark import trace as tr
from benchmark.traffic import generator

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"
SAMPLED_CALLS = 24
WARMUP_CALLS = SAMPLED_CALLS + 3
# the profiled sub-window: skipped and warm-up steps of the profiler, then
# the active ones
PROFILE_WAIT, PROFILE_WARMUP, PROFILE_ACTIVE = 1, 2, 16
FOREIGN = {"jax", "jaxlib", "flax", "fdc_tpu"}


class BenchError(RuntimeError):
    """A run that cannot give a result."""


@dataclass
class Record:
    """What the judge reads of a run (see ``reference/compare.py``)."""

    period: int
    counts: list = field(default_factory=list)
    sampled: dict = field(default_factory=dict)


@dataclass
class Context:
    """What the metric readers read."""

    cfg: dict
    device_kind: str = ""
    setup_s: float = None
    window_s: float = None
    samples_done: int = 0
    latencies: list = field(default_factory=list)
    first_call: int = 0
    spans: tr.Spans = None
    span_calls: int = 0
    trace: tr.Trace = None


def bench_file() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(bench: dict, workload: str):
    """(workload entry, configuration file, mix) of a cell by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    return cell, config, mix


def metrics_of(bench: dict, workload: str, traced: bool):
    """The cell's metric entries: per-layer ones in a traced run, else
    end-to-end ones."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def foreign_modules(names=None):
    """Loaded modules (or ``names``) whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole: the port's name
    begins with the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & FOREIGN)


def make_program(cfg: dict, device: str):
    from fdc_tpu_torch import FrequencyDomainChannelizer
    from fdc_tpu_torch.config import ChannelizerConfig

    return FrequencyDomainChannelizer(ChannelizerConfig(**cfg), device=device)


def instrument(ch, spans: tr.Spans, cuda: bool):
    """The traced run's spans around the program's process() calls and
    its step, copy-out and emitters inside them (a step is followed by a
    device synchronisation); returns what puts the module's functions
    back."""
    import torch

    import fdc_tpu_torch.models.channelizer as chmod

    saved = (chmod._to_host, chmod._pairs_to_complex)

    def undo():
        chmod._to_host, chmod._pairs_to_complex = saved

    sync = torch.cuda.synchronize if cuda else None
    ch.process = spans.wrap("bench.process", ch.process)
    ch._run_step = spans.wrap("bench.step", ch._run_step, after=sync)
    chmod._to_host = spans.wrap("bench.to_host", chmod._to_host,
                                outermost=True)
    chmod._pairs_to_complex = spans.wrap("bench.pairs_to_complex",
                                         chmod._pairs_to_complex)
    emitters = [ch.power_emitter] if ch.power_emitter else []
    for em in emitters + list(ch.segment_emitters):
        em.process_step = spans.wrap("bench.emit", em.process_step)
    return undo


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             t_start: float, device: str = "cuda", cfg_over=None,
             mix_over=None, fault=None, program=None,
             chips: int = 1) -> dict:
    """One run of a cell; returns the result line's object. ``cfg_over`` /
    ``mix_over`` (tests) change the configuration or the mix; ``fault``
    (tests) is applied to the program once built; ``program`` makes the
    system under test from the configuration's dict (default: the
    channelizer on ``device``)."""
    import torch

    bench = bench_file()
    cell, config, mix = cell_of(bench, workload)
    cfg = dict(config["channelizer"], **(cfg_over or {}))
    mix = dict(mix, **(mix_over or {}))
    cuda = device.startswith("cuda")
    period = int(mix["ring_batches"])
    marks = [("imports", time.perf_counter())]
    ring = generator.ring(cfg, mix, seed)
    bs = len(ring) // period
    marks.append(("ring", time.perf_counter()))
    ch = (program or (lambda c: make_program(c, device)))(cfg)
    marks.append(("channelizer", time.perf_counter()))
    if fault is not None:
        fault(ch)
    spans = tr.Spans() if traced else None
    undo = instrument(ch, spans, cuda) if traced else None
    rec = Record(period=period)

    def call(k):
        res = ch.process(ring[(k % period) * bs:(k % period + 1) * bs])
        rec.counts.append(len(res.events))
        return res

    try:
        # the warm-up holds its last results as the window's sample of
        # calls will hold its own, so that the heap has grown to the
        # window's size before it opens
        held = [call(k) for k in range(WARMUP_CALLS)][-SAMPLED_CALLS:]
        del held
        if traced:
            warm_profiler(cuda)
        if cuda:
            torch.cuda.synchronize()
        ctx = Context(cfg=cfg, device_kind=(torch.cuda.get_device_name(0)
                                            if cuda else "cpu"))
        ctx.setup_s = time.perf_counter() - t_start
        marks.append(("warm-up calls", time.perf_counter()))
        print("benchmark: set-up s: " + ", ".join(
            f"{name} {t - t0:.3f}" for (name, t), (_, t0)
            in zip(marks, [("start", t_start)] + marks)), file=sys.stderr)
        ctx.trace = _window(ctx, call, rec, seconds, seed, bs, spans, cuda)
        ch.flush()
        if cuda:
            torch.cuda.synchronize()
            peak = int(torch.cuda.max_memory_allocated())
        else:
            peak = 0
    finally:
        if undo is not None:
            undo()
    del ch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    attempted = len(rec.counts) - WARMUP_CALLS
    judge = importlib.import_module(
        f"benchmark.reference.{config['reference']}").judge
    t = time.perf_counter()
    nums = judge(cfg, ring, rec)
    print(f"benchmark: the reference judged {len(rec.sampled)} calls and "
          f"{len(rec.counts)} event counts in {time.perf_counter() - t:.3f}"
          " s", file=sys.stderr)
    limits = config["limits"]
    over = {k for k, v in nums.items() if not v <= limits[k]}
    out_metrics = {}
    for m in metrics_of(bench, workload, traced):
        v = reader(m["name"])(ctx)
        if v is None:
            raise BenchError(f"metric {m['name']} found nothing to read")
        out_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": ctx.device_kind,
           "count": chips, "memory_peak_bytes": peak}
    # answers found wrong: calls with another event count, events that
    # differ, and every sampled call where a sample error is over its limit
    failed = int(nums["count_miss"] + nums["event_miss"])
    if any(k.endswith("_err") for k in over):
        failed += len(rec.sampled)
    result = {"correct": not over, "attempted": attempted, "failed": failed,
              "metrics": out_metrics, "device": dev}
    if ctx.trace is not None:
        dev["busy_s"] = tr.busy_seconds(ctx.trace)
        dev["window_s"] = ctx.trace.seconds
        result["breakdown"] = tr.breakdown(ctx.trace)
    result["compared"] = {k: {"value": v, "limit": limits[k]}
                          for k, v in nums.items()}
    return result


def _window(ctx, call, rec, seconds, seed, bs, spans, cuda):
    """The measured window; returns the profiled sub-window's trace in a
    traced run (the profiler starts a quarter into the window)."""
    rng = generator.rng_of(seed, 2)
    reservoir = []
    prof = trace_dir = first = None
    profiled = PROFILE_WAIT + PROFILE_WARMUP + PROFILE_ACTIVE
    seen = 0
    k = ctx.first_call = WARMUP_CALLS
    t0 = time.perf_counter()
    t_end = t0 + seconds
    prof_at = t0 + 0.25 * seconds
    while True:
        t = time.perf_counter()
        if t >= t_end:
            break
        if spans is not None:
            spans.call = k
            if first is None and t >= prof_at:
                first = k
                t_start_prof = t
                spans.skip = set(range(k, k + profiled))
                trace_dir = tempfile.mkdtemp(prefix="bench_trace_")
                prof = _profiler(trace_dir, cuda)
                prof.__enter__()
                t_prof = time.perf_counter()
                t = t_prof
        res = call(k)
        t1 = time.perf_counter()
        ctx.latencies.append(t1 - t)
        if t1 <= t_end:
            ctx.samples_done += bs
        if len(reservoir) < SAMPLED_CALLS:
            reservoir.append((k, res))
        else:
            j = int(rng.integers(0, seen + 1))
            if j < SAMPLED_CALLS:
                reservoir[j] = (k, res)
        seen += 1
        if prof is not None:
            prof.step()
            if k + 1 == first + profiled:
                prof.__exit__(None, None, None)
                prof = None
                print(f"benchmark: profiler started in "
                      f"{t_prof - t_start_prof:.3f} s; {profiled} profiled "
                      f"calls and the trace's export took "
                      f"{time.perf_counter() - t_prof:.3f} s",
                      file=sys.stderr)
        k += 1
    del res
    ctx.window_s = seconds
    rec.sampled = dict(reservoir)
    lat = np.array(ctx.latencies) * 1e3
    if len(lat):
        pos = (np.arange(len(lat)) + WARMUP_CALLS) % rec.period
        print("benchmark: median ms a call by quarter of the window: "
              + " ".join(f"{np.median(x):.3f}"
                         for x in np.array_split(lat, 4) if len(x))
              + "; at p50 / p90 / p95 / p99 / max: " + " / ".join(
                  f"{x:.2f}" for x in np.percentile(lat, [50, 90, 95, 99,
                                                          100]))
              + "; by batch of the ring: " + " ".join(
                  f"{np.median(lat[pos == j]):.2f}"
                  for j in range(rec.period) if (pos == j).any())
              + "; events of the window's first ring: " + " ".join(
                  map(str, rec.counts[WARMUP_CALLS:][:rec.period])),
              file=sys.stderr)
    if spans is None:
        return None
    spans.call = -1
    ctx.spans = spans
    ctx.span_calls = sum(1 for c in range(WARMUP_CALLS, k)
                         if c not in spans.skip)
    try:
        if prof is not None:
            prof.__exit__(None, None, None)
        if first is None or prof is not None:
            raise BenchError(f"the window ended before {profiled} calls "
                             "were profiled")
        files = sorted(Path(trace_dir).glob("*.json"))
        if not files:
            raise BenchError("the profiler wrote no trace")
        return tr.read_trace(str(files[0]), PROFILE_ACTIVE)
    finally:
        if trace_dir is not None:
            shutil.rmtree(trace_dir, ignore_errors=True)


def _activities(cuda: bool):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def warm_profiler(cuda: bool):
    """One empty profile, so that the profiler's own start-up (CUPTI's)
    falls into set-up and not into the window."""
    import torch

    with torch.profiler.profile(activities=_activities(cuda)):
        if cuda:
            torch.cuda.synchronize()


def _profiler(trace_dir: str, cuda: bool):
    import torch

    def ready(p):
        p.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

    return torch.profiler.profile(
        activities=_activities(cuda),
        schedule=torch.profiler.schedule(wait=PROFILE_WAIT,
                                         warmup=PROFILE_WARMUP,
                                         active=PROFILE_ACTIVE, repeat=1),
        on_trace_ready=ready)
