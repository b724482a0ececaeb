"""The port's tracer (``fdc_tpu_torch.runtime.tracing``) on the CPU.

Off (the default), ``process()`` records nothing and reads no clock for
it, and never opens a profiler range; on, every call holds the span tree
of the host path (``fdc.process`` down to ``fdc.emit``), the counters
hold the bytes copied in (all of them from the staging slot) and out (all
of them into the output mirror) and the captures, and the outputs and
events are the same as with tracing off. Under ``torch.profiler`` the
spans land in its Chrome trace as user annotations.
"""

import ctypes
import json
import types

import numpy as np
import pytest
import torch

from fdc_tpu_torch import FrequencyDomainChannelizer
from fdc_tpu_torch import kernels
from fdc_tpu_torch.flagship import _flagship
from fdc_tpu_torch.runtime import tracing
from fdc_tpu_torch.runtime.tracing import Record

SMALL = dict(blocksize=1024, batch_blocks=8, n_channels=16)
CALLS = 4

PARENT = {
    "fdc.stage": "fdc.process", "fdc.result": "fdc.process",
    "fdc.step": "fdc.process", "fdc.consume": "fdc.process",
    "fdc.copy_in": "fdc.step", "fdc.capture": "fdc.step",
    "fdc.replay": "fdc.step", "fdc.device_wait": "fdc.step",
    "fdc.to_host": "fdc.consume", "fdc.pairs_to_complex": "fdc.consume",
    "fdc.emit": "fdc.consume", "fdc.assemble": "fdc.consume",
}
# every call's spans; the first call captures where the later ones replay
EVERY_CALL = set(PARENT) - {"fdc.capture", "fdc.replay"}
# counter -> the span it is counted in; the first call's capture adds
# graph_captures, a fill that finds its slot's copy-in in flight (only on
# the card) stage_waits
COUNTED_IN = {
    "h2d_bytes": "fdc.copy_in", "h2d_staged_bytes": "fdc.step",
    "d2h_bytes": "fdc.to_host", "graph_captures": "fdc.step",
    "stage_waits": "fdc.stage",
}
EVERY_CALL_COUNTERS = set(COUNTED_IN) - {"graph_captures", "stage_waits"}


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def channelizer():
    return FrequencyDomainChannelizer(_flagship(**SMALL), device="cpu")


def capture(cfg, n_batches, seed=0):
    """Noise, tones in two throughput channels, a gated carrier in the
    burst band and gated carriers in the detection segment, ~50 dB over
    the noise: every output of the step carries something."""
    rng = np.random.default_rng(seed)
    n = cfg.blocksize
    blk = cfg.batch_blocks * cfg.inplen
    n_samples = n_batches * blk

    def periodic(bins, amps):
        spec = np.zeros(n, np.complex128)
        spec[np.asarray(bins) % n] = amps
        return np.resize(np.fft.ifft(spec) * n, n_samples)

    def gate(a, b):
        g = np.zeros(n_samples)
        g[int(a * blk):int(b * blk)] = 1.0
        return g

    x = 0.01 * (rng.standard_normal(n_samples)
                + 1j * rng.standard_normal(n_samples))
    x += periodic([-300, 120], [1.0, 1.0])
    x += gate(0.6, 2.3) * periodic([int(-0.45 * n)], [0.5])
    seg_lo = int(0.91 * n) - n // 2
    for off, a, b in ((4, 0.3, 1.7), (40, 1.2, 3.6)):
        ph = np.exp(1j * rng.uniform(0, 2 * np.pi, 12))
        x += gate(a, b) * periodic(seg_lo + off + np.arange(12), 0.3 * ph)
    return x.astype(np.complex64)


def spectra_of(cfg, n_batches, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n_batches * cfg.batch_blocks, cfg.blocksize)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def run(fdc, entry, x, calls=CALLS):
    """``calls`` calls of ``entry`` on equal slices of ``x``."""
    per = len(x) // calls
    return [getattr(fdc, entry)(x[k * per:(k + 1) * per])
            for k in range(calls)]


def input_of(fdc, entry):
    cfg = fdc.config
    return (capture(cfg, CALLS) if entry == "process"
            else spectra_of(cfg, CALLS))


def meta(ev):
    d = ev.to_dict()
    d["ID"] = d["ID"].split(".", 1)[1]  # drop the wall-clock prefix
    return d


@pytest.mark.parametrize("entry", ["process", "process_spectra"])
def test_off_records_nothing_and_opens_no_profiler_range(monkeypatch, entry):
    def boom(*a, **k):
        raise AssertionError("tracing off reached the profiler or clock")

    fdc = channelizer()
    x = input_of(fdc, entry)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(tracing, "_clock", boom)
    # under a running profiler, where an enabled span would open a range
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.autograd._profiler_enabled()
        run(fdc, entry, x)
    assert tracing.records() == []
    assert tracing.summary() == {"spans": {}, "counters": {}, "dropped": 0}
    # the same calls with tracing on do reach both
    tracing.enable()
    with pytest.raises(AssertionError, match="tracing off reached"):
        fdc.process(x[:100]) if entry == "process" else fdc.process_spectra(
            x[:1])


def test_outputs_and_events_equal_on_and_off():
    results = {}
    for on in (False, True):
        tracing.reset()
        if on:
            tracing.enable()
        fdc = channelizer()
        x = capture(fdc.config, CALLS)
        res = run(fdc, "process", x) + [fdc.flush()]
        tracing.disable()
        results[on] = res
    assert sum(len(r.events) for r in results[False]) > 0
    for off, on in zip(results[False], results[True]):
        assert len(off.throughput) == len(on.throughput)
        for a, b in zip(off.throughput, on.throughput):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(off.segment_power, on.segment_power):
            np.testing.assert_array_equal(a, b)
        assert [meta(e) for e in off.events] == [meta(e) for e in on.events]
        for a, b in zip(off.events, on.events):
            np.testing.assert_array_equal(a.data, b.data)
        assert off.blocks_processed == on.blocks_processed


@pytest.mark.parametrize("entry", ["process", "process_spectra"])
def test_every_span_in_every_call_nested_in_its_parent(entry):
    fdc = channelizer()
    x = input_of(fdc, entry)
    tracing.enable()
    run(fdc, entry, x)
    recs = tracing.records()
    top = f"fdc.{entry}"
    parent_of = dict(PARENT, **{k: top for k, v in PARENT.items()
                                if v == "fdc.process"})
    assert {r.call for r in recs} == set(range(CALLS))
    for call in range(CALLS):
        mine = [r for r in recs if r.call == call]
        names = {r.name for r in mine}
        assert [r.name for r in mine if r.parent < 0] == [top]
        assert EVERY_CALL <= names
        assert ("fdc.capture" in names) == (call == 0)
        assert ("fdc.replay" in names) == (call > 0)
        assert names <= set(parent_of) | {top}
    for r in recs:
        assert 0 <= r.start_ns <= r.end_ns
        if r.parent < 0:
            continue
        p = recs[r.parent]
        assert p.name == parent_of[r.name]
        assert p.call == r.call
        assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    emits = [r.tag for r in recs if r.name == "fdc.emit" and r.call == 1]
    assert emits == ["powact"] + list(range(len(fdc.segments)))


def test_summary_self_time_on_hand_built_records():
    recs = [
        Record("fdc.process", None, -1, 0, 0, 100),
        Record("fdc.step", None, 0, 0, 10, 50),
        Record("fdc.copy_in", None, 1, 0, 12, 20),
        Record("fdc.replay", None, 1, 0, 20, 45),
        Record("fdc.consume", None, 0, 0, 55, 90),
        Record("fdc.emit", 0, 4, 0, 60, 70),
        Record("fdc.emit", 1, 4, 0, 70, 85),
        Record("fdc.process", None, -1, 1, 200, 260),
        Record("fdc.step", None, 7, 1, 210, 240),
        Record("fdc.process", None, -1, 2, 300, -1),  # still open
    ]
    counters = {("h2d_bytes", 0): 8, ("h2d_bytes", 1): 8,
                ("h2d_staged_bytes", 0): 8, ("h2d_staged_bytes", 1): 8,
                ("stage_waits", 1): 1, ("graph_captures", 0): 1}
    s = tracing.summarize(recs, counters)
    assert s["spans"]["fdc.process"] == {"count": 2, "total_ns": 160,
                                         "self_ns": 160 - 40 - 35 - 30}
    assert s["spans"]["fdc.step"] == {"count": 2, "total_ns": 70,
                                      "self_ns": 70 - 8 - 25}
    assert s["spans"]["fdc.consume"]["self_ns"] == 35 - 10 - 15
    assert s["spans"]["fdc.emit"] == {"count": 2, "total_ns": 25,
                                      "self_ns": 25}
    assert s["counters"] == {"h2d_bytes": 16, "h2d_staged_bytes": 16,
                             "stage_waits": 1, "graph_captures": 1}
    one = tracing.summarize(recs, counters, calls=[1])
    assert one["spans"] == {
        "fdc.process": {"count": 1, "total_ns": 60, "self_ns": 30},
        "fdc.step": {"count": 1, "total_ns": 30, "self_ns": 30}}
    assert one["counters"] == {"h2d_bytes": 8, "h2d_staged_bytes": 8,
                               "stage_waits": 1}
    assert tracing.summarize(recs, counters, calls=[0])["counters"] == {
        "h2d_bytes": 8, "h2d_staged_bytes": 8, "graph_captures": 1}


def test_byte_and_capture_counters():
    fdc = channelizer()
    cfg = fdc.config
    x = capture(cfg, CALLS)
    tracing.enable()
    run(fdc, "process", x)
    out = fdc._jit_step._entries[next(iter(fdc._jit_step._entries))].out
    out_bytes = sum(t.nbytes for t in _leaves(out))
    for call in range(CALLS):
        c = tracing.summary(calls=[call])["counters"]
        assert set(c) == EVERY_CALL_COUNTERS | (
            {"graph_captures"} if call == 0 else set())
        assert c["h2d_bytes"] == cfg.batch_blocks * cfg.inplen * 8
        assert c["h2d_staged_bytes"] == c["h2d_bytes"]
        assert c["d2h_bytes"] == out_bytes
        assert c.get("graph_captures", 0) == (call == 0)
    assert tracing.summary()["counters"]["graph_captures"] == 1


@pytest.mark.parametrize("entry", ["process", "process_spectra"])
def test_each_counter_counted_in_its_span(monkeypatch, entry):
    fdc = channelizer()
    x = input_of(fdc, entry)
    seen = set()
    count = tracing.count

    def located(name, n):
        seen.add((name, tracing.records()[tracing._stack[-1]].name))
        count(name, n)

    monkeypatch.setattr(tracing, "count", located)
    tracing.enable()
    run(fdc, entry, x)
    assert seen == {(k, v) for k, v in COUNTED_IN.items()
                    if k != "stage_waits"}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_full_buffer_counts_what_it_drops(monkeypatch):
    fdc = channelizer()
    x = capture(fdc.config, 2)
    tracing.enable()
    monkeypatch.setattr(tracing, "CAPACITY", 5)
    run(fdc, "process", x, calls=2)
    s = tracing.summary()
    assert len(tracing.records()) == 5
    assert s["dropped"] > 0
    assert sum(v["count"] for v in s["spans"].values()) == 5


def test_kernel_build_span_on_the_library_first_load(monkeypatch):
    class Lib:
        def __getattr__(self, name):
            return types.SimpleNamespace()

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "_build", lambda: "libfdc_kernels.so")
    monkeypatch.setattr(kernels, "ctypes", types.SimpleNamespace(
        CDLL=lambda path: Lib(), c_int=ctypes.c_int))
    tracing.enable()
    with tracing.call("fdc.process"):
        kernels.library()
        kernels.library()  # loaded: no second span
    assert [r.name for r in tracing.records()] == ["fdc.process",
                                                   "fdc.kernel_build"]


def test_spans_in_the_profilers_chrome_trace(tmp_path):
    fdc = channelizer()
    x = capture(fdc.config, 2)
    tracing.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run(fdc, "process", x, calls=2)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {ev["name"] for ev in events
             if ev.get("ph") == "X" and ev.get("cat") == "user_annotation"}
    assert {"fdc.process", "fdc.step", "fdc.consume", "fdc.emit",
            "fdc.copy_in", "fdc.device_wait"} | EVERY_CALL <= names
    # the tracer's own records are kept all the same
    assert {r.call for r in tracing.records()} == {0, 1}
