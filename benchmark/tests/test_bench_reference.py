"""The comparison that decides ``correct``, driven through the harness at
test size on the CPU (the kernels' plain versions), the look for a card
skipped: the program is correct, and the control and every fault the
cells can have are not."""

import time

import numpy as np
import pytest
import torch

from bench_small import small
from benchmark import harness
from benchmark.reference import channelizer as ref
from benchmark.reference.control import ControlProgram

CELLS = ("flagship.mixed", "hunter4seg.bursty")


def run(workload, seed=2**31 + 99, seconds=3.0, **kw):
    co, mo = small(workload)
    return harness.run_cell(workload, seed, seconds, False,
                            time.perf_counter(), device="cpu", cfg_over=co,
                            mix_over=mo, **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_program_is_correct(workload):
    r = run(workload)
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {
        m["name"] for m in harness.metrics_of(harness.bench_file(),
                                              workload, False)}
    assert {"stream_msps", "setup_s"} <= set(r["metrics"])
    assert list(r)[-1] == "compared"


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The reference in TF32 in the program's place."""
    r = run(workload, program=ControlProgram)
    assert not r["correct"]
    lim = {k: c["limit"] for k, c in r["compared"].items()}
    worst = max(c["value"] / lim[k] for k, c in r["compared"].items()
                if k.endswith("_err"))
    assert worst > 3.0, r["compared"]


def frozen_state(ch):
    """A step that returns its state unchanged."""
    run_step = ch._run_step

    def step(compiled, chunk):
        keep = {k: v for k, v in ch._carry.items()} if ch._carry else None
        snap = _clone(keep)
        out = run_step(compiled, chunk)
        if snap is not None:
            _copy(ch._carry, snap)
        return out

    ch._run_step = step


def _clone(t):
    if isinstance(t, dict):
        return {k: _clone(v) for k, v in t.items()}
    return t.clone() if isinstance(t, torch.Tensor) else t


def _copy(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _copy(dst[k], v)
        else:
            dst[k].copy_(v)


def half_batch(ch):
    """Half of each batch left out: its second half handed in as zeros."""
    process = ch.process

    def proc(samples):
        x = np.array(samples)
        x[len(x) // 2:] = 0
        return process(x)

    ch.process = proc


def altered_stream(ch):
    """An answer altered where it is produced: one stream sample."""
    consume = ch._consume_outputs

    def consume_altered(out, result, dbg, t0=None):
        consume(out, result, dbg, t0)
        if result.throughput:
            s = result.throughput[0]
            s[len(s) // 2] += 0.01 * np.abs(s).max()

    ch._consume_outputs = consume_altered


def altered_event(ch):
    """An answer altered where it is produced: one event's last block."""
    consume = ch._consume_outputs

    def consume_altered(out, result, dbg, t0=None):
        consume(out, result, dbg, t0)
        if result.events:
            result.events[-1].blockend += 1

    ch._consume_outputs = consume_altered


def dropped_event(ch):
    """An answer left out: every call's first event."""
    consume = ch._consume_outputs

    def consume_dropped(out, result, dbg, t0=None):
        consume(out, result, dbg, t0)
        del result.events[:1]

    ch._consume_outputs = consume_dropped


# every fault each cell can have (hunter4seg has no throughput stream)
FAULTS = [(w, f) for w in CELLS
          for f in (frozen_state, half_batch, altered_stream, altered_event,
                    dropped_event)
          if not (f is altered_stream and w == "hunter4seg.bursty")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(workload, fault):
    r = run(workload, fault=fault)
    assert not r["correct"], r["compared"]


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0000001],
                 np.float32)
    assert list(ref.tf32(x)) == [1.0, 1.0, 1.0 + 2**-9, -3.0]
    z = ref.tf32(np.array([1 + 2**-12 + 1j], np.complex64))
    assert z[0] == 1 + 1j
