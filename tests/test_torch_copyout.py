"""The copy-out of a step's outputs (``runtime.compiled._to_host``) on the
CPU.

Every output of a batch is copied into one host mirror of the step's
output tree, kept across calls (``HostMirror``: page-locked on the card,
the copies queued without blocking and waited for once), and read from
there; what outlives the batch is copied out of it. The channelizer's
``_consume``, the pipeline's join of a lane group and the vcm runner
each copy out through a mirror of their own. Here: results held by the
caller stay as they were returned through later calls; outputs, debug
spectra and events equal those of a copy-out into fresh memory
(:func:`fresh`), bit for bit, with the Python and the native emitters;
one buffer serves every call and is made again only for a new tree;
``d2h_bytes`` counts the mirror's bytes once a step. Tests marked
``cuda`` (no JAX) hold the page-locked mirror, its wait and the vcm
runner's slot and mirror on the card.
"""

import copy

import numpy as np
import pytest
import torch

import fdc_tpu_torch.models.activity_detection as admod
import fdc_tpu_torch.models.channelizer as chmod
import fdc_tpu_torch.parallel.pipeline as pipemod
from fdc_tpu_torch import ActivityDetectionChannelizer
from fdc_tpu_torch import FrequencyDomainChannelizer
from fdc_tpu_torch.flagship import _flagship
from fdc_tpu_torch.parallel import PipelineChannelizer
from fdc_tpu_torch.runtime import native, tracing
from fdc_tpu_torch.runtime.compiled import HostMirror, _to_host

from test_torch_staging import assert_bit_equal, host, leaves
from test_torch_tracing import SMALL, capture, meta, spectra_of

N_BATCHES = 5
EMITTERS = [False, pytest.param(True, marks=pytest.mark.skipif(
    not native.available(), reason="the native emitters do not build"))]


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def channelizer(device="cpu", native_emission=True, debug=False):
    return FrequencyDomainChannelizer(
        _flagship(**SMALL, native_emission=native_emission, debug=debug),
        device=device)


def stream_of(fdc, entry, n_batches=N_BATCHES):
    cfg = fdc.config
    if entry == "process":
        return capture(cfg, n_batches), fdc.batch_samples
    return spectra_of(cfg, n_batches), cfg.batch_blocks


def bounds_of(rows, n_batches=N_BATCHES):
    """Calls of one batch, two and a half (a burst across their batches),
    half a batch and the rest: every batch count a call can run."""
    cuts = [0, rows, rows + 5 * rows // 2, 4 * rows, n_batches * rows]
    return [c for c in cuts if c <= n_batches * rows]


def fresh(tree):
    """The reference copy-out: each tensor leaf into memory of its own."""
    if isinstance(tree, dict):
        return {k: fresh(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fresh(v) for v in tree)
    return tree.cpu().clone().numpy() if torch.is_tensor(tree) else tree


def fresh_copy_out(monkeypatch, module=chmod):
    """``module``'s copy-out (default: ``_consume``'s) made fresh copies."""
    monkeypatch.setattr(module, "_to_host", lambda tree, mirror: fresh(tree))


def feed(fdc, entry, x, bounds):
    call = getattr(fdc, entry)
    return [call(x[a:b]) for a, b in zip(bounds, bounds[1:])] + [fdc.flush()]


def assert_same_result(got, want):
    """Two ``ProcessResult``s equal field by field, event data included."""
    assert got.blocks_processed == want.blocks_processed
    assert [meta(e) for e in got.events] == [meta(e) for e in want.events]
    pairs = [(e.data, f.data) for e, f in zip(got.events, want.events)]
    pairs += list(zip(got.throughput, want.throughput))
    pairs += list(zip(got.segment_power, want.segment_power))
    pairs.append((got.debug_spectrum, want.debug_spectrum))
    for a, b in pairs:
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("native_emission", EMITTERS)
def test_held_results_survive_later_calls(native_emission):
    """Each result deep-copied as it returns; after every later call (one
    batch, several, a burst across batches, the flush), each held result
    still equals its copy."""
    fdc = channelizer(native_emission=native_emission, debug=True)
    x, rows = stream_of(fdc, "process")
    held, copies = [], []
    for r in feed(fdc, "process", x, bounds_of(rows)):
        held.append(r)
        copies.append(copy.deepcopy(r))
        for got, want in zip(held, copies):
            assert_same_result(got, want)
    assert any(r.events for r in held)
    assert all(r.debug_spectrum is not None for r in held)


@pytest.mark.parametrize("native_emission", EMITTERS)
@pytest.mark.parametrize("entry", ["process", "process_spectra"])
def test_equal_to_a_fresh_copy_out(monkeypatch, entry, native_emission):
    """Outputs, debug spectra and events of the mirror's stream equal those
    of a stream whose copy-out makes fresh copies, bit for bit."""
    fdc = channelizer(native_emission=native_emission, debug=True)
    x, rows = stream_of(fdc, entry)
    got = feed(fdc, entry, x, bounds_of(rows))
    fresh_copy_out(monkeypatch)
    ref = channelizer(native_emission=native_emission, debug=True)
    want = feed(ref, entry, x, bounds_of(rows))
    assert ref._mirror.buffer is None
    assert_bit_equal(got, want)
    for a, b in zip(got, want):
        assert_same_result(a, b)


def test_one_mirror_reused_and_remade_on_a_new_tree():
    """Every call copies into the same buffer, which ``reset()`` keeps;
    ``_to_host`` returns views of it; a tree of another signature makes a
    new one."""
    fdc = channelizer()
    x, rows = stream_of(fdc, "process")
    fdc.process(x[:rows])
    mirror = fdc._mirror
    buf, sig = mirror.buffer, mirror.signature
    assert not buf.is_pinned()  # plain host memory without a card
    fdc.process(x[rows:3 * rows])
    fdc.reset()
    fdc.process(x[:rows])
    assert mirror.buffer is buf and mirror.signature == sig
    out = fdc._jit_step._entries[next(iter(fdc._jit_step._entries))].out
    back = _to_host(out, mirror)
    whole = buf.numpy()
    assert all(np.shares_memory(a, whole) for a in leaves(back))
    assert mirror.buffer is buf
    _to_host({"one": torch.zeros(3)}, mirror)
    assert mirror.buffer is not buf and mirror.signature != sig


def test_mirror_handles_every_leaf_kind():
    """Lists, tuples, 0-d, empty and bool tensors take their places in the
    mirror; numpy leaves and other objects pass as they are."""
    mirror = HostMirror()
    kept = np.arange(4)
    tree = {"a": [torch.arange(5, dtype=torch.int32), (torch.tensor(2.5),)],
            "b": {"flag": torch.tensor([True, False]),
                  "none": torch.zeros(0, 3), "np": kept, "n": 7}}
    back = _to_host(tree, mirror)
    np.testing.assert_array_equal(back["a"][0], np.arange(5))
    assert isinstance(back["a"][1], tuple) and back["a"][1][0] == 2.5
    np.testing.assert_array_equal(back["b"]["flag"], [True, False])
    assert back["b"]["none"].shape == (0, 3)
    assert back["b"]["np"] is kept and back["b"]["n"] == 7
    assert mirror.buffer.nbytes == 3 * HostMirror._ALIGN  # the empty: none


@pytest.mark.parametrize("entry", ["process", "process_spectra"])
def test_every_byte_copied_out_is_mirrored(entry):
    """Per call, ``d2h_bytes`` is the mirror's bytes, the whole output
    tree, once for each step the call ran."""
    fdc = channelizer()
    x, rows = stream_of(fdc, entry)
    call = getattr(fdc, entry)
    bounds = bounds_of(rows)
    tracing.enable()
    results = [call(x[a:b]) for a, b in zip(bounds, bounds[1:])]
    tracing.disable()
    per_step = fdc._mirror._nbytes
    steps = [-(-r.blocks_processed // fdc.config.batch_blocks)
             for r in results]
    for call, n in enumerate(steps):
        c = tracing.summary(calls=[call])["counters"]
        assert c.get("d2h_bytes", 0) == n * per_step
    assert tracing.summary()["counters"]["d2h_bytes"] == sum(
        steps) * per_step


def test_pipeline_join_goes_through_its_mirror(monkeypatch):
    """A pipeline whose workers are groups of two lanes copies each
    batch's lane outputs out once, into the join's mirror (one buffer for
    every batch), and joins from there: results bit-equal to those of a
    join from fresh copies, events those of the plain step and streams
    within the pipeline's tolerance of it (rtol 2e-4 of the max)."""
    cfg = _flagship(**SMALL)
    x, rows = stream_of(channelizer(), "process", 3)
    joins = []
    to_host = pipemod._to_host

    def seen(tree, mirror):
        back = to_host(tree, mirror)
        joins.append((mirror, mirror.buffer, [
            a for a in leaves(back) if isinstance(a, np.ndarray)]))
        return back

    monkeypatch.setattr(pipemod, "_to_host", seen)
    pipe = PipelineChannelizer(cfg, devices=["cpu"] * 3, shard_time=2)
    got = [pipe.process(x), pipe.flush()]
    assert len(joins) == pipe._uses["scan"] >= 3  # one a batch
    assert all(m is pipe._join_mirror and b is joins[0][1]
               for m, b, _ in joins)
    whole = joins[0][1].numpy()
    assert joins[0][2]
    assert all(np.shares_memory(a, whole) for _, _, back in joins
               for a in back)
    fresh_copy_out(monkeypatch, pipemod)
    ref = PipelineChannelizer(cfg, devices=["cpu"] * 3, shard_time=2)
    want = [ref.process(x), ref.flush()]
    assert ref._join_mirror.buffer is None
    for a, b in zip(got, want):
        assert_same_result(a, b)
    plain = channelizer()
    for a, b in zip(got, [plain.process(x), plain.flush()]):
        assert [meta(e) for e in a.events] == [meta(e) for e in b.events]
        for u, v in zip(a.throughput + [e.data for e in a.events],
                        b.throughput + [e.data for e in b.events]):
            np.testing.assert_allclose(
                u, v, rtol=0, atol=2e-4 * np.abs(v).max(initial=1e-30))


# -- on the card -----------------------------------------------------------------

def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (page-locked memory and the "
                    "kernels exist only with the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_mirror_is_page_locked_on_the_card():
    dev = cuda_device()
    fdc = channelizer(dev)
    x, rows = stream_of(fdc, "process")
    tracing.enable()
    fdc.process(x[:rows])
    c = tracing.summary()["counters"]
    assert fdc._mirror.buffer.is_pinned()
    assert c["d2h_bytes"] == fdc._mirror._nbytes


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["process", "process_spectra"])
def test_three_calls_equal_a_fresh_copy_out_on_the_card(monkeypatch, entry):
    dev = cuda_device()
    fdc = channelizer(dev, debug=True)
    x, rows = stream_of(fdc, entry)
    bounds = [0, rows, 3 * rows, 4 * rows]
    got = feed(fdc, entry, x, bounds)
    fresh_copy_out(monkeypatch)
    want = feed(channelizer(dev, debug=True), entry, x, bounds)
    assert_bit_equal(got, want)
    for a, b in zip(got, want):
        assert_same_result(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("wait", [True, False])
def test_the_copy_out_waits_for_its_copies(wait):
    """A spin queued before the step; the mirror filled with a sentinel:
    with its wait, ``_to_host`` returns the step's outputs, bit for bit;
    without it (the mutation), what it returns is not."""
    dev = cuda_device()
    fdc = channelizer(dev)
    x, rows = stream_of(fdc, "process")
    fdc.process(x[:rows])  # captures the graph, makes the mirror
    mirror = fdc._mirror
    if not wait:
        mirror._done = {}  # no event recorded, none waited for
    mirror.buffer.fill_(0xFF)
    slot, _, _ = fdc._stage(np.zeros(0, np.complex64), x, rows, rows)
    torch.cuda._sleep(1 << 28)
    out = fdc._run_step(fdc._jit_step, slot)
    got = _to_host(out, mirror)
    got = [np.array(a) for a in leaves(got)]  # read before anything waits
    torch.cuda.synchronize()
    want = list(leaves(host(out)))
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    assert same == wait


def vcm_runner(device, batch=8):
    """The vcm runner on two detection segments, and spectra of noise with
    a carrier in each segment for a few batches of ``batch`` blocks."""
    adc = ActivityDetectionChannelizer(
        512, [[0.05, 0.45], [0.55, 0.95]], 8.0, 4, 0.02,
        window_flank_puffer=0.2, max_slots=8, device=device)
    rng = np.random.default_rng(5)
    spectra = 0.05 * (rng.standard_normal((4 * batch, 512))
                      + 1j * rng.standard_normal((4 * batch, 512)))
    spectra[batch // 2:2 * batch, 120:130] += 30.0
    spectra[batch:3 * batch, 380:392] += 20.0
    return adc.make_runner(maxblocks=5), spectra.astype(np.complex64)


@pytest.mark.cuda
def test_the_vcm_runners_slot_and_mirror_are_page_locked(monkeypatch):
    """On the card the vcm runner's staging slot and host mirror are
    page-locked, the slot reused, and its events those of a runner whose
    copy-out makes fresh copies, bit for bit."""
    dev = cuda_device()
    runner, spectra = vcm_runner(dev)
    got, slots = [], []
    for lo in range(0, len(spectra), 8):
        got += runner.process_spectra(spectra[lo:lo + 8])
        slots.append(runner._staging.tensor)
    assert all(s is slots[0] for s in slots) and slots[0].is_pinned()
    assert runner._mirror.buffer.is_pinned()
    fresh_copy_out(monkeypatch, admod)
    ref, _ = vcm_runner(dev)
    want = []
    for lo in range(0, len(spectra), 8):
        want += ref.process_spectra(spectra[lo:lo + 8])
    assert got and [meta(e) for e in got] == [meta(e) for e in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.data, b.data)
