"""The channelizer's input staging (``process`` / ``process_spectra``) on
the CPU.

Each whole batch is written into one reused staging slot, the buffered
remainder first, and handed to the compiled step; the remainder of less
than a batch is kept as memory of the channelizer's own. Here: a stream
fed in pieces of any length gives the results of the same stream fed in
whole batches, bit for bit; what the caller does with its array after a
call changes nothing; other dtypes and layouts are converted as before; a
checkpoint taken with a remainder resumes the same; every byte the step
copies in on a ``process()`` stream comes from the slot (counter
``h2d_staged_bytes``), none on the pipeline's path. On the card the slot
is page-locked and copied in without blocking (tests marked ``cuda``,
which import no JAX).
"""

import numpy as np
import pytest
import torch

from fdc_tpu_torch import FrequencyDomainChannelizer
from fdc_tpu_torch.flagship import _flagship
from fdc_tpu_torch.parallel import PipelineChannelizer
from fdc_tpu_torch.runtime import checkpoint as ckpt
from fdc_tpu_torch.runtime import tracing

from test_torch_tracing import SMALL, capture, meta, spectra_of

N_BATCHES = 4
TAIL = 300  # samples (process) or 3 rows (process_spectra) past the batches


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def channelizer(device="cpu"):
    return FrequencyDomainChannelizer(_flagship(**SMALL), device=device)


def stream_of(fdc, entry):
    """The entry point's input: ``N_BATCHES`` batches and a tail."""
    cfg = fdc.config
    if entry == "process":
        return capture(cfg, N_BATCHES + 1)[:N_BATCHES * fdc.batch_samples
                                           + TAIL]
    return spectra_of(cfg, N_BATCHES + 1)[:(N_BATCHES * cfg.batch_blocks
                                            + TAIL // 100)]


def batch_rows(fdc, entry):
    return (fdc.batch_samples if entry == "process"
            else fdc.config.batch_blocks)


def cuts(name, total, rows, seed=0):
    """Piece boundaries over ``total`` rows: ``exact`` whole batches (and
    the tail); ``short`` pieces under a batch; ``across`` 0.7 of a batch,
    each crossing a boundary in turn; ``several`` 2.5 batches a call;
    ``whole`` one call; ``random`` lengths 1 row to 3 batches."""
    rng = np.random.default_rng(seed)
    step = {"exact": rows, "across": max(1, 7 * rows // 10),
            "several": 5 * rows // 2, "whole": total}.get(name)
    if step is not None:
        return list(range(0, total, step)) + [total]
    hi = rows // 2 if name == "short" else 3 * rows
    out = [0]
    while out[-1] < total:
        out.append(min(total, out[-1] + int(rng.integers(1, hi + 1))))
    return out


def feed(fdc, entry, x, bounds):
    """The pieces of ``x`` between ``bounds`` through ``entry``, then the
    flush."""
    call = getattr(fdc, entry)
    return [call(x[a:b]) for a, b in zip(bounds, bounds[1:])] + [fdc.flush()]


def joined(results):
    """The stream the results make: throughput streams and segment powers
    joined, events' metadata (the wall-clock ID prefix dropped) and
    samples, blocks."""
    return {
        "throughput": [np.concatenate(c) for c in
                       zip(*(r.throughput for r in results))],
        "power": [np.concatenate(p) for p in
                  zip(*(r.segment_power for r in results))],
        "events": [meta(e) for r in results for e in r.events],
        "samples": [e.data for r in results for e in r.events],
        "blocks": sum(r.blocks_processed for r in results),
    }


def assert_bit_equal(got, ref):
    got, ref = joined(got), joined(ref)
    assert ref["events"], "the stream must carry events"
    assert got["events"] == ref["events"]
    assert got["blocks"] == ref["blocks"]
    for key in ("throughput", "power", "samples"):
        assert len(got[key]) == len(ref[key])
        for a, b in zip(got[key], ref[key]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def whole_batches():
    """Each entry point's stream fed in whole batches: the reference."""
    ref = {}
    for entry in ("process", "process_spectra"):
        fdc = channelizer()
        x = stream_of(fdc, entry)
        ref[entry] = feed(fdc, entry, x,
                          cuts("exact", len(x), batch_rows(fdc, entry)))
    return ref


@pytest.mark.parametrize("name", ["short", "across", "several", "whole",
                                  "random"])
@pytest.mark.parametrize("entry", ["process", "process_spectra"])
def test_pieces_equal_whole_batches(whole_batches, entry, name):
    fdc = channelizer()
    x = stream_of(fdc, entry)
    bounds = cuts(name, len(x), batch_rows(fdc, entry))
    assert_bit_equal(feed(fdc, entry, x, bounds), whole_batches[entry])


@pytest.mark.parametrize("entry", ["process", "process_spectra"])
def test_whole_batches_buffer_nothing_and_reuse_one_slot(entry):
    """Exact batches leave no remainder; every batch is written into the
    same slot, of the batch's shape, made once."""
    fdc = channelizer()
    x = stream_of(fdc, entry)
    rows = batch_rows(fdc, entry)
    slots = []
    for k in range(N_BATCHES):
        getattr(fdc, entry)(x[k * rows:(k + 1) * rows])
        pend = fdc._pending if entry == "process" else fdc._pending_spec
        assert len(pend) == 0
        slots.append(fdc._staging.tensor)
    assert all(s is slots[0] for s in slots)
    assert tuple(slots[0].shape) == (rows,) + x.shape[1:]
    assert not slots[0].is_pinned()  # plain host memory without a card


@pytest.mark.parametrize("entry", ["process", "process_spectra"])
def test_callers_array_overwritten_after_the_call(whole_batches, entry):
    """Pieces that leave a remainder each call, each piece's array
    overwritten once the call returns: the results are those of whole
    batches, and the buffered remainder is not the caller's memory."""
    fdc = channelizer()
    x = stream_of(fdc, entry)
    bounds = cuts("across", len(x), batch_rows(fdc, entry))
    call = getattr(fdc, entry)
    results = []
    for a, b in zip(bounds, bounds[1:]):
        piece = x[a:b].copy()
        results.append(call(piece))
        pend = fdc._pending if entry == "process" else fdc._pending_spec
        assert len(pend) and not np.shares_memory(pend, piece)
        piece[...] = 1e3 + 1e3j
    results.append(fdc.flush())
    assert_bit_equal(results, whole_batches[entry])


def complex128(x):
    return x.astype(np.complex128)


def read_only(x):
    x = x.copy()
    x.flags.writeable = False
    return x


def strided(x):
    """The same values every other element of a larger array."""
    wide = np.zeros((2 * len(x),) + x.shape[1:], x.dtype)
    wide[::2] = x
    return wide[::2]


@pytest.mark.parametrize("form", [complex128, read_only, strided])
@pytest.mark.parametrize("entry", ["process", "process_spectra"])
def test_other_dtypes_and_layouts_are_accepted(whole_batches, entry, form):
    """complex128 input (converted to complex64 as before), a read-only
    array and a strided view: the whole-batch results, bit for bit."""
    fdc = channelizer()
    x = stream_of(fdc, entry)
    bounds = cuts("across", len(x), batch_rows(fdc, entry))
    call = getattr(fdc, entry)
    results = [call(form(x[a:b])) for a, b in zip(bounds, bounds[1:])]
    assert_bit_equal(results + [fdc.flush()], whole_batches[entry])


def test_samples_must_be_one_dimensional():
    fdc = channelizer()
    with pytest.raises(ValueError, match="one-dimensional"):
        fdc.process(np.zeros((2, fdc.batch_samples), np.complex64))
    with pytest.raises(ValueError, match=r"spectra must be \[B, 1024\]"):
        channelizer().process_spectra(np.zeros((3, 512), np.complex64))


@pytest.mark.parametrize("entry", ["process", "process_spectra"])
def test_checkpoint_with_a_remainder_resumes_the_same(whole_batches, entry,
                                                     tmp_path):
    """A file saved with a remainder buffered, loaded into a new
    channelizer: the rest of the stream gives the uninterrupted results,
    bit for bit."""
    fdc = channelizer()
    x = stream_of(fdc, entry)
    rows = batch_rows(fdc, entry)
    cut = 2 * rows + 3 * rows // 8
    head = [getattr(fdc, entry)(x[:cut])]
    pend = fdc._pending if entry == "process" else fdc._pending_spec
    assert len(pend) == 3 * rows // 8
    path = str(tmp_path / "cut.ckpt")
    ckpt.save_checkpoint(fdc, path)
    resumed = channelizer()
    ckpt.load_checkpoint(resumed, path)
    tail = feed(resumed, entry, x, [cut, len(x)])
    assert_bit_equal(head + tail, whole_batches[entry])


@pytest.mark.parametrize("entry", ["process", "process_spectra"])
def test_every_byte_copied_in_is_staged(entry):
    """Per call, ``h2d_staged_bytes`` equals ``h2d_bytes``: the batch's
    bytes for each step the call ran, 0 for a call that only buffers; no
    fill waits on the CPU (no copy is in flight)."""
    fdc = channelizer()
    x = stream_of(fdc, entry)
    rows = batch_rows(fdc, entry)
    batch_bytes = rows * int(np.prod(x.shape[1:])) * 8
    bounds = cuts("random", len(x), rows, seed=3)
    tracing.enable()
    results = feed(fdc, entry, x, bounds)
    tracing.disable()
    assert sum(r.blocks_processed > 0 for r in results) >= N_BATCHES - 1
    for call, r in enumerate(results):
        c = tracing.summary(calls=[call])["counters"]
        steps = -(-r.blocks_processed // fdc.config.batch_blocks)
        assert c.get("h2d_staged_bytes", 0) == c.get("h2d_bytes", 0)
        assert c.get("h2d_bytes", 0) == steps * batch_bytes
        assert "stage_waits" not in c
    total = tracing.summary()["counters"]
    assert total["h2d_staged_bytes"] / total["h2d_bytes"] == 1.0


def test_the_pipeline_path_stages_nothing():
    """The pipeline keeps its own concatenation and copy-in: bytes copied
    in, none of them from a staging slot."""
    pipe = PipelineChannelizer(_flagship(**SMALL), devices=["cpu"] * 2)
    x = stream_of(pipe, "process")
    tracing.enable()
    feed(pipe, "process", x, cuts("across", len(x), pipe.batch_samples))
    c = tracing.summary()["counters"]
    assert c["h2d_bytes"] > 0
    assert c.get("h2d_staged_bytes", 0) == 0
    assert pipe._staging.tensor is None


# -- on the card -----------------------------------------------------------------

def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (page-locked memory and the "
                    "kernels exist only with the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_slot_is_page_locked_on_the_card():
    dev = cuda_device()
    fdc = channelizer(dev)
    x = stream_of(fdc, "process")
    tracing.enable()
    fdc.process(x[:fdc.batch_samples])
    c = tracing.summary()["counters"]
    slot = fdc._staging.tensor
    assert slot.is_pinned()
    assert c["h2d_staged_bytes"] == c["h2d_bytes"] == slot.nbytes


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["process", "process_spectra"])
def test_three_batches_in_one_call_equal_three_calls_on_the_card(entry):
    dev = cuda_device()
    one, three = channelizer(dev), channelizer(dev)
    x = stream_of(one, entry)
    rows = batch_rows(one, entry)
    x = x[:3 * rows]
    assert_bit_equal(feed(three, entry, x, [0, 3 * rows]),
                     feed(one, entry, x, cuts("exact", len(x), rows)))


def host(tree):
    """A step's outputs or carry (dicts and lists of tensors) as numpy
    arrays of their own."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [host(v) for v in tree]
    return tree.cpu().numpy().copy()


def leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


@pytest.mark.cuda
def test_a_fill_waits_for_the_slots_copy_in(monkeypatch):
    """Two steps driven without consuming in between, a spin queued on the
    stream before the first: the copy-in of batch 1 is still queued when
    batch 2 is written, so the fill waits for it (one ``stage_waits``),
    and batch 2's outputs and carry are those of a stream that waited
    for each step, bit for bit."""
    dev = cuda_device()
    ref, fdc = channelizer(dev), channelizer(dev)
    x = stream_of(fdc, "process")
    bs, bb = fdc.batch_samples, fdc.config.batch_blocks
    none = np.zeros(0, np.complex64)

    def step(ch, k):
        if ch._carry is None:
            ch._carry = ch._jit_init()
        slot, _, _ = ch._stage(none, x, k * bs, bs)
        out = ch._run_step(ch._jit_step, slot)
        ch._t0 += bb
        return out

    want = [host(step(ref, k)) for k in range(3)]
    host(step(fdc, 0))  # captures the graph; its copies waited
    # the counters record, but the compiled step's synchronisation under
    # tracing stays off, as in an untraced run
    monkeypatch.setattr(tracing, "enabled", lambda: False)
    tracing.enable()
    torch.cuda._sleep(1 << 28)
    step(fdc, 1)
    got = host(step(fdc, 2))
    assert tracing.summary()["counters"].get("stage_waits", 0) == 1
    for a, b in zip(leaves(got), leaves(want[2])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(leaves(host(fdc._carry)), leaves(host(ref._carry))):
        np.testing.assert_array_equal(a, b)
