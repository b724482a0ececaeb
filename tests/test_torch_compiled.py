"""The compiled step (``runtime.compiled.CompiledStep``) against fdc_tpu's
jitted one.

``process``, ``process_spectra`` and ``flush`` of the port's channelizer,
and the vcm runner's ``process_spectra``, run their step compiled: one
captured CUDA graph a batch shape on the card; on the CPU the same
static inputs, carry copy-back and reused output buffers around an eager
call, with the first call per shape checked for operations a capture
refuses. Here (CPU) they are held against ``fdc_tpu``'s ``jax.jit``
steps on the same inputs, made with numpy from a seed; tests marked
``cuda`` replay the graphs on the card.

Tolerances (ROADMAP "How a part is held"): flags, slot tables, plans and
counters exact; event metadata exact apart from the timestamped ID
prefix; streams and extractions rtol 2e-4 / atol 2e-5 of each tensor's
max; powers 1e-5 of each tensor's max; event samples as one stream. The
compiled and the eager port runs are bit-equal.
"""

import copy
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship as jax_flagship
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.runtime import checkpoint as jax_ckpt
from fdc_tpu_torch import (
    ActivityDetectionChannelizer,
    FrequencyDomainChannelizer,
)
from fdc_tpu_torch.flagship import _flagship, powact32, reference_example
from fdc_tpu_torch.models.throughput import ThroughputChannelizer
from fdc_tpu_torch.ops import detect, extract_fused, fft, lifecycle, powact
from fdc_tpu_torch.ops import probes
from fdc_tpu_torch.runtime import checkpoint as ckpt
from fdc_tpu_torch.runtime import compiled
from fdc_tpu_torch.runtime.compiled import CaptureError, CompiledStep

from golden import golden_forward_fft, golden_overlap_save
from test_torch_burst import capture as burst_capture
from test_torch_burst import jax_twin
from test_torch_checkpoint import assert_stream_matches, restart
from test_torch_slice import (
    ATOL,
    RTOL,
    assert_close_to_max,
    assert_events_match,
    assert_outputs_match,
    capture,
    jax_step,
    meta,
)
from test_torch_vcm import SCENES, make_spectra, runners

SMALL = dict(blocksize=1024, batch_blocks=8, n_channels=16)
BURST_SMALL = dict(blocksize=1024, batch_blocks=8)


def port_twin(jcfg, **kw):
    """The port's channelizer on the JAX configuration."""
    from fdc_tpu_torch import ChannelizerConfig

    return FrequencyDomainChannelizer(
        ChannelizerConfig.from_dict(jcfg.to_dict()).replace(**kw),
        device="cpu")


def run(fdc, x):
    return [fdc.process(x), fdc.flush()]


def events(results):
    return [e for r in results for e in r.events]


def assert_results_close(rt, rj):
    """process + flush of the port against fdc_tpu's: blocks, throughput
    streams, segment powers, events."""
    for a, b in zip(rt, rj):
        assert a.blocks_processed == b.blocks_processed
        assert len(a.throughput) == len(b.throughput)
        for ca, cb in zip(a.throughput, b.throughput):
            assert ca.shape == cb.shape
            assert_close_to_max(ca, cb, RTOL, ATOL, "throughput stream")
        for pa, pb in zip(a.segment_power, b.segment_power):
            assert pa.shape == pb.shape
            assert_close_to_max(pa, pb, 0.0, 1e-5, "segment power")
    ej, et = events(rj), events(rt)
    assert ej
    assert_events_match(et, ej)


def assert_results_equal(got, ref):
    """Bit-equal results (the compiled against the eager port run)."""
    assert [meta(e) for e in events(got)] == [meta(e) for e in events(ref)]
    for a, b in zip(events(got), events(ref)):
        np.testing.assert_array_equal(a.data, b.data)
    for a, b in zip(got, ref):
        assert a.blocks_processed == b.blocks_processed
        for ca, cb in zip(a.throughput + a.segment_power,
                          b.throughput + b.segment_power):
            np.testing.assert_array_equal(ca, cb)
        if b.debug_spectrum is not None:
            np.testing.assert_array_equal(a.debug_spectrum, b.debug_spectrum)


def eager(fdc):
    """``fdc`` with its step run eagerly (the opt-out, on the instance)."""
    fdc.compile_step = False
    return fdc


# -- the channelizer's compiled process + flush against fdc_tpu -------------

def flagship_case():
    jcfg = jax_flagship(**SMALL, native_emission=False)
    return jcfg, port_twin(jcfg), capture(port_twin(jcfg).config, 5, 1500)


def burst_case(make):
    def case():
        pcfg = make(**BURST_SMALL)
        jf = jax_twin(pcfg)
        return jf.config, FrequencyDomainChannelizer(pcfg, device="cpu"), \
            burst_capture(pcfg, n_batches=4, tail=700)
    return case


CASES = {"flagship": flagship_case,
         "example": burst_case(reference_example),
         "powact32": burst_case(powact32)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_compiled_process_flush_matches_jax(name):
    """The compiled process() + flush() against fdc_tpu's jitted ones; the
    stream's carry is the compiled step's static carry throughout, and the
    eager port run is bit-equal."""
    jcfg, tf, x = CASES[name]()
    jf = JaxFDC(jcfg)
    rj = run(jf, x)
    rt = run(tf, x)
    assert tf._jit_step.owns(tf._carry)
    assert len(tf._jit_step._entries) == 1  # one batch shape, one graph
    assert_results_close(rt, rj)
    assert_results_equal(rt, run(eager(FrequencyDomainChannelizer(
        tf.config, device="cpu")), x))


def test_batch_not_a_multiple_of_relinvovl(monkeypatch):
    """B = 6 at R = 4: t0 mod R takes 0 and 2, so the throughput phase
    comes from t0 in the step (``finish_bucket``), which the compiled step
    passes as a 0-d int32 tensor. Step outputs key by key against the
    jitted JAX step, then process + flush."""
    jcfg = jax_flagship(**{**SMALL, "batch_blocks": 6},
                        native_emission=False)
    jf, tf = JaxFDC(jcfg), port_twin(jcfg)
    cfg = tf.config
    assert cfg.batch_blocks % cfg.relinvovl
    x = capture(cfg, n_batches=5, tail=900)
    seen = []
    orig = ThroughputChannelizer.finish_bucket

    def finish(self, bucket, y, t0, prephased=False):
        seen.append(t0)
        return orig(self, bucket, y, t0, prephased)

    monkeypatch.setattr(ThroughputChannelizer, "finish_bucket", finish)
    bs = tf.batch_samples
    jc, tc = jf._jit_init(), tf._jit_init()
    for step in range(4):
        chunk = x[step * bs:(step + 1) * bs]
        t0 = step * cfg.batch_blocks
        jc, jo = jax_step(jf, jc, chunk, t0)
        tc, to = tf._jit_step(tc, torch.from_numpy(chunk), t0)
        assert_outputs_match(to, jax.tree.map(np.asarray, jo),
                             f"B=6 step {step} (t0 mod 4 = {t0 % 4})")
        assert_outputs_match(tc, jax.tree.map(np.asarray, jc),
                             f"B=6 carry after step {step}")
    assert seen and all(isinstance(t, torch.Tensor) and t.dim() == 0
                        and t.dtype == torch.int32 for t in seen)
    jf.reset()
    tf.reset()
    assert_results_close(run(tf, x), run(jf, x))


def test_compiled_process_spectra_matches_jax():
    """process_spectra on ragged row counts, then flush, through the
    compiled spectra step, against fdc_tpu's."""
    jcfg = jax_flagship(**SMALL, native_emission=False)
    jf, tf = JaxFDC(jcfg), port_twin(jcfg)
    x = capture(tf.config, n_batches=6, tail=0)
    blocks, _ = golden_overlap_save(x.astype(np.complex128), 1024,
                                    tf.config.ovllen)
    spectra = golden_forward_fft(blocks).astype(np.complex64)[:43]
    cuts = [0, 5, 16, 19, 40, 43]
    rj = [jf.process_spectra(spectra[a:b]) for a, b in zip(cuts, cuts[1:])]
    rt = [tf.process_spectra(spectra[a:b]) for a, b in zip(cuts, cuts[1:])]
    rj.append(jf.flush())
    rt.append(tf.flush())
    assert tf._jit_step_spectra.owns(tf._carry)
    assert not tf._jit_step._entries  # the samples step never ran
    assert_results_close(rt, rj)


# -- checkpoints and reset on a compiled stream -----------------------------

@pytest.fixture(scope="module")
def cut_stream(tmp_path_factory):
    """The small flagship cut mid-batch inside a burst: fdc_tpu's
    uninterrupted run, its file at the cut and the port's."""
    jcfg = jax_flagship(**SMALL, native_emission=False)
    jf, tf = JaxFDC(jcfg), port_twin(jcfg)
    x = capture(tf.config, n_batches=5, tail=1500)
    cut = 2 * tf.batch_samples + 777
    tmp = tmp_path_factory.mktemp("compiled_ckpt")
    restart(jf)  # records the emitters' state at construction
    ref = run(jf, x)
    restart(jf)
    head_j = jf.process(x[:cut])
    jax_ckpt.save_checkpoint(jf, str(tmp / "jax.ckpt"))
    head_t = tf.process(x[:cut])
    ckpt.save_checkpoint(tf, str(tmp / "port.ckpt"))
    return dict(jcfg=jcfg, x=x, cut=cut, ref=ref, head_j=head_j,
                head_t=head_t, files={"jax": tmp / "jax.ckpt",
                                      "port": tmp / "port.ckpt"})


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_checkpoint_into_a_compiled_stream(cut_stream, saved_by):
    """A channelizer whose step is compiled and holds a live stream (other
    samples) loads the file at the cut: the carry is written into the
    static carry the step reads, in place; the rest of the capture then
    gives fdc_tpu's uninterrupted events and streams."""
    s = cut_stream
    tf = port_twin(s["jcfg"])
    tf.process(capture(tf.config, 2, 300, seed=7))
    static = tf._carry
    assert tf._jit_step.owns(static)
    ckpt.load_checkpoint(tf, str(s["files"][saved_by]))
    assert tf._carry is static  # written through, not rebound
    head = s["head_j"] if saved_by == "jax" else s["head_t"]
    assert_stream_matches([head, tf.process(s["x"][s["cut"]:]), tf.flush()],
                          s["ref"])


def test_reset_and_a_second_stream():
    """reset() drops the graphs and the static carry; a second stream on
    the same object equals a fresh channelizer's run of it, bit for bit,
    and fdc_tpu's."""
    jcfg = jax_flagship(**SMALL, native_emission=False)
    tf = port_twin(jcfg)
    restart(tf)  # records the emitters' state at construction
    cfg = tf.config
    first, second = capture(cfg, 3, 500, seed=0), capture(cfg, 4, 900, seed=3)
    run(tf, first)
    restart(tf)
    assert tf._carry is None and not tf._jit_step._entries
    got = run(tf, second)
    assert_results_equal(got, run(port_twin(jcfg), second))
    assert_results_close(got, run(JaxFDC(jcfg), second))


def test_results_do_not_change_after_later_steps():
    """What process() returned stays as it was while later steps overwrite
    the compiled step's output buffers (debug spectra of several batches
    in one call included), and equals the eager run."""
    tf = FrequencyDomainChannelizer(_flagship(**SMALL, debug=True),
                                    device="cpu")
    x = capture(tf.config, 5, 1500)
    bs = tf.batch_samples
    r1 = tf.process(x[:2 * bs])
    kept = copy.deepcopy(r1)
    assert r1.events and r1.debug_spectrum.shape[0] == 16
    # the two batches' rows are not one buffer seen twice
    assert not np.array_equal(r1.debug_spectrum[:8], r1.debug_spectrum[8:])
    r2 = [tf.process(x[2 * bs:]), tf.flush()]
    assert_results_equal([r1], [kept])
    ref = eager(FrequencyDomainChannelizer(tf.config, device="cpu"))
    assert_results_equal([r1, *r2], [ref.process(x[:2 * bs]),
                                     ref.process(x[2 * bs:]), ref.flush()])


# -- the vcm runner ----------------------------------------------------------

def test_vcm_runner_two_batch_sizes():
    """The runner fed batches of 8 spectra and a tail of 5: one graph
    each, as jit traces one a shape; events against fdc_tpu's runner,
    bit-equal to the eager runner."""
    kw, maxblocks, (nb, carriers) = SCENES["two-segments"]
    spectra = make_spectra(nb, kw["blocklen"], kw["relinvovl"], carriers)
    jr, tr = runners(kw, maxblocks)
    assert nb == 48
    cuts = [0, 8, 16, 24, 32, 40, 43, 48]
    ej, et = [], []
    for a, b in zip(cuts, cuts[1:]):
        ej += jr.process_spectra(spectra[a:b])
        et += tr.process_spectra(spectra[a:b])
    assert sorted(k[0][0][0] for k in tr._jit_step._entries) == [3, 5, 8]
    assert tr._jit_step.owns(tr._carry)
    assert_events_match(et, ej)
    er = ActivityDetectionChannelizer(**kw, device="cpu").make_runner(
        maxblocks=maxblocks)
    er.compile_step = False
    ee = [e for a, b in zip(cuts, cuts[1:])
          for e in er.process_spectra(spectra[a:b])]
    assert [meta(e) for e in et] == [meta(e) for e in ee]
    for a, b in zip(et, ee):
        np.testing.assert_array_equal(a.data, b.data)
    assert tr.has_open_slots() == jr.has_open_slots()


def test_vcm_checkpoint_into_a_compiled_runner(tmp_path):
    """fdc_tpu's runner file loaded into a port runner whose step is
    compiled: written through its static carry; the rest of the spectra
    give fdc_tpu's events."""
    kw, maxblocks, (nb, carriers) = SCENES["golden"]
    spectra = make_spectra(nb, kw["blocklen"], kw["relinvovl"], carriers)
    jr, tr = runners(kw, maxblocks)
    for lo in range(0, 16, 8):
        jr.process_spectra(spectra[lo:lo + 8])
        tr.process_spectra(spectra[lo + 8:lo + 16])  # another stream
    jax_ckpt.save_vcm_checkpoint(jr, str(tmp_path / "vcm.ckpt"))
    static = tr._carry
    ckpt.load_vcm_checkpoint(tr, str(tmp_path / "vcm.ckpt"))
    assert tr._carry is static and tr._t0 == 16
    ej, et = [], []
    for lo in range(16, nb, 8):
        ej += jr.process_spectra(spectra[lo:lo + 8])
        et += tr.process_spectra(spectra[lo:lo + 8])
    assert ej
    assert_events_match(et, ej)


# -- launch accounting --------------------------------------------

WRAPPERS = ((extract_fused, "extract_shared"),
            (extract_fused, "extract_shared_fold"),
            (extract_fused, "extract_static"),
            (detect, "candidate_packs"), (detect, "greedy_accept_batch"),
            (lifecycle, "slot_lifecycle_multi"), (powact, "powact_flags"),
            (fft, "forward_spectrum_four_step"),
            (fft, "forward_spectrum_two_pass"),
            (fft, "forward_spectrum_cluster"), (probes, "tile_probe"))


def test_counted_wrappers_are_every_kernel_wrapper():
    """The compiled step's accounting covers every function of the ops
    modules that counts launches."""
    found = {(m.__name__, a) for m in (extract_fused, detect, lifecycle,
                                       powact, fft, probes)
             for a, v in vars(m).items() if hasattr(v, "launches")}
    assert found == {(m.__name__, a) for m, a in WRAPPERS}
    assert set(compiled.COUNTED) == found
    assert len(compiled.launch_counters()) == len(WRAPPERS)


@pytest.mark.parametrize("name", sorted(CASES))
def test_compiled_launch_counts_equal_eager(name, monkeypatch):
    """With every wrapper stubbed by a counter (the CPU path counts no
    launches), a compiled process() + flush() counts what the eager one
    does, and the path's kernels are among them."""
    def counter(fn):
        def counted(*a, **kw):
            counted.launches += 1
            return fn(*a, **kw)
        counted.launches = 0
        return counted

    for m, a in WRAPPERS:
        monkeypatch.setattr(m, a, counter(getattr(m, a)))
    _, tf, x = CASES[name]()
    counts = []
    for fdc in (tf, eager(FrequencyDomainChannelizer(tf.config,
                                                     device="cpu"))):
        for m, a in WRAPPERS:
            getattr(m, a).launches = 0
        run(fdc, x)
        counts.append({a: getattr(m, a).launches for m, a in WRAPPERS})
    assert counts[0] == counts[1]
    assert counts[0]["forward_spectrum_four_step"] > 0


# -- the compiled step itself --------------------------------------------------

def swap_step(carry, x, t0):
    """A carry whose new leaves are the old ones swapped, an output that
    is an old carry leaf and one made from the input and t0."""
    return ({"a": carry["b"], "b": carry["a"] + x.sum()},
            {"old_a": carry["a"], "y": x * t0.to(x.dtype)})


def test_copy_back_reads_before_it_writes():
    """New carry leaves that are the static leaves themselves, swapped,
    and an output that is one of them: the copy-back clones what it would
    overwrite before reading, and the outputs keep their values."""
    step = CompiledStep(swap_step, "cpu")
    carry = {"a": torch.tensor([1.0]), "b": torch.tensor([2.0])}
    outs = []
    for t0 in range(3):
        x = torch.full((2,), float(t0 + 1))
        carry, out = step(carry, x, t0)
        outs.append(copy.deepcopy(out))
    ref = {"a": torch.tensor([1.0]), "b": torch.tensor([2.0])}
    for t0 in range(3):
        x = torch.full((2,), float(t0 + 1))
        ref_new, ref_out = swap_step(ref, x, torch.tensor(t0, dtype=torch.int32))
        for k in ("old_a", "y"):
            torch.testing.assert_close(outs[t0][k], ref_out[k])
        ref = ref_new
    for k in ref:
        torch.testing.assert_close(carry[k], ref[k])
    assert carry is step._carry and out is carry_outputs(step)


def carry_outputs(step):
    (entry,) = step._entries.values()
    return entry.out


def test_outputs_are_reused_buffers_and_foreign_carries_are_copied_in():
    """Every call returns the same output tensors; a carry the step does
    not own is copied into the static one, which keeps its storage."""
    step = CompiledStep(swap_step, "cpu")
    c0 = {"a": torch.tensor([1.0]), "b": torch.tensor([2.0])}
    carry, out1 = step(c0, torch.ones(2), 0)
    ptr = carry["a"].data_ptr()
    assert carry is not c0 and carry["a"].data_ptr() != c0["a"].data_ptr()
    carry, out2 = step({"a": torch.tensor([5.0]), "b": torch.tensor([6.0])},
                       torch.ones(2), 1)
    assert out2 is out1 and carry["a"].data_ptr() == ptr
    torch.testing.assert_close(out2["old_a"], torch.tensor([5.0]))
    with pytest.raises(ValueError):
        step({"a": torch.tensor([1.0])}, torch.ones(2), 2)


@pytest.mark.parametrize("body", ["item", "mask", "nonzero", "bool"])
def test_capture_refusals_raise_on_the_cpu(body):
    """A step that reads a device value on the host or sizes an output by
    the data refuses capture on the card; its first CPU call raises the
    same error, with no eager fallback."""
    def step(carry, x, t0):
        if body == "item":
            y = x * x.sum().item()
        elif body == "mask":
            y = x[x > 0]
        elif body == "nonzero":
            y = torch.nonzero(x)
        else:
            y = x if bool(x.any()) else -x
        return dict(carry), {"y": y}

    s = CompiledStep(step, "cpu")
    with pytest.raises(CaptureError):
        s({"a": torch.zeros(1)}, torch.ones(4), 0)
    assert not s._entries


def test_plain_versions_are_exempt_from_the_guard():
    """A kernel's plain version (a ``*_plain`` function of the ops
    modules) runs as one launch on the card: the guard lets it read
    values on the host. The flagship's whole step passed it above; here
    kernel C's plain version, a host loop, on its own."""
    assert compiled._in_plain_version.__doc__
    tf = FrequencyDomainChannelizer(_flagship(**SMALL), device="cpu")
    x = capture(tf.config, 1, 0)
    with compiled._CaptureGuard():
        tf._device_step(tf._device_init(), torch.from_numpy(x), 0)
    with pytest.raises(CaptureError):
        with compiled._CaptureGuard():
            torch.ones(3).sum().item()


# -- on the card -----------------------------------------------------------------

def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graph capture and the kernels "
                    "run only on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("enabled", [True, False])
def test_collector_paused_restores_its_state(enabled):
    """The capture's pause of the garbage collector holds it off inside
    the block and leaves it as it found it, on an error too."""
    was = gc.isenabled()
    try:
        (gc.enable if enabled else gc.disable)()
        with pytest.raises(KeyError):
            with compiled._collector_paused():
                assert not gc.isenabled()
                raise KeyError
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()


@pytest.mark.cuda
def test_capture_holds_while_a_dropped_graph_is_garbage():
    """A graph freed inside another's capture invalidates that capture: a
    step that makes a captured graph unreachable, young and due for
    collection while the step is captured still captures (the collector
    is paused across it), and the garbage goes after."""
    dev = cuda_device()

    class Cycle:
        pass

    thresholds = gc.get_threshold()
    gc.set_threshold(1 << 30)   # no collection: the orphan stays young
    try:
        orphan = Cycle()
        orphan.me = orphan
        orphan.step = CompiledStep(lambda c, x: (c, {"y": x + 1}), dev,
                                   takes_t0=False)
        orphan.step({"a": torch.zeros(1, device=dev)},
                    torch.ones(4, device=dev))
        gone = weakref.ref(orphan)
        pending = [orphan]
        del orphan

        def step(carry, x):
            if torch.cuda.is_current_stream_capturing():
                pending.clear()      # the cycle is garbage from here on
                gc.set_threshold(1)  # and the next allocation collects it
                _ = [{} for _ in range(256)]
            return {"a": carry["a"] + x.sum()}, {"y": x * 2}

        s = CompiledStep(step, dev, takes_t0=False)
        carry = {"a": torch.zeros((), device=dev)}
        for _ in range(2):
            carry, out = s(carry, torch.ones(4, device=dev))
        torch.cuda.synchronize()
    finally:
        gc.set_threshold(*thresholds)
    gc.collect()
    assert float(carry["a"]) == 8.0
    assert out["y"].tolist() == [2.0] * 4
    assert gone() is None


@pytest.mark.cuda
def test_capture_refusal_raises_on_the_card():
    dev = cuda_device()

    def step(carry, x, t0):
        return dict(carry), {"y": x * x.sum().item()}

    s = CompiledStep(step, dev)
    with pytest.raises(CaptureError):
        s({"a": torch.zeros(1, device=dev)}, torch.ones(4), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_graphed_process_flush_equals_eager_on_the_card(name):
    """The replayed graph's process() + flush() against the eager step's
    on the card: bit-equal results, equal launch counts; then a second
    stream after reset() (the graphs dropped, captured again)."""
    dev = cuda_device()
    _, tf, x = CASES[name]()
    fdcs = (FrequencyDomainChannelizer(tf.config, device=dev),
            eager(FrequencyDomainChannelizer(tf.config, device=dev)))
    for fdc in fdcs:
        restart(fdc)
    for _ in range(2):
        counts, results = [], []
        for fdc in fdcs:
            restart(fdc)
            fns = compiled.launch_counters()
            for fn in fns:
                fn.launches = 0
            results.append(run(fdc, x))
            torch.cuda.synchronize()
            counts.append({fn.__name__: fn.launches for fn in fns})
        assert counts[0] == counts[1]
        assert counts[0]["forward_spectrum_four_step"]
        assert_results_equal(*results)
