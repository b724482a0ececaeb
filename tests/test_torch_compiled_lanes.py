"""The compiled multi-lane steps against fdc_tpu's jitted ones.

``ShardedChannelizer`` captures its whole step over the ranks' streams
(``_jit_step``, ``_jit_step_spectra``); ``PipelineChannelizer`` and the
hostpipe ends run their stages as rings of compiled steps (``_jit_front``,
``_jit_front_spec``, ``_jit_scan``, ``_jit_slots``). On the CPU each
compiled call runs the step eagerly through the same static inputs,
carry copy-back and reused output buffers, its first call per shape under
the capture guard, so a ring too shallow for the pipeline's window, or a
stage that would refuse capture, fails here. The runs are held against
``fdc_tpu``'s sharded channelizer and pipeline on the same inputs, made
with numpy from a seed, and against the class's eager opt-out
(``compile_step`` on the instance), bit for bit.

Tolerances (ROADMAP "How a part is held"): flags, slot tables, plans and
counters exact; event metadata exact apart from the timestamped ID
prefix; streams within rtol 2e-4 / atol 2e-5 of the max; powers within
1e-5 of the max; event samples as one stream.
"""

import types

import jax
import numpy as np
import pytest
import torch
from torch.utils import _python_dispatch

from __graft_entry__ import _flagship as jax_flagship
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fdc_tpu.parallel.pipeline import PipelineChannelizer as JaxPipe
from fdc_tpu.parallel.sharded import ShardedChannelizer as JaxSharded
from fdc_tpu.runtime import checkpoint as jax_ckpt
from fdc_tpu_torch import (
    ChannelizerConfig,
    FrequencyDomainChannelizer,
    HostPipelineOwner,
    HostPipelineWorker,
    PipelineChannelizer,
    ShardedChannelizer,
)
from fdc_tpu_torch.parallel import make_mesh
from fdc_tpu_torch.parallel.lanes import Lanes
from fdc_tpu_torch.runtime import checkpoint as ckpt
from fdc_tpu_torch.runtime import compiled
from fdc_tpu_torch.runtime.compiled import CaptureError, CompiledStep

from golden import golden_forward_fft, golden_overlap_save
from test_torch_compiled import (
    SMALL,
    WRAPPERS,
    assert_results_close,
    assert_results_equal,
    eager,
    events,
    run,
)
from test_torch_pipeline import configs, signal
from test_torch_slice import capture


def cpu(n):
    return ["cpu"] * n


def case(name):
    """(fdc_tpu's config, the port's, a capture of four batches and a
    ragged tail): the small flagship (one segment, 16 throughput
    channels), or tests/test_parallel.py's config with its segment split
    in three, a carrier on the first cut."""
    if name == "flagship":
        jcfg = jax_flagship(**SMALL, native_emission=False)
        pcfg = ChannelizerConfig.from_dict(jcfg.to_dict())
        return jcfg, pcfg, capture(pcfg, 4, 700)
    jcfg, pcfg = configs(segment_splits=((0, 3, 2),))
    x = signal(pcfg, 4, 9, carriers=((-0.415, 0.3, 0.7),))
    return jcfg, pcfg, x[:len(x) - pcfg.inplen - 100]


def sharded(pcfg, t, c):
    return ShardedChannelizer(pcfg, mesh=make_mesh(t, c, cpu(t * c)))


def jax_sharded(jcfg, t, c):
    return JaxSharded(jcfg, mesh=jax_make_mesh(n_time=t, n_chan=c))


def _joined(results):
    """A run's results as one (blocks, streams, powers, events)."""
    out = types.SimpleNamespace(
        blocks_processed=sum(r.blocks_processed for r in results),
        throughput=[np.concatenate([r.throughput[i] for r in results])
                    for i in range(len(results[0].throughput))],
        segment_power=[np.concatenate([r.segment_power[i] for r in results])
                       for i in range(len(results[0].segment_power))],
        events=events(results))
    return out


# -- the pipeline's stages as rings of compiled steps ------------------------

PIPES = {
    "1 lane, window 2": ("flagship", dict(n=1, window=2)),
    "3 lanes, dedicated owner, 2 scan owners": (
        "split", dict(n=3, dedicated_owner=True, scan_owners=2)),
    "4 lanes, shard_time 2": ("flagship", dict(n=4, shard_time=2)),
}


def pipes(pcfg, jcfg, n, **kw):
    return (PipelineChannelizer(pcfg, devices=cpu(n), **kw),
            JaxPipe(jcfg, devices=jax.devices()[:n], **kw))


def ring_entries(pipe):
    """Each compiled stage step's graph entries, by stage."""
    rings = {"front": pipe._jit_front, "front_spec": pipe._jit_front_spec,
             "slots": pipe._jit_slots}
    out = {k: [len(s._entries) for ring in v.values() for s in ring]
           for k, v in rings.items()}
    out["scan"] = [len(s._entries) for s in pipe._jit_scan]
    return out


@pytest.mark.parametrize("what", sorted(PIPES))
def test_compiled_pipeline_matches_jax(what):
    """process() + flush() through the compiled stages against fdc_tpu's
    pipeline of the same topology, and the eager opt-out's run bit for
    bit. Every slot of the rings a batch reaches holds one graph: a
    lane's ring has ceil(window / groups) slots, stage B's window; the
    stream's carry is stage B's static carry."""
    name, kw = PIPES[what]
    jcfg, pcfg, x = case(name)
    n = kw.pop("n")
    pipe, ref = pipes(pcfg, jcfg, n, **kw)
    got = run(pipe, x)
    assert_results_close(got, run(ref, x))
    assert_results_equal(got, run(eager(PipelineChannelizer(
        pcfg, devices=cpu(n), **kw)), x))
    assert pipe._jit_scan[0].owns(pipe._carry)
    depth = -(-pipe.window // len(pipe.groups))
    entries = ring_entries(pipe)
    n_batches = pipe._t0 // pcfg.batch_blocks
    assert len(pipe._jit_scan) == pipe.window
    assert entries["scan"] == [1] * min(n_batches, pipe.window) + [0] * (
        pipe.window - min(n_batches, pipe.window))
    per_lane = n_batches // len(pipe.groups)
    for ring in pipe._jit_front.values():
        assert len(ring) == depth
        assert sum(len(s._entries) for s in ring) == min(per_lane, depth)
    assert entries["slots"] == entries["front"]
    assert not any(entries["front_spec"])


def test_compiled_pipeline_process_spectra_matches_jax():
    """Vector mode through the compiled stage A of spectra on three lanes
    with a dedicated owner, against fdc_tpu's pipeline."""
    jcfg, pcfg, x = case("flagship")
    blocks, _ = golden_overlap_save(x.astype(np.complex128), 1024,
                                    pcfg.ovllen)
    spectra = golden_forward_fft(blocks).astype(np.complex64)[:35]
    pipe, ref = pipes(pcfg, jcfg, 3, dedicated_owner=True)
    results = []
    for m in (pipe, ref):
        results.append([m.process_spectra(spectra[:13]),
                        m.process_spectra(spectra[13:]), m.flush()])
    assert_results_close(*results)
    assert any(ring_entries(pipe)["front_spec"])
    assert not any(ring_entries(pipe)["front"])


def dispatch_three(pipe, x):
    """Three batches dispatched on one lane: their in-flight entries."""
    cfg = pipe.config
    bs = pipe.batch_samples
    pipe._samples_mode = True
    pipe._adopt_carry()
    inflight = []
    for b in range(3):
        inflight.append(pipe._dispatch(
            [0], pipe._sample_runs(1, x[b * bs:(b + 1) * bs]), pipe._t0))
        pipe._t0 += cfg.batch_blocks
    return inflight


def consumed(pipe, entry):
    res = pipe._new_result()
    pipe._consume_pipeline_batch(entry, res, [])
    return res


def test_batch_read_after_two_more_dispatches(monkeypatch):
    """A batch consumed after two more batches were dispatched (window 3)
    equals its eager run: the rings keep its outputs. With one slot a
    ring the first batch's outputs are the third's buffers."""
    _, pcfg, x = case("flagship")
    def first_stream(entry):
        return entry[0]["throughput_buckets"][0]

    ref_pipe = eager(PipelineChannelizer(pcfg, devices=cpu(1), window=3))
    ref_inflight = dispatch_three(ref_pipe, x)
    ref_first = first_stream(ref_inflight[0]).numpy().copy()
    ref = consumed(ref_pipe, ref_inflight[0])
    pipe = PipelineChannelizer(pcfg, devices=cpu(1), window=3)
    assert len(pipe._jit_front[0]) == len(pipe._jit_scan) == 3
    got = consumed(pipe, dispatch_three(pipe, x)[0])
    assert ref.events and ref.blocks_processed == pcfg.batch_blocks
    assert_results_equal([got], [ref])
    monkeypatch.setattr(PipelineChannelizer, "_ring_depths",
                        lambda self: (1, 1))
    inflight = dispatch_three(PipelineChannelizer(
        pcfg, devices=cpu(1), window=3), x)
    assert first_stream(inflight[0]) is first_stream(inflight[2])
    assert not np.array_equal(first_stream(inflight[0]).numpy(), ref_first)


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_plain_checkpoint_resumes_in_compiled_pipeline(saved_by, tmp_path):
    """A plain channelizer's file (no pipeline tail) loaded into a compiled
    pipeline that holds a live stream: the carry is written through stage
    B's static carry and the first batch takes the carried reach-back
    row through ``ov_flag`` (a device input, one graph for resumed and
    fresh batches); the rest equals fdc_tpu's uninterrupted run."""
    jcfg, pcfg, x = case("flagship")
    cut = 2 * pcfg.batch_blocks * pcfg.inplen + 777
    path = str(tmp_path / "plain.ckpt")
    if saved_by == "jax":
        jf = JaxFDC(jcfg)
        head = jf.process(x[:cut])
        jax_ckpt.save_checkpoint(jf, path)
    else:
        pf = FrequencyDomainChannelizer(pcfg, device="cpu")
        head = pf.process(x[:cut])
        ckpt.save_checkpoint(pf, path)
    pipe = PipelineChannelizer(pcfg, devices=cpu(2))
    pipe.process(capture(pcfg, 2, 300, seed=7))  # another stream
    static = pipe._carry
    assert pipe._jit_scan[0].owns(static)
    ckpt.load_checkpoint(pipe, path)
    assert pipe._carry is static and pipe._ov_flag
    got = [head, pipe.process(x[cut:]), pipe.flush()]
    assert not pipe._ov_flag
    assert_results_close([_joined(got)], [_joined(run(JaxFDC(jcfg), x))])


def test_compiled_pipeline_checkpoint_resumes_in_plain(tmp_path):
    """A compiled pipeline's file: its host tail synced into the static
    carry; fdc_tpu's plain channelizer resumes it."""
    jcfg, pcfg, x = case("flagship")
    cut = 3 * pcfg.batch_blocks * pcfg.inplen + 5 * pcfg.inplen + 17
    pipe = PipelineChannelizer(pcfg, devices=cpu(3), dedicated_owner=True)
    head = pipe.process(x[:cut])
    static = pipe._carry
    ckpt.save_checkpoint(pipe, str(tmp_path / "pipe.ckpt"))
    assert pipe._carry is static
    jf = JaxFDC(jcfg)
    jax_ckpt.load_checkpoint(jf, str(tmp_path / "pipe.ckpt"))
    got = [head, jf.process(x[cut:]), jf.flush()]
    assert_results_close([_joined(got)], [_joined(run(JaxFDC(jcfg), x))])


# -- launch accounting, the capture guard, the card check --------------------

def counted_wrappers(monkeypatch):
    def counter(fn):
        def counted(*a, **kw):
            counted.launches += 1
            return fn(*a, **kw)
        counted.launches = 0
        return counted

    for m, a in WRAPPERS:
        monkeypatch.setattr(m, a, counter(getattr(m, a)))


def make_lanes(kind, pcfg):
    if kind == "sharded 2x2":
        return sharded(pcfg, 2, 2)
    if kind == "pipeline, 2 scan owners":
        return PipelineChannelizer(pcfg, devices=cpu(3),
                                   dedicated_owner=True, scan_owners=2)
    return PipelineChannelizer(pcfg, devices=cpu(4), shard_time=2)


LANE_KINDS = ["sharded 2x2", "pipeline, 2 scan owners",
              "pipeline, shard_time 2"]


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_compiled_lanes_launch_counts_equal_eager(kind, monkeypatch):
    """With every wrapper stubbed by a counter (the CPU path counts no
    launches), the compiled run counts what the eager opt-out does, and
    the path's kernels are among them."""
    counted_wrappers(monkeypatch)
    _, pcfg, x = case("split")
    counts = []
    for fdc in (make_lanes(kind, pcfg), eager(make_lanes(kind, pcfg))):
        for m, a in WRAPPERS:
            getattr(m, a).launches = 0
        run(fdc, x)
        counts.append({a: getattr(m, a).launches for m, a in WRAPPERS})
    assert counts[0] == counts[1]
    assert counts[0]["forward_spectrum_four_step"] > 0
    assert counts[0]["slot_lifecycle_multi"] > 0


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_capture_guard_sees_each_stages_first_call(kind, monkeypatch):
    """Every compiled step's first call a shape (and slot) runs under the
    capture guard, its later calls without it; the sharded step is one
    step, the pipeline's stages A, B and C each a step of a ring."""
    seen = []
    body = CompiledStep._body

    def watched(self, entry, fresh):
        mode = _python_dispatch._get_current_dispatch_mode()
        seen.append((self.fn.__name__, id(self), fresh,
                     isinstance(mode, compiled._CaptureGuard)))
        return body(self, entry, fresh)

    monkeypatch.setattr(CompiledStep, "_body", watched)
    _, pcfg, x = case("split")
    fdc = make_lanes(kind, pcfg)
    run(fdc, x)
    assert all(fresh == guarded for _, _, fresh, guarded in seen)
    names = {n for n, _, fresh, _ in seen if fresh}
    firsts = [(n, i) for n, i, fresh, _ in seen if fresh]
    assert len(firsts) == len(set(firsts))  # one first call a step
    if kind.startswith("sharded"):
        assert names == {"_step_samples"}
    else:
        assert names == {"_stage_front", "_stage_scan", "_stage_slots"}
    assert any(not fresh for _, _, fresh, _ in seen)


@pytest.mark.parametrize("kind", ["sharded", "pipeline"])
def test_a_stage_that_refuses_capture_raises(kind, monkeypatch):
    """A host read of a device value inside a compiled step raises
    CaptureError from process(); there is no eager fallback."""
    _, pcfg, x = case("flagship")
    if kind == "sharded":
        orig = ShardedChannelizer._detection_stats

        def stats(self, ranks):  # a generator, as the step's parts are
            out = yield from orig(self, ranks)
            float(out[1][0].sum())  # a host read
            return out
        monkeypatch.setattr(ShardedChannelizer, "_detection_stats", stats)
        fdc = sharded(pcfg, 2, 1)
    else:
        orig = PipelineChannelizer._stage_slots

        def slots(self, *a):
            none, out = orig(self, *a)
            bool(out[0]["extract"].abs().max() > 0)  # a host read
            return none, out
        monkeypatch.setattr(PipelineChannelizer, "_stage_slots", slots)
        fdc = PipelineChannelizer(pcfg, devices=cpu(2))
    with pytest.raises(CaptureError):
        fdc.process(x)


def test_class_and_instance_opt_out():
    """Every multi-device class runs compiled by default; the eager run is
    an opt-out a caller sets, on the class or on the instance."""
    for cls in (ShardedChannelizer, PipelineChannelizer, HostPipelineOwner,
                HostPipelineWorker):
        assert cls.compile_step is True, cls
    _, pcfg, x = case("flagship")
    pipe = PipelineChannelizer(pcfg, devices=cpu(1))
    pipe.compile_step = False
    pipe.process(x[:pipe.batch_samples])
    assert not any(len(s._entries) for s in pipe._stage_steps())


def test_one_graph_holds_one_cards_lanes():
    """A graph holds the streams of one card: a compiled step over lanes
    of two CUDA devices raises CaptureError naming the opt-out; CPU
    lanes and one card's do not, and the opt-out runs eagerly."""
    lanes = types.SimpleNamespace(compile_step=True, devices=[
        torch.device("cuda", 0), torch.device("cuda", 1)])
    with pytest.raises(CaptureError, match="compile_step"):
        Lanes._graphed(lanes)
    assert Lanes._graphed(lanes, [0])
    lanes.devices = [torch.device("cuda", 0)] * 2 + [torch.device("cpu")]
    assert Lanes._graphed(lanes)
    lanes.compile_step = False
    lanes.devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert not Lanes._graphed(lanes)
