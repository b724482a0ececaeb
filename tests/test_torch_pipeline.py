"""The port's MPMD batch pipeline against ``fdc_tpu``'s.

``fdc_tpu_torch.parallel.PipelineChannelizer`` runs on ``["cpu"] * n``
lanes (the kernels' plain versions), ``fdc_tpu``'s on the forced
8-device CPU mesh, over the small config and signal of
``tests/test_parallel.py``; both are also held against the plain
channelizers. ``shard_time`` groups run against ``fdc_tpu``'s composed pipeline.
Tolerances (ROADMAP's): event metadata exact, event
samples (as one stream) and throughput streams within rtol 2e-4 / atol
2e-5 of the max, segment powers within 1e-5 of the max. The pipeline's
reach-back row is a [1, N] transform where the plain step carries row B
of a [B, N] one, which the CPU's four-step products may round otherwise:
against the port's own plain channelizer the events are exact and the
streams within the same tolerance. Counterparts: tests/test_pipeline.py.
"""

import jax
import numpy as np
import pytest
import torch

from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.parallel.pipeline import PipelineChannelizer as JaxPipe
from fdc_tpu.runtime import checkpoint as jax_ckpt
from fdc_tpu_torch import ChannelizerConfig, FrequencyDomainChannelizer
from fdc_tpu_torch.parallel import PipelineChannelizer
from fdc_tpu_torch.runtime import checkpoint as ckpt

from test_parallel import config as jax_config
from test_parallel import make_signal
from test_torch_slice import (
    ATOL,
    PRTOL,
    RTOL,
    assert_close_to_max,
    assert_events_match,
)

MULTI_SEG = [(-0.47, -0.3), (-0.28, -0.12), (0.03, 0.2)]


def configs(**kw):
    """(fdc_tpu's config, the port's) of tests/test_parallel.py."""
    jcfg = jax_config(**kw)
    return jcfg, ChannelizerConfig.from_dict(jcfg.to_dict())


def cpu(n):
    return ["cpu"] * n


def stream(model, x, chunk, flush=True):
    """(events, throughput streams, segment powers) of the capture fed in
    ``chunk``-sample pieces, then flushed."""
    results = [model.process(x[lo:lo + chunk])
               for lo in range(0, len(x), chunk)]
    if flush:
        results.append(model.flush())
    events = [e for r in results for e in r.events]
    tp = [np.concatenate([r.throughput[i] for r in results])
          for i in range(len(results[0].throughput))]
    pw = [np.concatenate([r.segment_power[i] for r in results])
          for i in range(len(results[0].segment_power))]
    return events, tp, pw


def assert_streams_match(got, ref):
    ev, tp, pw = got
    ev_ref, tp_ref, pw_ref = ref
    assert ev_ref, "the signal must trigger burst and detection events"
    assert_events_match(ev, ev_ref)
    for i, (a, b) in enumerate(zip(tp, tp_ref)):
        assert a.shape == b.shape
        assert_close_to_max(a, b, RTOL, ATOL, f"throughput {i}")
    for i, (a, b) in enumerate(zip(pw, pw_ref)):
        assert a.shape == b.shape
        assert_close_to_max(a, b, 0.0, PRTOL, f"segment power {i}")


def signal(cfg, n_batches, seed, carriers=()):
    """tests/test_parallel.py's signal, plus gated ``carriers`` ((freq,
    first sample fraction, last sample fraction)) so more segments
    detect."""
    n = n_batches * cfg.batch_blocks * cfg.inplen
    x = make_signal(np.random.default_rng(seed), n)
    t = np.arange(n)
    for f, lo, hi in carriers:
        m = np.zeros(n)
        m[int(lo * n):int(hi * n)] = 1.0
        x = (x + 2.5 * m * np.exp(2j * np.pi * f * t)).astype(np.complex64)
    return x


@pytest.mark.parametrize("n", [1, 3])
def test_pipeline_matches_fdc_tpu_and_plain(n):
    jcfg, pcfg = configs()
    x = signal(pcfg, 6, 7)
    chunk = 2 * pcfg.batch_blocks * pcfg.inplen
    got = stream(PipelineChannelizer(pcfg, devices=cpu(n)), x, chunk)
    assert_streams_match(got, stream(JaxPipe(jcfg,
                                             devices=jax.devices()[:n]),
                                     x, chunk))
    plain = stream(FrequencyDomainChannelizer(pcfg, device="cpu"), x,
                   chunk)
    assert_streams_match(got, plain)


def test_pipeline_chunking_invariance():
    """Ragged process() chunks do not change the outputs (host buffering
    and the framing tail across calls)."""
    _, pcfg = configs()
    x = signal(pcfg, 5, 11)
    a = stream(PipelineChannelizer(pcfg, devices=cpu(3)), x, len(x))
    b = stream(PipelineChannelizer(pcfg, devices=cpu(3)), x, 3000)
    ev_a, tp_a, pw_a = a
    ev_b, tp_b, pw_b = b
    assert_events_match(ev_b, ev_a)
    for s_a, s_b in zip(tp_a + pw_a, tp_b + pw_b):
        np.testing.assert_array_equal(s_a, s_b)


def test_pipeline_flush_finalizes():
    """flush() finalizes open bursts as the plain path does (the base
    flush drives the pipelined process)."""
    jcfg, pcfg = configs()
    n = 4 * pcfg.batch_blocks * pcfg.inplen
    t = np.arange(n)
    rng = np.random.default_rng(3)
    x = (2.5 * np.exp(2j * np.pi * (-0.4) * t)  # an always-on carrier
         + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    pipe = PipelineChannelizer(pcfg, devices=cpu(3))
    ev = pipe.process(x).events + pipe.flush().events
    ref = JaxPipe(jcfg, devices=jax.devices()[:3])
    ev_ref = ref.process(x).events + ref.flush().events
    assert any(e.finalized for e in ev_ref)
    assert_events_match(ev, ev_ref)
    plain = FrequencyDomainChannelizer(pcfg, device="cpu")
    assert_events_match(ev, plain.process(x).events + plain.flush().events)


def test_pipeline_debug_spectrum():
    jcfg, pcfg = configs(debug=True)
    x = signal(pcfg, 2, 5)
    got = PipelineChannelizer(pcfg, devices=cpu(4)).process(x)
    ref = JaxFDC(jcfg).process(x)
    assert got.debug_spectrum.shape == ref.debug_spectrum.shape
    assert_close_to_max(got.debug_spectrum, ref.debug_spectrum, RTOL, ATOL,
                        "debug spectrum")


def test_pipeline_dedicated_owner_matches():
    """dedicated_owner=True reserves lane 0 for the scans: the same
    outputs, only the batch placement differs."""
    jcfg, pcfg = configs()
    x = signal(pcfg, 4, 13)
    pipe = PipelineChannelizer(pcfg, devices=cpu(4), dedicated_owner=True)
    assert pipe.worker_lanes == [1, 2, 3] and pipe.window == 6
    chunk = 2 * pcfg.batch_blocks * pcfg.inplen
    ref = JaxPipe(jcfg, devices=jax.devices()[:4], dedicated_owner=True)
    assert len(ref.workers) == len(pipe.workers)
    assert_streams_match(stream(pipe, x, chunk), stream(ref, x, chunk))


@pytest.mark.parametrize("n", [1, 3])
def test_pipeline_process_spectra_matches(n):
    """Vector mode: the host prepends the previous batch's last row;
    ragged row chunks exercise the row buffering."""
    jcfg, pcfg = configs()
    x = signal(pcfg, 5, 17)
    spec = FrequencyDomainChannelizer(
        pcfg.replace(debug=True), device="cpu").process(x).debug_spectrum

    def feed(model):
        results = [model.process_spectra(spec[lo:hi])
                   for lo, hi in ((0, 5), (5, 19), (19, len(spec)))]
        results.append(model.flush())
        return ([e for r in results for e in r.events],
                [np.concatenate([r.throughput[i] for r in results])
                 for i in range(len(results[0].throughput))])

    ev, tp = feed(PipelineChannelizer(pcfg, devices=cpu(n)))
    for ref in (JaxPipe(jcfg, devices=jax.devices()[:n]),
                FrequencyDomainChannelizer(pcfg, device="cpu")):
        ev_ref, tp_ref = feed(ref)
        assert ev_ref
        assert_events_match(ev, ev_ref)
        for a, b in zip(tp, tp_ref):
            assert_close_to_max(a, b, RTOL, ATOL, "throughput")


def test_pipeline_multi_owner_scans_match():
    """Multi-owner stage B: three segments over three owner lanes, each
    its own kernel C call, equal to fdc_tpu's multi-owner pipeline and
    the plain channelizer."""
    jcfg, pcfg = configs(activity_detection_segments=MULTI_SEG)
    x = signal(pcfg, 5, 5, carriers=((-0.2, 0.2, 0.5), (0.1, 1 / 3, 0.8)))
    pipe = PipelineChannelizer(pcfg, devices=cpu(8), scan_owners=3)
    assert pipe._owner_groups == [(0, [0]), (1, [1]), (2, [2])]
    chunk = 2 * pcfg.batch_blocks * pcfg.inplen
    got = stream(pipe, x, chunk)
    ref = JaxPipe(jcfg, devices=jax.devices(), scan_owners=3)
    assert len(ref._owner_groups) == 3
    assert sum(e.vectorstart is not None for e in got[0]) > 2
    assert_streams_match(got, stream(ref, x, chunk))
    assert_streams_match(got, stream(
        FrequencyDomainChannelizer(pcfg, device="cpu"), x, chunk))


def test_pipeline_multi_owner_split_matches():
    """A segment split in 3 over two owner lanes with a dedicated owner
    pool: parts 0 and 2 scan on lane 0 with the burst chain, part 1 on
    lane 1, each reconciling its cuts against its neighbours' previous
    states (the foreign views), across the owners. A carrier sits on
    the first cut."""
    jcfg, pcfg = configs(segment_splits=((0, 3, 2),))
    x = signal(pcfg, 6, 9, carriers=((-0.415, 0.3, 0.7),))
    pipe = PipelineChannelizer(pcfg, devices=cpu(3), dedicated_owner=True,
                               scan_owners=2)
    assert pipe._owner_groups == [(0, [0, 2]), (1, [1])]
    assert pipe.worker_lanes == [2] and len(pipe._split_neighbors) == 3
    chunk = 2 * pcfg.batch_blocks * pcfg.inplen
    got = stream(pipe, x, chunk)
    ref = JaxPipe(jcfg, devices=jax.devices()[:3], dedicated_owner=True,
                  scan_owners=2)
    assert_streams_match(got, stream(ref, x, chunk))
    assert_streams_match(got, stream(
        FrequencyDomainChannelizer(pcfg, device="cpu"), x, chunk))


def make_port(kind, pcfg):
    if kind == "pipe":
        return PipelineChannelizer(pcfg, devices=cpu(3))
    return FrequencyDomainChannelizer(pcfg, device="cpu")


def split_run(save, load, x, cut, save_ckpt, load_ckpt, path):
    """The first ``cut`` samples through ``save``, saved; the rest through
    ``load`` resumed from the file; joined (events, streams)."""
    head = save.process(x[:cut])
    save_ckpt(save, path)
    load_ckpt(load, path)
    parts = [head, load.process(x[cut:]), load.flush()]
    return ([e for r in parts for e in r.events],
            [np.concatenate([r.throughput[i] for r in parts])
             for i in range(len(head.throughput))])


def assert_split_matches(got, ref_model, x):
    ev, tp = got
    full = [ref_model.process(x), ref_model.flush()]
    ev_ref = [e for r in full for e in r.events]
    assert ev_ref
    assert_events_match(ev, ev_ref)
    for i, s in enumerate(tp):
        assert_close_to_max(
            s, np.concatenate([r.throughput[i] for r in full]), RTOL, ATOL,
            f"throughput {i}")


@pytest.mark.parametrize("save_kind,load_kind", [
    ("pipe", "pipe"), ("pipe", "plain"), ("plain", "pipe"),
])
def test_pipeline_checkpoint_cross_topology(save_kind, load_kind,
                                            tmp_path):
    """A pipeline's file syncs its host tail into the carry (a plain
    channelizer resumes it); a pipeline resuming a plain file takes the
    carried reach-back row for its first batch. Cut mid-batch."""
    _, pcfg = configs()
    x = signal(pcfg, 6, 21)
    cut = 3 * pcfg.batch_blocks * pcfg.inplen + 5 * pcfg.inplen + 17
    got = split_run(make_port(save_kind, pcfg), make_port(load_kind, pcfg),
                    x, cut, ckpt.save_checkpoint, ckpt.load_checkpoint,
                    str(tmp_path / "pipe.ckpt"))
    assert_split_matches(got, FrequencyDomainChannelizer(pcfg, device="cpu"),
                         x)


@pytest.mark.parametrize("save_kind,load_kind", [
    ("pipe", "plain"), ("plain", "pipe"), ("pipe", "pipe"),
])
def test_pipeline_spectra_checkpoint_cross_topology(save_kind, load_kind,
                                                    tmp_path):
    """Vector mode: saving syncs the host-held reach-back row into the
    carry, else a plain resume would take the spectrum of silence."""
    _, pcfg = configs()
    x = signal(pcfg, 6, 23)
    spec = FrequencyDomainChannelizer(
        pcfg.replace(debug=True), device="cpu").process(x).debug_spectrum
    half = 3 * pcfg.batch_blocks
    save, load = make_port(save_kind, pcfg), make_port(load_kind, pcfg)
    head = save.process_spectra(spec[:half])
    path = str(tmp_path / "spec.ckpt")
    ckpt.save_checkpoint(save, path)
    ckpt.load_checkpoint(load, path)
    parts = [head, load.process_spectra(spec[half:]), load.flush()]
    ref = FrequencyDomainChannelizer(pcfg, device="cpu")
    full = [ref.process_spectra(spec), ref.flush()]
    assert_events_match([e for r in parts for e in r.events],
                        [e for r in full for e in r.events])
    for i in range(len(head.throughput)):
        assert_close_to_max(
            np.concatenate([r.throughput[i] for r in parts]),
            np.concatenate([r.throughput[i] for r in full]), RTOL, ATOL,
            f"throughput {i}")


def test_fdc_tpu_pipeline_file_resumes_in_port_pipeline(tmp_path):
    """fdc_tpu's pipeline writes its host tail and reach-back row
    (``pipeline_tail``, ``pipeline_prev_specf``); the port's pipeline
    resumes from them."""
    jcfg, pcfg = configs()
    x = signal(pcfg, 6, 29)
    cut = 3 * pcfg.batch_blocks * pcfg.inplen + 300
    got = split_run(JaxPipe(jcfg, devices=jax.devices()[:3]),
                    PipelineChannelizer(pcfg, devices=cpu(3)), x, cut,
                    jax_ckpt.save_checkpoint, ckpt.load_checkpoint,
                    str(tmp_path / "jax_pipe.ckpt"))
    assert_split_matches(got, JaxFDC(jcfg), x)


def test_port_pipeline_file_resumes_in_fdc_tpu_plain(tmp_path):
    jcfg, pcfg = configs()
    x = signal(pcfg, 6, 31)
    cut = 3 * pcfg.batch_blocks * pcfg.inplen + 300
    save = PipelineChannelizer(pcfg, devices=cpu(3))
    got = split_run(save, JaxFDC(jcfg), x, cut, ckpt.save_checkpoint,
                    jax_ckpt.load_checkpoint,
                    str(tmp_path / "port_pipe.ckpt"))
    assert_split_matches(got, JaxFDC(jcfg), x)


def test_port_pipeline_file_has_fdc_tpus_host_state(tmp_path):
    """The host state a pipeline saves is fdc_tpu's: the same keys,
    dtypes and shapes, and the carry synced from it."""
    import pickle

    jcfg, pcfg = configs()
    x = signal(pcfg, 2, 3)[:-1000]
    files = {}
    for name, model, save in (
            ("port", PipelineChannelizer(pcfg, devices=cpu(2)),
             ckpt.save_checkpoint),
            ("jax", JaxPipe(jcfg, devices=jax.devices()[:2]),
             jax_ckpt.save_checkpoint)):
        model.process(x)
        save(model, str(tmp_path / name))
        with open(tmp_path / name, "rb") as fh:
            files[name] = pickle.load(fh)["host_extra"]
    assert files["port"].keys() == files["jax"].keys() == {
        "pipeline_tail", "pipeline_prev_specf"}
    for k in files["port"]:
        a, b = files["port"][k], files["jax"][k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
    np.testing.assert_array_equal(files["port"]["pipeline_tail"],
                                  files["jax"]["pipeline_tail"])


def test_one_entry_point_per_stream():
    _, pcfg = configs()
    pipe = PipelineChannelizer(pcfg, devices=cpu(2))
    pipe.process(np.zeros(pcfg.inplen, np.complex64))
    with pytest.raises(RuntimeError, match="one entry point per stream"):
        pipe.process_spectra(np.zeros((8, pcfg.blocksize), np.complex64))
    pipe.reset()
    pipe.process_spectra(np.zeros((3, pcfg.blocksize), np.complex64))
    with pytest.raises(RuntimeError, match="one entry point per stream"):
        pipe.process(np.zeros(pcfg.inplen, np.complex64))


def test_shard_time_must_be_positive():
    _, pcfg = configs()
    with pytest.raises(ValueError, match="shard_time must be >= 1"):
        PipelineChannelizer(pcfg, devices=cpu(4), shard_time=0)


@pytest.mark.parametrize("kw,msg", [
    (dict(devices=cpu(3), shard_time=4), "needs at least that many"),
    (dict(devices=cpu(4), shard_time=3), "must be divisible by shard_time"),
    (dict(devices=cpu(4), shard_time=4), "phase-fold contract"),
], ids=["devices", "batch", "fold"])
def test_shard_time_contracts_are_fdc_tpus(kw, msg):
    """fdc_tpu's refusals: a group larger than the workers, a batch its
    runs do not divide, a run that breaks the phase fold (b = 2, R = 4
    where B % R == 0)."""
    jcfg, pcfg = configs()
    jkw = dict(kw, devices=jax.devices()[:len(kw["devices"])])
    with pytest.raises(ValueError) as ref:
        JaxPipe(jcfg, **jkw)
    with pytest.raises(ValueError) as got:
        PipelineChannelizer(pcfg, **kw)
    assert msg in str(got.value) and str(got.value) == str(ref.value)


@pytest.mark.parametrize("shard_time,n,dedicated", [
    (2, 4, False), (4, 4, False), (2, 5, True),
], ids=["2 groups of 2", "1 group of 4", "dedicated owner, 2 groups"])
def test_pipeline_shard_time_matches(shard_time, n, dedicated):
    """Pipeline x SPMD: each worker a group of ``shard_time`` lanes, each
    framing its own run with one reach-back block, the runs' reach-back
    rows dropped on the host; against fdc_tpu's composed pipeline and
    the plain channelizer (tests/test_pipeline.py:255-289)."""
    jcfg, pcfg = configs(batch_blocks=4 * shard_time)
    x = signal(pcfg, 6, 7)
    pipe = PipelineChannelizer(pcfg, devices=cpu(n), shard_time=shard_time,
                               dedicated_owner=dedicated)
    ref = JaxPipe(jcfg, devices=jax.devices()[:n], shard_time=shard_time,
                  dedicated_owner=dedicated)
    assert len(pipe.groups) == len(ref.group_meshes) >= 1
    assert all(len(g) == shard_time for g in pipe.groups)
    chunk = 2 * pcfg.batch_blocks * pcfg.inplen
    got = stream(pipe, x, chunk)
    assert_streams_match(got, stream(ref, x, chunk))
    assert_streams_match(got, stream(
        FrequencyDomainChannelizer(pcfg, device="cpu"), x, chunk))


@pytest.mark.parametrize("shard_time", [2, 4])
def test_pipeline_shard_time_process_spectra(shard_time):
    """Vector mode through the groups: lane t gets rows [t*b, (t+1)*b] of
    the host's extended batch (exact reach-back rows); ragged row
    chunks."""
    jcfg, pcfg = configs(batch_blocks=4 * shard_time)
    x = signal(pcfg, 4, 13)
    spec = FrequencyDomainChannelizer(
        pcfg.replace(debug=True), device="cpu").process(x).debug_spectrum

    def feed(model, cuts):
        results = [model.process_spectra(spec[lo:hi]) for lo, hi in cuts]
        results.append(model.flush())
        return ([e for r in results for e in r.events],
                [np.concatenate([r.throughput[i] for r in results])
                 for i in range(len(results[0].throughput))])

    n = len(spec)
    ragged = ((0, 5), (5, n // 2 + 3), (n // 2 + 3, n - 2))
    ev, tp = feed(PipelineChannelizer(pcfg, devices=cpu(4),
                                      shard_time=shard_time), ragged)
    for ref, cuts in ((JaxPipe(jcfg, devices=jax.devices()[:4],
                               shard_time=shard_time), ((0, n - 2),)),
                      (FrequencyDomainChannelizer(pcfg, device="cpu"),
                       ragged)):
        ev_ref, tp_ref = feed(ref, cuts)
        assert ev_ref
        assert_events_match(ev, ev_ref)
        for a, b in zip(tp, tp_ref):
            assert_close_to_max(a, b, RTOL, ATOL, "throughput")


@pytest.mark.parametrize("load_kind", ["plain", "jax-plain", "pipe"])
def test_pipeline_shard_time_multi_owner_checkpoint(load_kind, tmp_path):
    """Composition with two scan owners, saved mid-stream (the segment
    carries on their owner lanes) and resumed by a plain channelizer of
    either package or by another composed pipeline: the uninterrupted
    run's events (tests/test_pipeline.py:350-380)."""
    jcfg, pcfg = configs(
        activity_detection_segments=[(-0.47, -0.3), (0.03, 0.2)])
    x = signal(pcfg, 6, 23, carriers=((0.1, 0.4, 0.8),))
    cut = len(x) // 2 + 3 * pcfg.inplen

    def pipe():
        return PipelineChannelizer(pcfg, devices=cpu(8), shard_time=2,
                                   scan_owners=2)

    a = pipe()
    assert [lane for lane, _ in a._owner_groups] == [0, 1]
    load, load_ckpt = {
        "plain": (FrequencyDomainChannelizer(pcfg, device="cpu"),
                  ckpt.load_checkpoint),
        "jax-plain": (JaxFDC(jcfg), jax_ckpt.load_checkpoint),
        "pipe": (pipe(), ckpt.load_checkpoint),
    }[load_kind]
    got = split_run(a, load, x, cut, ckpt.save_checkpoint, load_ckpt,
                    str(tmp_path / "comp.ckpt"))
    assert_split_matches(got, FrequencyDomainChannelizer(pcfg, device="cpu"),
                         x)


def test_default_devices_are_the_cards():
    """Without ``devices`` the pipeline takes every CUDA device; with
    none it raises (no CPU fallback)."""
    _, pcfg = configs()
    if torch.cuda.is_available():
        pipe = PipelineChannelizer(pcfg)
        assert [d.type for d in pipe.devices] == (
            ["cuda"] * torch.cuda.device_count())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PipelineChannelizer(pcfg)


def test_lane_on_another_device_gets_a_replica():
    """A lane on a device other than devices[0] reads its own copy of the
    module's tables: every buffer moves to the lane's device (here the
    meta device, which the CPU build has) and the module's stay where
    they are; a replica's stage outputs equal the module's (here a
    replica on the CPU itself, its sub-modules copies)."""
    _, pcfg = configs(activity_detection_segments=MULTI_SEG)
    pipe = PipelineChannelizer(pcfg, devices=cpu(2))
    assert list(pipe._replicas.values()) == [pipe]
    mine = dict(pipe.named_buffers())
    meta = pipe._replica(torch.device("meta"))
    assert meta.device.type == "meta"
    theirs = dict(meta.named_buffers())
    assert mine.keys() == theirs.keys() and mine
    for k in mine:
        assert theirs[k].device.type == "meta", k
        assert mine[k].device.type == "cpu", k
    rep = pipe._replica(torch.device("cpu"))
    assert rep.segments[0] is not pipe.segments[0]
    x = signal(pcfg, 1, 2)
    spec = FrequencyDomainChannelizer(
        pcfg.replace(debug=True), device="cpu").process(x).debug_spectrum
    spec_ext = torch.from_numpy(np.concatenate([spec[:1], spec]))
    a = pipe._extract_static(spec_ext[1:], spec_ext, 0)
    b = rep._extract_static(spec_ext[1:], spec_ext, 0)
    for u, v in zip(a[3] + list(a[4]), b[3] + list(b[4])):
        assert torch.equal(u, v)


def test_plain_step_is_its_three_stages():
    """The plain step is the pipeline's three stages in a row: its
    outputs are the stages' outputs, assembled."""
    _, pcfg = configs(activity_detection_segments=MULTI_SEG,
                      extract_width_split=16, extract_budget_narrow=4)
    fdc = FrequencyDomainChannelizer(pcfg, device="cpu")
    x = torch.from_numpy(signal(pcfg, 1, 4))
    carry, out = fdc._device_step(fdc._device_init(), x, 0)
    spec = FrequencyDomainChannelizer(
        pcfg.replace(debug=True), device="cpu").process(
        x.numpy()).debug_spectrum
    spec_ext = torch.from_numpy(np.concatenate(
        [np.zeros((1, pcfg.blocksize), np.complex64), spec]))
    c = fdc._device_init()
    st_out, pa_powers, pa_ext, seg_powers, seg_packed = fdc._extract_static(
        spec_ext[1:], spec_ext, 0)
    scans = fdc._scan_detections(c, pa_powers, seg_packed)
    extracts = fdc._extract_slots_all(
        spec_ext, [st for st, _ in scans["segs"]],
        [so for _, so in scans["segs"]])
    assert all("extract_narrow" in eo for eo in extracts)
    fdc._assemble_detections(st_out, scans, extracts, pa_ext, seg_powers)
    for i in range(len(MULTI_SEG)):
        for k in ("extract", "extract_narrow", "slot_ids", "activated"):
            assert_close_to_max(out[f"seg{i}"][k].numpy(),
                                st_out[f"seg{i}"][k].numpy(), RTOL, ATOL,
                                f"seg{i} {k}")
