"""The port's sharded step against ``fdc_tpu``'s and the plain channelizer.

``fdc_tpu_torch.parallel.ShardedChannelizer`` runs on ``["cpu"] * n``
ranks (the kernels' plain versions), ``fdc_tpu``'s on the forced
8-device CPU mesh, over the small config and signal of
``tests/test_parallel.py`` (numpy seeds); both are also held against the
plain channelizers. Tolerances (tests/test_parallel.py:80-95 and
ROADMAP's): flags, slot tables, plans, counters and event metadata
exact; streams, extractions and event samples (as one stream) within
rtol 2e-4 / atol 2e-5 of the max; powers within 1e-5 of the max (the
time ranks transform b-row runs where the plain step transforms the
batch, and the CPU's four-step products may round otherwise). The 4x4
mesh needs 16 ranks, which the port has on the CPU and ``fdc_tpu`` only
in a process of its own: it is held against both plain channelizers.
Counterparts: tests/test_parallel.py.
"""

import jax
import numpy as np
import pytest
import torch

from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fdc_tpu.parallel.sharded import ShardedChannelizer as JaxSharded
from fdc_tpu_torch import FrequencyDomainChannelizer
from fdc_tpu_torch.convert import carry_to_numpy
from fdc_tpu_torch.models import channelizer as channelizer_mod
from fdc_tpu_torch.parallel import ShardedChannelizer, make_mesh
from fdc_tpu_torch.parallel.sharded import split_rows

from test_torch_pipeline import (
    MULTI_SEG,
    assert_streams_match,
    configs,
    signal,
    stream,
)
from test_torch_slice import (
    ATOL,
    RTOL,
    assert_close_to_max,
    assert_events_match,
    assert_outputs_match,
    jax_step,
)


def port_sharded(pcfg, n_time, n_chan):
    return ShardedChannelizer(pcfg, mesh=make_mesh(
        n_time, n_chan, ["cpu"] * (n_time * n_chan)))


def jax_sharded(jcfg, n_time, n_chan):
    return JaxSharded(jcfg, mesh=jax_make_mesh(n_time=n_time,
                                               n_chan=n_chan))


def assert_carries_match(port, ref):
    """Slot tables, counters and burst states exact; the framing history,
    the reach-back row and the burst chain's last powers (a noise block's,
    whose own scale is far below the run's) within the stream
    tolerance."""
    got = carry_to_numpy(port._carry)
    want = jax.tree.map(np.asarray, ref._carry)
    for key in want:
        if key in ("hist", "prev_spec"):
            assert_close_to_max(got[key], want[key], RTOL, ATOL, key)
            continue
        for leaf, b in want[key].items():
            a = got[key][leaf]
            assert a.shape == b.shape, (key, leaf)
            if b.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b, err_msg=f"{key}/{leaf}")
            else:
                assert_close_to_max(a, b, RTOL, ATOL, f"{key}/{leaf}")


def three_way(jcfg, pcfg, n_time, n_chan, x, n_batches=2):
    """The port's sharded run against fdc_tpu's sharded run (streams and
    the final carry) and the port's plain run; returns the sharded
    channelizer."""
    chunk = n_batches * pcfg.batch_blocks * pcfg.inplen
    sh = port_sharded(pcfg, n_time, n_chan)
    got = stream(sh, x, chunk)
    ref = jax_sharded(jcfg, n_time, n_chan)
    assert_streams_match(got, stream(ref, x, chunk))
    assert_carries_match(sh, ref)
    assert_streams_match(got, stream(
        FrequencyDomainChannelizer(pcfg, device="cpu"), x, chunk))
    return sh, got


@pytest.mark.parametrize("n_time,n_chan",
                         [(4, 2), (8, 1), (1, 2), (2, 2), (1, 1)])
def test_sharded_matches_fdc_tpu_and_plain(n_time, n_chan):
    jcfg, pcfg = configs()
    x = signal(pcfg, 4, 7)
    sh, got = three_way(jcfg, pcfg, n_time, n_chan, x)
    assert any(e.vectorstart is not None for e in got[0])
    assert len(sh.devices) == n_time * n_chan


@pytest.mark.parametrize("n_time,n_chan", [(4, 2)])
def test_sharded_step_outputs_match_fdc_tpu(n_time, n_chan):
    """Step by step, every output of the sharded steps key by key: flags,
    plans and counters exact, extractions and powers within their
    tolerances (three segments, so the scans run in chan owner groups)."""
    jcfg, pcfg = configs(activity_detection_segments=MULTI_SEG)
    x = signal(pcfg, 4, 5, carriers=((-0.2, 0.2, 0.5), (0.1, 1 / 3, 0.8)))
    sh = port_sharded(pcfg, n_time, n_chan)
    ref = jax_sharded(jcfg, n_time, n_chan)
    carry, jcarry = sh._device_init(), ref._jit_init()
    bs = pcfg.batch_blocks * pcfg.inplen
    for b in range(len(x) // bs):
        chunk = x[b * bs:(b + 1) * bs]
        t0 = b * pcfg.batch_blocks
        carry, out = sh._device_step(carry, torch.from_numpy(chunk), t0)
        jcarry, jout = jax_step(ref, jcarry, chunk, t0)
        assert_outputs_match(out, jout, f"step {b}")


def test_sharded_4x4_sixteen_ranks():
    """A 4x4 mesh of 16 CPU ranks, two segments over four chan owners:
    equal to both plain channelizers."""
    jcfg, pcfg = configs(activity_detection_segments=[(-0.47, -0.3),
                                                      (-0.25, -0.05)])
    x = signal(pcfg, 4, 7)
    chunk = 2 * pcfg.batch_blocks * pcfg.inplen
    sh = port_sharded(pcfg, 4, 4)
    assert sh._owner_groups == [(0, [0]), (1, [1])]
    got = stream(sh, x, chunk)
    assert_streams_match(got, stream(JaxFDC(jcfg), x, chunk))
    assert_streams_match(got, stream(
        FrequencyDomainChannelizer(pcfg, device="cpu"), x, chunk))


def spectra_of(pcfg, x):
    return FrequencyDomainChannelizer(
        pcfg.replace(debug=True), device="cpu").process(x).debug_spectrum


@pytest.mark.parametrize("n_time,n_chan", [(4, 2), (8, 1), (1, 2)])
def test_sharded_process_spectra_matches(n_time, n_chan):
    """Vector mode over the sharded step, fed in ragged row chunks (the
    row buffering across calls and flush's padded tail), against
    fdc_tpu's sharded vector mode and the plain one."""
    jcfg, pcfg = configs()
    spec = spectra_of(pcfg, signal(pcfg, 3, 11))  # [24, N]

    def feed(model, cuts):
        results = [model.process_spectra(spec[lo:hi]) for lo, hi in cuts]
        results.append(model.flush())
        return ([e for r in results for e in r.events],
                [np.concatenate([r.throughput[i] for r in results])
                 for i in range(len(results[0].throughput))],
                [np.concatenate([r.segment_power[i] for r in results])
                 for i in range(len(results[0].segment_power))])

    ragged = ((0, 3), (3, 10), (10, 11), (11, 21))
    got = feed(port_sharded(pcfg, n_time, n_chan), ragged)
    assert_streams_match(got, feed(jax_sharded(jcfg, n_time, n_chan),
                                   ((0, 21),)))
    assert_streams_match(got, feed(FrequencyDomainChannelizer(
        pcfg, device="cpu"), ragged))


def test_sharded_extract_budget():
    """Each chan rank extracts its slice of the compacted plan."""
    jcfg, pcfg = configs(max_slots=8, extract_budget=4)
    sh, _ = three_way(jcfg, pcfg, 4, 2, signal(pcfg, 4, 7))
    assert sh.segment_emitters[0].lost_rows == 0


def test_sharded_split_bucket():
    """Two-tier extraction: each chan rank slices both plans."""
    jcfg, pcfg = configs(max_slots=8, extract_budget=2,
                         extract_width_split=64, extract_budget_narrow=4,
                         max_extract_width=256)
    three_way(jcfg, pcfg, 2, 2, signal(pcfg, 4, 7))


@pytest.mark.parametrize("n_time,n_chan", [(2, 2), (1, 4), (4, 2)])
def test_multi_segment_scans_owned_over_chan(n_time, n_chan):
    """Segment i's scan runs on chan rank i % n_chan (one kernel C call
    an owner group, the burst chain with group 0); three segments on 2
    and 4 chan ranks exercise the uneven assignment and an owner other
    than rank 0."""
    jcfg, pcfg = configs(activity_detection_segments=MULTI_SEG)
    x = signal(pcfg, 4, 19, carriers=((-0.2, 0.2, 0.5), (0.1, 1 / 3, 0.8),
                                      (-0.4, 0.4, 0.9)))
    sh, got = three_way(jcfg, pcfg, n_time, n_chan, x)
    owners = {i % n_chan for i in range(3)}
    assert [lane for lane, _ in sh._owner_groups] == sorted(owners)
    assert sh._seg_lane == [i % n_chan for i in range(3)]
    segs = {e.ID.split(".")[-2] for e in got[0] if "DETECTED" in e.ID}
    assert len(segs) == 3, segs


def test_sharded_split_segment():
    """A segment split in 3 on two chan ranks: parts 0 and 2 scan on rank
    0 with the burst chain, part 1 on rank 1, each reconciling its cuts
    against its neighbours' previous states across the owners; a carrier
    sits on the first cut."""
    jcfg, pcfg = configs(segment_splits=((0, 3, 2),))
    x = signal(pcfg, 4, 9, carriers=((-0.415, 0.3, 0.7),))
    sh, _ = three_way(jcfg, pcfg, 2, 2, x)
    assert sh._owner_groups == [(0, [0, 2]), (1, [1])]
    assert len(sh._split_neighbors) == 3


def test_phase_fold_only_where_runs_are_whole_turns(monkeypatch):
    """A time rank folds the overlap-save phase (and runs the measures
    on kernel A) only when its run b is a multiple of R: at B = 8, R = 4
    that is T = 2 (b = 4) and not T = 4 (b = 2), where every rank takes
    the unfolded route with per-row phases from its own t0 + t*b."""
    rows = []  # the spectrum rows of each folded call
    for name in ("extract_bucket_phased", "extract_bucket_measured"):
        real = getattr(channelizer_mod, name)
        monkeypatch.setattr(channelizer_mod, name,
                            lambda spec, *a, _r=real, **k: (
                                rows.append(spec.shape[0]),
                                _r(spec, *a, **k))[1])
    jcfg, pcfg = configs()
    x = signal(pcfg, 4, 3)
    assert pcfg.batch_blocks == 8 and pcfg.relinvovl == 4
    rows.clear()
    sh, _ = three_way(jcfg, pcfg, 4, 1, x)
    assert sh.b_local == 2 and 2 not in rows, rows
    assert 8 in rows  # the plain channelizer's batch folds
    rows.clear()
    sh = port_sharded(pcfg, 2, 1)
    chunk = 2 * pcfg.batch_blocks * pcfg.inplen
    assert_streams_match(stream(sh, x, chunk), stream(
        FrequencyDomainChannelizer(pcfg, device="cpu"), x, chunk))
    assert sh.b_local == 4 and 4 in rows, rows


def test_slot_rounding_and_batch_divisibility():
    jcfg, pcfg = configs(max_slots=6, extract_budget=3,
                         extract_width_split=64, extract_budget_narrow=5,
                         max_extract_width=256)
    sh = port_sharded(pcfg, 2, 4)
    ref = jax_sharded(jcfg, 2, 4)
    for k in ("max_slots", "extract_budget", "extract_budget_narrow"):
        assert getattr(sh.config, k) == getattr(ref.config, k), k
    assert (sh.config.max_slots, sh.config.extract_budget,
            sh.config.extract_budget_narrow) == (8, 4, 8)
    _, bad = configs(batch_blocks=9)
    with pytest.raises(ValueError, match="divisible by the time axis"):
        port_sharded(bad, 2, 4)
    with pytest.raises(ValueError, match="requires a mesh"):
        ShardedChannelizer(pcfg)


@pytest.mark.parametrize("args", [
    dict(n_time=3, n_chan=2), dict(n_chan=0), dict(n_time=0, n_chan=1),
    dict(n_chan=9),
], ids=lambda a: ",".join(f"{k}={v}" for k, v in a.items()))
def test_mesh_errors_are_fdc_tpus(args):
    """make_mesh over 4 ranks refuses what fdc_tpu's refuses over 4
    devices, with the same message."""
    with pytest.raises(ValueError) as ref:
        jax_make_mesh(devices=jax.devices()[:4], **args)
    with pytest.raises(ValueError) as got:
        make_mesh(devices=["cpu"] * 4, **args)
    assert str(got.value) == str(ref.value)


def test_mesh_shape_and_default_devices():
    mesh = make_mesh(n_chan=2, devices=["cpu"] * 8)
    assert mesh.shape == {"time": 4, "chan": 2}
    assert [str(d) for d in mesh.local_devices] == ["cpu"] * 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(n_time=1)


@pytest.mark.parametrize("n_chan", [2, 4])
def test_rank_tables_are_padded_slices(n_chan):
    """Chan rank c holds slice c of every bucket's zero-padded tables
    (the starts, and per-channel matrices; a shared matrix whole), the
    unfused buckets' starts equal to fdc_tpu's per-rank tables; a fused
    family splits its throughput and burst rows separately."""
    jcfg, pcfg = configs(
        throughput_channels=[(-0.25, 0.04), (0.125, 0.08), (-0.1, 0.04)],
        activity_controlled_channels=[(0.3, 0.05), (0.4, 0.04)])
    plain = FrequencyDomainChannelizer(pcfg, device="cpu")
    sh = port_sharded(pcfg, 2, n_chan)
    ref = jax_sharded(jcfg, 2, n_chan)
    assert plain._fused, "the config must have a fused family"
    jax_tp = {b.width: starts for b, starts, _ in ref._tp_unfused}
    jax_pa = {b.width: starts for b, starts, _ in ref._pa_unfused}
    for lane, view in enumerate(sh._views):
        c = lane % n_chan
        for mod, jax_starts in ((plain.throughput, jax_tp),
                                (plain.power_bank, jax_pa)):
            vmod = getattr(view, "throughput" if mod is plain.throughput
                           else "power_bank")
            for b, vb in zip(mod.buckets, vmod.buckets):
                starts, folded = mod.tables(b)
                vs, vf = vmod.tables(vb)
                assert torch.equal(vs, split_rows(starts, n_chan)[c])
                assert torch.equal(vf, folded if folded.dim() == 2
                                   else split_rows(folded, n_chan)[c])
                assert len(vb.channel_ids) == len(vs)
                if b.width in jax_starts:
                    np.testing.assert_array_equal(
                        vs.numpy(), jax_starts[b.width][c])
        for w, (name, tb) in plain._fused.items():
            n_tp = len(tb.channel_ids)
            starts = getattr(plain, f"{name}_starts")
            want = torch.cat([split_rows(starts[:n_tp], n_chan)[c],
                              split_rows(starts[n_tp:], n_chan)[c]])
            assert torch.equal(getattr(view, f"{name}_starts"), want)
            assert len(view._fused[w][1].channel_ids) == len(
                split_rows(starts[:n_tp], n_chan)[c])


def test_sharded_debug_spectrum_and_flush():
    """The debug spectrum joins the time ranks' rows; flush() finalizes
    open bursts as the plain channelizer does."""
    jcfg, pcfg = configs(debug=True)
    x = signal(pcfg, 2, 5)
    sh = port_sharded(pcfg, 4, 2)
    got = sh.process(x[:-1000])
    fin = sh.flush()
    ref = JaxFDC(jcfg)
    want = ref.process(x[:-1000])
    want_fin = ref.flush()
    assert_close_to_max(got.debug_spectrum, want.debug_spectrum, RTOL, ATOL,
                        "debug spectrum")
    assert_close_to_max(fin.debug_spectrum, want_fin.debug_spectrum, RTOL,
                        ATOL, "flushed debug spectrum")
    assert_events_match(got.events + fin.events, want.events + want_fin.events)
