"""The pre-FFT'd entry points of fdc_tpu_torch against fdc_tpu: the
multi-segment vcm detector (``ActivityDetectionChannelizer`` and its
runner, with ``zero_floor`` edge ratios) and
``FrequencyDomainChannelizer.process_spectra``.

The port runs on the CPU, i.e. through the kernels' plain versions; the
JAX package runs its own CPU path (XLA + lax.scan). Spectra are made once
with numpy (the golden overlap-save front end of tests/golden.py) and fed
to both. Tolerances (ROADMAP "How a part is held"): flags, plans, tables,
counters and event metadata exact; extractions, streams and event
samples rtol 2e-4 / atol 2e-5 of each tensor's max; powers 1e-5 of the
max (the port sums re^2 + im^2, the JAX package |X|^2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship as jax_flagship
from fdc_tpu.models.activity_detection import (
    ActivityDetectionChannelizer as JaxADC,
)
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.ops.detect import detect_edges as jax_detect_edges
from fdc_tpu.utils.cplx import c2f_host
from fdc_tpu_torch import ActivityDetectionChannelizer
from fdc_tpu_torch import FrequencyDomainChannelizer
from fdc_tpu_torch.convert import carry_from_numpy, carry_to_numpy
from fdc_tpu_torch.flagship import _flagship
from fdc_tpu_torch.ops.detect import detect_edges
from fdc_tpu_torch.ops.fft import forward_spectrum
from fdc_tpu_torch.ops.framing import frame_blocks

from golden import (
    golden_activity_detection_vcm,
    golden_forward_fft,
    golden_overlap_save,
)
from test_torch_slice import (
    assert_close_to_max,
    assert_events_match,
    assert_outputs_match,
    capture,
    meta,
)

RTOL, ATOL = 2e-4, 2e-5


def make_spectra(n_blocks, blocklen, relinvovl, carriers, seed=2):
    """[n_blocks, blocklen] complex64 spectra of a synthetic capture
    (tests/test_activity_detection.py's scene, framed and transformed by
    the golden front end); carriers are (fdc_freq, amplitude, on_block,
    off_block)."""
    inplen = blocklen - blocklen // relinvovl
    n = n_blocks * inplen
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    x = 0.005 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for f, a, on, off in carriers:
        m = np.zeros(n)
        m[on * inplen:off * inplen] = 1.0
        x = x + a * m * np.exp(2j * np.pi * (f - 0.5) * t)
    blocks, _ = golden_overlap_save(x.astype(np.complex64).astype(
        np.complex128), blocklen, blocklen // relinvovl)
    return golden_forward_fft(blocks).astype(np.complex64)


SCENES = {
    # tests/test_activity_detection.py::test_multi_segment_independent_detection
    "two-segments": (
        dict(blocklen=512, segments=[[0.05, 0.3], [0.6, 0.9]], thresh_db=8.0,
             relinvovl=4, minchandist=0.02, channel_deactivation_delay=1,
             window_flank_puffer=0.1, max_slots=8, max_candidates=8),
        256, (48, [(0.15, 2.0, 10, 30), (0.75, 2.0, 20, 40)])),
    # ...::test_vcm_matches_golden (exact mode, partial emissions)
    "golden": (
        dict(blocklen=512, segments=[[0.05, 0.45], [0.55, 0.95]],
             thresh_db=8.0, relinvovl=4, minchandist=0.02,
             channel_deactivation_delay=1, window_flank_puffer=0.2,
             max_slots=8),
        5, (40, [(0.25, 1.0, 6, 16), (0.62, 0.9, 10, 24),
                 (0.82, 1.2, 12, 20)])),
    # ...::test_vcm_split_bucket_matches_single_bucket (two-tier)
    "two-tier": (
        dict(blocklen=512, segments=[[0.05, 0.45]], thresh_db=8.0,
             relinvovl=4, minchandist=0.02, channel_deactivation_delay=1,
             window_flank_puffer=0.1, max_slots=8, max_extract_width=256,
             extract_budget=2, extract_width_split=64,
             extract_budget_narrow=4),
        256, (40, [(0.25, 1.0, 8, 32)])),
}


def runners(kw, maxblocks):
    jr = JaxADC(**kw).make_runner(maxblocks=maxblocks, native_emission=False)
    tr = ActivityDetectionChannelizer(**kw, device="cpu").make_runner(
        maxblocks=maxblocks)
    return jr, tr


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_vcm_runner_matches_jax(scene):
    """Step outputs of every segment key by key, then the events."""
    kw, maxblocks, (nb, carriers) = SCENES[scene]
    spectra = make_spectra(nb, kw["blocklen"], kw["relinvovl"], carriers)
    jr, tr = runners(kw, maxblocks)
    jc, tc = jr._jit_init(), tr._device_init()
    for lo in range(0, nb, 8):
        chunk = spectra[lo:lo + 8]
        jc, jo = jr._jit_step(jc, jnp.asarray(c2f_host(chunk)))
        tc, to = tr._device_step(tc, torch.from_numpy(chunk))
        assert_outputs_match(to, jax.tree.map(np.asarray, jo),
                             f"{scene} blocks {lo}")
    ej, et = [], []
    for lo in range(0, nb, 8):
        ej += jr.process_spectra(spectra[lo:lo + 8])
        et += tr.process_spectra(spectra[lo:lo + 8])
    assert len(ej) >= 2
    assert_events_match(et, ej)
    assert tr.has_open_slots() == jr.has_open_slots()


def test_vcm_matches_golden():
    """The port's runner against the sequential replay of the reference
    vcm block (tests/golden.py), as
    tests/test_activity_detection.py::test_vcm_matches_golden holds the
    JAX runner: per segment, metadata exact and samples to 3e-4."""
    kw, maxblocks, (nb, carriers) = SCENES["golden"]
    spectra = make_spectra(nb, kw["blocklen"], kw["relinvovl"], carriers)
    _, tr = runners(kw, maxblocks)
    events = []
    for lo in range(0, nb, 8):
        events += tr.process_spectra(spectra[lo:lo + 8])
    ref = golden_activity_detection_vcm(
        spectra.astype(np.complex128), kw["blocklen"], kw["relinvovl"],
        kw["segments"], kw["thresh_db"], kw["minchandist"],
        kw["window_flank_puffer"], maxblocks,
        kw["channel_deactivation_delay"])
    assert len([g for g in ref if not g["finalized"]]) > 0, "need partials"
    assert len(events) == len(ref)
    for sid in range(len(kw["segments"])):
        ours = [e for e in events if f".DETECTED.{sid}." in e.ID]
        gold = [g for g in ref if g["seg_id"] == sid]
        assert len(ours) == len(gold) > 0
        for ev, g in zip(ours, gold):
            assert (ev.finalized, ev.blockstart, ev.blockend, ev.vectorstart,
                    ev.vectorend) == (g["finalized"], g["blockstart"],
                                      g["blockend"], g["vectorstart"],
                                      g["vectorend"])
            if g["part"] is not None:
                assert ev.part == g["part"]
            assert int(ev.ID.split(".")[-1]) == g["chan_id"]
            np.testing.assert_allclose(ev.rel_cfreq, g["rel_cfreq"])
            np.testing.assert_allclose(ev.rel_bw, g["rel_bw"])
            assert ev.data.shape == g["data"].shape
            np.testing.assert_allclose(ev.data, g["data"], atol=3e-4)


def test_zero_floor_edges_match_jax():
    """Zero cells: with zero_floor a zero denominator becomes FLT_MIN, so
    0/0 is a falling edge and x/0 a strong rise; without it 0/0 is NaN (no
    edge)."""
    rng = np.random.default_rng(7)
    power = rng.exponential(1.0, (6, 40)).astype(np.float32)
    power[:, 10:14] = 0.0       # 0/0 inside, x/0 and 0/x at the edges
    power[2, :] = 0.0           # an all-zero block
    power[4, 30] = 0.0
    for zero_floor in (False, True):
        got = detect_edges(torch.from_numpy(power), 10 ** 0.8, 39,
                           zero_floor=zero_floor)
        ref = jax.vmap(lambda p: jax_detect_edges(
            p, 10 ** 0.8, 39, zero_floor=zero_floor))(jnp.asarray(power))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # block 2 is all zeros: every ratio 0/FLT_MIN = 0 is a fall, no rise
    s, e, pair = detect_edges(torch.from_numpy(power), 10 ** 0.8, 39,
                              zero_floor=True)
    assert not pair[2].any()


def test_zero_floor_runner_matches_jax():
    """Spectra with silent (all-zero) blocks and a zeroed band through
    both runners: the vcm detector's edge ratios see 0/0."""
    kw, maxblocks, (nb, carriers) = SCENES["two-segments"]
    spectra = make_spectra(nb, kw["blocklen"], kw["relinvovl"], carriers)
    spectra[24:28] = 0.0
    spectra[:, 40:120] = 0.0
    jr, tr = runners(kw, maxblocks)
    ej, et = [], []
    for lo in range(0, nb, 8):
        ej += jr.process_spectra(spectra[lo:lo + 8])
        et += tr.process_spectra(spectra[lo:lo + 8])
    assert ej
    assert_events_match(et, ej)


def test_vcm_carry_handover_from_jax():
    """Three batches on the JAX runner, then the port continues from its
    carry (fdc_tpu_torch.convert) and emitter state, live slots included;
    the carry also converts back."""
    kw, maxblocks, (nb, carriers) = SCENES["golden"]
    spectra = make_spectra(nb, kw["blocklen"], kw["relinvovl"], carriers)
    jr, tr = runners(kw, maxblocks)
    for lo in range(0, 24, 8):
        jr.process_spectra(spectra[lo:lo + 8])
    jcarry = jax.tree.map(np.asarray, jr._carry)
    tr._carry = carry_from_numpy(jcarry, "cpu")
    tr._t0 = jr._t0
    for et_, ej_ in zip(tr.emitters, jr.emitters):
        et_.set_state(ej_.get_state())
    assert tr.has_open_slots()  # live slots cross over
    back = carry_to_numpy(tr._carry)
    assert len(back["segs"]) == len(jcarry["segs"])
    for a, b in zip(back["segs"], jcarry["segs"]):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    ej, et = [], []
    for lo in range(24, nb, 8):
        ej += jr.process_spectra(spectra[lo:lo + 8])
        et += tr.process_spectra(spectra[lo:lo + 8])
    assert ej
    assert_events_match(et, ej)


SMALL = dict(blocksize=1024, batch_blocks=8, n_channels=16)


@pytest.fixture(scope="module")
def flagship_spectra():
    """The flagship slice's capture (tests/test_torch_slice.py), framed
    and transformed by the golden front end: 5 batches and 3 rows."""
    cfg = _flagship(**SMALL)
    x = capture(cfg, n_batches=6, tail=0)
    blocks, _ = golden_overlap_save(x.astype(np.complex128), cfg.blocksize,
                                    cfg.ovllen)
    return golden_forward_fft(blocks).astype(np.complex64)[:43]


def test_process_spectra_matches_jax(flagship_spectra):
    """FrequencyDomainChannelizer.process_spectra on ragged row counts,
    then flush (the 3-row tail padded with silent rows, and the finalize
    pass on silent spectra): streams, segment powers and events."""
    spectra = flagship_spectra
    jf = JaxFDC(jax_flagship(**SMALL, native_emission=False))
    tf = FrequencyDomainChannelizer(_flagship(**SMALL), device="cpu")
    cuts = [0, 5, 16, 19, 40, 43]
    rj = [jf.process_spectra(spectra[a:b]) for a, b in zip(cuts, cuts[1:])]
    rt = [tf.process_spectra(spectra[a:b]) for a, b in zip(cuts, cuts[1:])]
    assert len(tf._pending_spec) == len(jf._pending_spec) == 3
    rj.append(jf.flush())
    rt.append(tf.flush())
    assert rt[-1].blocks_processed == 3
    for a, b in zip(rt, rj):
        assert a.blocks_processed == b.blocks_processed
        for ca, cb in zip(a.throughput, b.throughput):
            assert ca.shape == cb.shape
            assert_close_to_max(ca, cb, RTOL, ATOL, "throughput stream")
        for pa, pb in zip(a.segment_power, b.segment_power):
            assert pa.shape == pb.shape
            assert_close_to_max(pa, pb, 0.0, 1e-5, "segment power")
    ej = [e for r in rj for e in r.events]
    et = [e for r in rt for e in r.events]
    assert {meta(e)["ID"].split(".")[0] for e in ej} == {"PowActChan",
                                                         "DETECTED"}
    assert_events_match(et, ej)
    assert not tf._open_bursts()


def test_process_spectra_equals_process():
    """Spectra framed and transformed by the port's own front end
    (frame_blocks + forward_spectrum on the configuration's route)
    through process_spectra give the step outputs and events of process()
    on the samples."""
    cfg = _flagship(**SMALL)
    x = capture(cfg, n_batches=3, tail=0)
    a = FrequencyDomainChannelizer(cfg, device="cpu")
    b = FrequencyDomainChannelizer(cfg, device="cpu")
    blocks, _ = frame_blocks(torch.from_numpy(x),
                             torch.zeros(cfg.ovllen, dtype=torch.complex64),
                             cfg.blocksize)
    spectra = forward_spectrum(blocks, use_mxu=cfg.use_mxu_fft)
    ca, cb = a._device_init(), b._device_init()
    bs, bb = a.batch_samples, cfg.batch_blocks
    for step in range(3):
        ca, oa = a._device_step(ca, torch.from_numpy(x[step * bs:
                                                       (step + 1) * bs]),
                                step * bb)
        cb, ob = b._device_step_spectra(cb, spectra[step * bb:
                                                    (step + 1) * bb],
                                        step * bb)
        assert_outputs_match(ob, oa, f"step {step}")
    # whole batches: the same events (the end-of-stream silence differs
    # between the modes: zero samples still carry the capture's last
    # ovllen samples into the first silent block, zero spectra do not)
    a.reset()
    b.reset()
    ea = a.process(x).events
    eb = b.process_spectra(spectra.numpy()).events
    assert ea
    assert_events_match(eb, ea)
    assert b.flush().blocks_processed == 0


def test_mixed_entry_points_raise():
    """One entry point per stream; reset() starts a new one."""
    cfg = _flagship(blocksize=256, batch_blocks=4, n_channels=4)
    f = FrequencyDomainChannelizer(cfg, device="cpu")
    f.process(np.zeros(100, np.complex64))
    with pytest.raises(RuntimeError, match="process_spectra"):
        f.process_spectra(np.zeros((2, cfg.blocksize), np.complex64))
    f.reset()
    f.process_spectra(np.zeros((5, cfg.blocksize), np.complex64))
    with pytest.raises(RuntimeError, match="process\\(\\)"):
        f.process(np.zeros(100, np.complex64))
    with pytest.raises(ValueError, match="spectra must be"):
        f.process_spectra(np.zeros((2, cfg.blocksize + 1), np.complex64))
    res = f.flush()
    assert res.blocks_processed == 1
    f.reset()
    assert f.process(np.zeros(f.batch_samples, np.complex64)
                     ).blocks_processed == 4
    # a malformed first call leaves the stream open to either entry point
    f.reset()
    for bad in (np.zeros(cfg.blocksize, np.complex64),
                np.zeros((2, cfg.blocksize + 1), np.complex64)):
        with pytest.raises(ValueError, match="spectra must be"):
            f.process_spectra(bad)
    assert f._carry is None
    assert f.process(np.zeros(f.batch_samples, np.complex64)
                     ).blocks_processed == 4


def test_vcm_construction_contract():
    """The card is the default device (no CPU fallback), the runner takes
    the native emitters when asked, and the block length is a power of
    two (as the JAX package checks)."""
    kw = dict(SCENES["golden"][0])
    if torch.cuda.is_available():
        assert ActivityDetectionChannelizer(**kw).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ActivityDetectionChannelizer(**kw)
    adc = ActivityDetectionChannelizer(**kw, device="cpu")
    assert isinstance(adc, torch.nn.Module)
    assert all(sd.vcm for sd in adc.segments)
    from fdc_tpu_torch.runtime.emission import (
        NativeSegmentDetectionEmitter,
    )

    assert all(isinstance(em, NativeSegmentDetectionEmitter)
               for em in adc.make_runner(native_emission=True).emitters)
    with pytest.raises(ValueError, match="Blocklen"):
        ActivityDetectionChannelizer(**{**kw, "blocklen": 500},
                                     device="cpu")


def test_vcm_slots_take_the_fft_route(monkeypatch):
    """fdc_tpu's vcm detector builds its segments with SegmentDetector's
    default use_mxu=False, so its slots extract through jnp.fft: the
    port's take torch.fft (``interp_subband_ifft``, counted) and never
    the slot product (``interp_subband_ifft_mxu``), and its events equal
    fdc_tpu's."""
    from fdc_tpu_torch.ops import extract

    calls = {"fft": 0}
    fft_route = extract.interp_subband_ifft

    def counted(*a, **k):
        calls["fft"] += 1
        return fft_route(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("the vcm detector called the slot product")

    monkeypatch.setattr(extract, "interp_subband_ifft", counted)
    monkeypatch.setattr(extract, "interp_subband_ifft_mxu", refuse)
    kw, maxblocks, (nb, carriers) = SCENES["golden"]
    spectra = make_spectra(nb, kw["blocklen"], kw["relinvovl"], carriers)
    jr, tr = runners(kw, maxblocks)
    assert not any(sd.use_mxu for sd in tr.adc.segments)
    ej, et = [], []
    for lo in range(0, nb, 8):
        ej += jr.process_spectra(spectra[lo:lo + 8])
        et += tr.process_spectra(spectra[lo:lo + 8])
    assert len(ej) >= 2
    assert_events_match(et, ej)
    # one slot extraction a segment a batch
    assert calls["fft"] == len(kw["segments"]) * (-(-nb // 8))
