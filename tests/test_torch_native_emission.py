"""The port's native (C++) emitters against its Python emitters and
against ``fdc_tpu``'s native emitters.

All three emitter sets are fed the same step outputs — the port's
channelizer (or vcm runner) on the CPU, handed over as
``_consume_outputs`` hands them — so they differ only in the emission
layer. The port's engine is ``fdc_tpu``'s ``emission.cc``, copied, so its
events equal ``fdc_tpu``'s native ones bit for bit; on these inputs they
equal the Python emitters' bit for bit too (``tests/test_native_emission.py``
allows the two ``fdc_tpu`` emitters rtol 1e-5, for the engine's float32
phase factors; none was needed here). Metadata is compared without the
timestamped ID prefix. Emitter states saved by one backend load into the
other (one schema for both).
"""

import copy

import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship as jax_flagship
from fdc_tpu.models.activity_detection import (
    ActivityDetectionChannelizer as JaxADC,
)
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.runtime import emission as jax_emission
from fdc_tpu_torch import ActivityDetectionChannelizer
from fdc_tpu_torch import FrequencyDomainChannelizer
from fdc_tpu_torch.flagship import _flagship
from fdc_tpu_torch.models.channelizer import _pairs_to_complex
from fdc_tpu_torch.runtime.compiled import HostMirror, _to_host
from fdc_tpu_torch.runtime import emission

from test_torch_slice import capture, meta
from test_torch_vcm import SCENES, make_spectra

# partial emissions on both kinds of channel
SMALL = dict(blocksize=1024, batch_blocks=8, n_channels=16,
             pow_act_maxblocks=6, act_det_maxblocks=5)


def host_step(out, keys):
    """Step outputs as the emitters get them: numpy, complex extractions
    (each through a mirror of its own, so that every step's stay)."""
    host = {}
    for k in keys:
        o = _to_host(out[k], HostMirror())
        if isinstance(o["extract"], dict):
            o["extract"] = {w: _pairs_to_complex(v)
                            for w, v in o["extract"].items()}
        else:
            o["extract"] = _pairs_to_complex(o["extract"])
        if "extract_narrow" in o:
            o["extract_narrow"] = _pairs_to_complex(o["extract_narrow"])
        host[k] = o
    return host


def emit(emitters, steps, start=0):
    """Feed each step's outputs to the emitters ({key: emitter}, the burst
    bank's ``powact`` first, as the channelizer does); the events in
    emission order."""
    events = []
    for n, (t0, host) in enumerate(steps):
        if n < start:
            continue
        for k, em in emitters.items():
            o = copy.deepcopy(host[k])
            if k == "powact":
                events += em.process_step(o, t0)
            else:
                events += em.process_step(o, o["slot_meta"], t0)
    return events


def assert_same_events(got, ref):
    assert [meta(e) for e in got] == [meta(e) for e in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.data, b.data)


@pytest.fixture(scope="module")
def flagship_steps():
    """The small flagship's step outputs over a capture, and the emitter
    sets: the port's Python and native ones, and fdc_tpu's native ones
    (built from the JAX channelizer's own bank and detectors)."""
    cfg = _flagship(**SMALL, native_emission=False)
    tf = FrequencyDomainChannelizer(cfg, device="cpu")
    x = capture(cfg, n_batches=5, tail=0)
    bs, nb = tf.batch_samples, cfg.batch_blocks
    carry, steps = tf._device_init(), []
    for i in range(len(x) // bs):
        carry, out = tf._device_step(
            carry, torch.from_numpy(x[i * bs:(i + 1) * bs]), i * nb)
        steps.append((i * nb, host_step(out, ["powact", "seg0"])))
    jf = JaxFDC(jax_flagship(**SMALL, native_emission=True))

    def sets(pa_cls, sd_cls, fdc):
        return {"powact": pa_cls(fdc.power_bank, cfg.pow_act_maxblocks,
                                 None, True),
                "seg0": sd_cls(fdc.segments[0], cfg.act_det_maxblocks,
                               None, True)}

    def make(kind):
        if kind == "python":
            return sets(emission.PowerActivationEmitter,
                        emission.SegmentDetectionEmitter, tf)
        if kind == "native":
            return sets(emission.NativePowerActivationEmitter,
                        emission.NativeSegmentDetectionEmitter, tf)
        return sets(jax_emission.NativePowerActivationEmitter,
                    jax_emission.NativeSegmentDetectionEmitter, jf)
    return steps, make


@pytest.fixture(scope="module")
def vcm_steps():
    """The vcm runner's step outputs on the "golden" scene (partial
    emissions, two segments) and the three emitter sets."""
    kw, maxblocks, (nb, carriers) = SCENES["golden"]
    spectra = make_spectra(nb, kw["blocklen"], kw["relinvovl"], carriers)
    runner = ActivityDetectionChannelizer(**kw, device="cpu").make_runner(
        maxblocks=maxblocks, native_emission=False)
    carry, steps = runner._device_init(), []
    for lo in range(0, nb, 8):
        carry, outs = runner._device_step(
            carry, torch.from_numpy(spectra[lo:lo + 8]))
        steps.append((lo, host_step(
            {f"seg{i}": o for i, o in enumerate(outs)},
            [f"seg{i}" for i in range(len(outs))])))
    port_segs = runner.adc.segments
    jax_segs = JaxADC(**kw).segments

    def make(kind):
        cls, segs = {
            "python": (emission.SegmentDetectionEmitter, port_segs),
            "native": (emission.NativeSegmentDetectionEmitter, port_segs),
            "jax-native": (jax_emission.NativeSegmentDetectionEmitter,
                           jax_segs),
        }[kind]
        return {f"seg{i}": cls(sd, maxblocks, None, True)
                for i, sd in enumerate(segs)}
    return steps, make


@pytest.fixture(params=["flagship", "vcm"])
def case(request, flagship_steps, vcm_steps):
    return {"flagship": flagship_steps, "vcm": vcm_steps}[request.param]


def test_native_matches_python_and_fdc_tpu_native(case):
    steps, make = case
    native = emit(make("native"), steps)
    assert len(native) >= 4
    assert any(not e.finalized for e in native)  # partial emissions
    assert_same_events(native, emit(make("jax-native"), steps))
    assert_same_events(native, emit(make("python"), steps))


@pytest.mark.parametrize("direction", ["native-to-python",
                                       "python-to-native"])
def test_emitter_states_cross_load(case, direction):
    """Cut after two steps, with bursts open: the state one backend saves
    continues in the other with the uninterrupted run's events."""
    steps, make = case
    src, dst = direction.split("-to-")
    ref = emit(make(dst), steps)
    first = make(src)
    head = emit(first, steps[:2])
    states = {k: em.get_state() for k, em in first.items()}
    assert any(np.asarray(st["count"]).any() for st in states.values())
    second = make(dst)
    for k, em in second.items():
        em.set_state(states[k])
    tail = emit(second, steps, start=2)
    assert_same_events(head + tail, ref)


def test_native_emission_is_accepted():
    """True and "auto" (g++ builds the engine here) take the native
    emitters, False the Python ones, on the channelizer and the runner."""
    cfg = _flagship(**SMALL)
    auto = FrequencyDomainChannelizer(cfg, device="cpu")
    assert isinstance(auto.power_emitter,
                      emission.NativePowerActivationEmitter)
    assert isinstance(auto.segment_emitters[0],
                      emission.NativeSegmentDetectionEmitter)
    on = FrequencyDomainChannelizer(cfg.replace(native_emission=True),
                                    device="cpu")
    assert isinstance(on.power_emitter,
                      emission.NativePowerActivationEmitter)
    off = FrequencyDomainChannelizer(cfg.replace(native_emission=False),
                                     device="cpu")
    assert isinstance(off.power_emitter, emission.PowerActivationEmitter)
    kw = SCENES["golden"][0]
    adc = ActivityDetectionChannelizer(**kw, device="cpu")
    assert isinstance(adc.make_runner(native_emission=True).emitters[0],
                      emission.NativeSegmentDetectionEmitter)
    assert isinstance(adc.make_runner(native_emission=False).emitters[0],
                      emission.SegmentDetectionEmitter)
