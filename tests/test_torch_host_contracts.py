"""Host-side contracts of fdc_tpu_torch held against fdc_tpu:
``msgoutput=False`` and ``flush(finalize=False)``.

- ``msgoutput=False`` (``tests/test_msgoutput.py``): ``process`` returns
  no events while the file sink writes the same files as with
  ``msgoutput=True`` (and as ``fdc_tpu`` with ``msgoutput=False``), with
  the Python and the native emitters; a checkpoint taken under
  ``msgoutput=False`` resumes into ``msgoutput=True`` with the events of
  an always-on run, and of ``fdc_tpu``'s always-on run.
- ``flush(finalize=False)`` (``tests/test_finalize.py``): the tail-only
  contract (no finalize batches, open bursts stay open) and, with
  ``finalize=True``, the same finalize events as ``fdc_tpu`` whether the
  capture ends on a batch boundary or not.

Event metadata exact; samples and file contents rtol 2e-4 / atol 2e-5 of
the max between the packages (the FFTs round differently), exact
between two runs of the port.
"""

import numpy as np
import pytest

from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu_torch import ChannelizerConfig, FrequencyDomainChannelizer
from fdc_tpu_torch.runtime import native
from fdc_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint

import test_finalize
import test_msgoutput
from test_torch_slice import ATOL, RTOL, assert_close_to_max, meta

NATIVE_MODES = [False, True]


def need_native(use_native):
    if use_native and not native.available():
        pytest.skip("the native emitters need g++")


def pair(module, **kw):
    """(fdc_tpu's channelizer, the port's) of a JAX test module's config."""
    jcfg = module.config(**kw)
    return (JaxFDC(jcfg), FrequencyDomainChannelizer(
        ChannelizerConfig.from_dict(jcfg.to_dict()), device="cpu"))


def assert_same_events(got, ref):
    assert [meta(e) for e in got] == [meta(e) for e in ref]
    for a, b in zip(got, ref):
        assert a.part == b.part and a.finalized == b.finalized
        assert_close_to_max(a.data, b.data, RTOL, ATOL, meta(b)["ID"])


def inventory(d):
    """{file name without its timestamp: samples}."""
    return {f.name.split(".", 1)[1]: np.fromfile(f, np.complex64)
            for f in sorted(d.iterdir())}


@pytest.mark.parametrize("use_native", NATIVE_MODES)
def test_msgoutput_off_returns_no_events_writes_same_files(tmp_path,
                                                           use_native):
    need_native(use_native)
    dirs = {k: tmp_path / k for k in ("on", "off", "jax_off")}
    for d in dirs.values():
        d.mkdir()
    x = test_msgoutput.make_signal(8 * 8 * 192)
    runs = {}
    for key, msg in (("on", True), ("off", False), ("jax_off", False)):
        jf, tf = pair(test_msgoutput, native_emission=use_native,
                      fileoutput=True, msgoutput=msg,
                      outputpath=str(dirs[key]))
        model = jf if key.startswith("jax") else tf
        runs[key] = model.process(x).events
    assert len(runs["on"]) > 2, "the scenario emits bursts"
    assert runs["off"] == [] and runs["jax_off"] == []
    inv = {k: inventory(d) for k, d in dirs.items()}
    assert set(inv["on"]) == set(inv["off"]) == set(inv["jax_off"])
    assert inv["on"]
    for name in inv["on"]:
        np.testing.assert_array_equal(inv["off"][name], inv["on"][name])
        assert_close_to_max(inv["off"][name], inv["jax_off"][name], RTOL,
                            ATOL, name)


@pytest.mark.parametrize("use_native", NATIVE_MODES)
def test_msgoutput_off_checkpoint_resumes_into_on(tmp_path, use_native):
    need_native(use_native)
    jf, ref = pair(test_msgoutput, native_emission=use_native,
                   msgoutput=True)
    n = 8 * ref.batch_samples
    x = test_msgoutput.make_signal(n)
    half = n // 2 + 17
    ref.process(x[:half])
    ev_ref = ref.process(x[half:]).events
    jf.process(x[:half])
    ev_jax = jf.process(x[half:]).events
    assert ev_ref, "the second half emits events"

    _, a = pair(test_msgoutput, native_emission=use_native, msgoutput=False)
    assert a.process(x[:half]).events == []
    save_checkpoint(a, str(tmp_path / "s.ckpt"))
    _, b = pair(test_msgoutput, native_emission=use_native, msgoutput=True)
    load_checkpoint(b, str(tmp_path / "s.ckpt"))
    ev_tail = b.process(x[half:]).events
    assert [meta(e) for e in ev_tail] == [meta(e) for e in ev_ref]
    for p, q in zip(ev_ref, ev_tail):
        assert p.part == q.part and p.finalized == q.finalized
        np.testing.assert_array_equal(p.data, q.data)
    assert_same_events(ev_tail, ev_jax)


def test_flush_finalize_false_keeps_tail_only_contract():
    jf, tf = pair(test_finalize)
    x = test_finalize.burst_to_end(4 * tf.batch_samples)  # aligned
    assert_same_events(tf.process(x).events, jf.process(x).events)
    res, res_j = tf.flush(finalize=False), jf.flush(finalize=False)
    assert res.events == [] and res_j.events == []
    assert res.blocks_processed == res_j.blocks_processed == 0
    assert tf._open_bursts() and jf._open_bursts()
    # the open bursts finalize on a later flush, as fdc_tpu's do
    assert_same_events(tf.flush().events, jf.flush().events)
    assert not tf._open_bursts()


@pytest.mark.parametrize("extra_samples", [0, 37])
def test_flush_finalize_false_on_a_ragged_tail(extra_samples):
    """A ragged tail is still processed (zero-padded, trimmed) without the
    finalize batches; its events and streams equal fdc_tpu's."""
    jf, tf = pair(test_finalize, throughput_channels=[(-0.25, 0.04)])
    n = 4 * tf.batch_samples + extra_samples
    x = test_finalize.burst_to_end(n)
    assert_same_events(tf.process(x).events, jf.process(x).events)
    res, res_j = tf.flush(finalize=False), jf.flush(finalize=False)
    assert res.blocks_processed == res_j.blocks_processed
    assert_same_events(res.events, res_j.events)
    for a, b in zip(res.throughput, res_j.throughput):
        assert a.shape == b.shape
        if b.size:
            assert_close_to_max(a, b, RTOL, ATOL, "tail stream")
    assert tf._open_bursts() == jf._open_bursts()


@pytest.mark.parametrize("extra_samples", [0, 1, 37])
def test_flush_finalize_true_matches_jax(extra_samples):
    jf, tf = pair(test_finalize)
    x = test_finalize.burst_to_end(4 * tf.batch_samples + extra_samples)
    got = tf.process(x).events + tf.flush().events
    ref = jf.process(x).events + jf.flush().events
    assert any(e.finalized for e in ref)
    assert_same_events(got, ref)
    assert not tf._open_bursts()
