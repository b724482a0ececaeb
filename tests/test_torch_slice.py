"""The whole flagship-shaped slice of fdc_tpu_torch against fdc_tpu.

``_flagship(blocksize=1024, batch_blocks=8, n_channels=16)`` — the main
path's structure (throughput bucket with the measures riding kernel A,
burst channel over spec_ext, one exact-mode detection segment with a
compacted slot extraction) at a CPU-friendly size. The port runs on the
CPU, i.e. through the kernels' plain versions; the JAX package runs its
own CPU path (XLA + lax.scan). Inputs are made with numpy from a seed.

Tolerances (ROADMAP "How a part is held"):
- flags, slot tables, plans, counters, event metadata: exact;
- streams and extractions: rtol 2e-4 / atol 2e-5 of each tensor's max;
- powers: 1e-5 of each tensor's max. The port sums |X|^2 through a mask
  matmul, the JAX CPU path through cell/band reduces (another
  accumulation order, ~1e-7 relative), and the two forward FFTs (torch's
  and the JAX package's four-step matmul form) round differently at
  ~1e-7 of the spectrum's scale — for cells 40 dB below the strongest
  that is more than 1e-5 of their own value, so the bound is taken
  against each tensor's max, like the streams'. tests/test_torch_ops.py
  holds the measures to rtol 1e-5 elementwise on a common spectrum.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from __graft_entry__ import _flagship as jax_flagship
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.utils.cplx import c2f_host
from fdc_tpu_torch import FrequencyDomainChannelizer
from fdc_tpu_torch.convert import carry_from_numpy, carry_to_numpy
from fdc_tpu_torch.flagship import _flagship

RTOL, ATOL, PRTOL = 2e-4, 2e-5, 1e-5
SMALL = dict(blocksize=1024, batch_blocks=8, n_channels=16)


def capture(cfg, n_batches, tail, seed=0):
    """Noise, exact-bin tones in two throughput channels, an on/off
    carrier in the burst band and multi-tone carriers appearing and
    vanishing in the detection segment. Carrier-to-noise ratios are
    ~50 dB, so no power ratio sits near a threshold except by noise."""
    rng = np.random.default_rng(seed)
    n = cfg.blocksize
    blk = cfg.batch_blocks * cfg.inplen
    n_samples = n_batches * blk + tail

    def periodic(bins, amps):
        spec = np.zeros(n, np.complex128)
        spec[np.asarray(bins) % n] = amps
        return np.resize(np.fft.ifft(spec) * n, n_samples)

    def gate(a, b):
        g = np.zeros(n_samples)
        g[int(a * blk):int(b * blk)] = 1.0
        return g

    x = 0.01 * (rng.standard_normal(n_samples)
                + 1j * rng.standard_normal(n_samples))
    x += periodic([-300, 120], [1.0, 1.0])
    x += gate(0.6, 2.3) * periodic([int(-0.45 * n)], [0.5])
    seg_lo = int(0.91 * n) - n // 2
    for off, a, b in ((4, 0.3, 1.7), (40, 1.2, 3.6), (62, 3.1, 4.4)):
        ph = np.exp(1j * rng.uniform(0, 2 * np.pi, 12))
        x += gate(a, b) * periodic(seg_lo + off + np.arange(12), 0.3 * ph)
    return x.astype(np.complex64)


def flatten(tree, pre=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{pre}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{pre}/{i}"))
    elif isinstance(tree, torch.Tensor):
        out[pre] = tree.numpy()
    else:
        out[pre] = np.asarray(tree)
    return out


def assert_close_to_max(got, ref, rtol, atol, what):
    got = np.asarray(got, np.complex128)  # real or complex inputs
    ref = np.asarray(ref, np.complex128)
    scale = np.max(np.abs(ref)) if ref.size else 0.0
    err = np.abs(got - ref)
    assert np.all(err <= atol * scale + rtol * np.abs(ref)), (
        f"{what}: max abs err {err.max()} (scale {scale})"
    )


def assert_outputs_match(port_out, jax_out, what):
    """The step-output contract, key by key."""
    fp, fj = flatten(port_out), flatten(jax_out)
    assert fp.keys() == fj.keys(), set(fp) ^ set(fj)
    for k in fj:
        a, b = fp[k], fj[k]
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
        elif k.endswith("/power"):
            assert_close_to_max(a, b, 0.0, PRTOL, f"{what} {k}")
        else:
            assert_close_to_max(a, b, RTOL, ATOL, f"{what} {k}")


def meta(ev):
    d = ev.to_dict()
    d["ID"] = d["ID"].split(".", 1)[1]  # drop the timestamp prefix
    return d


def assert_events_match(port_events, jax_events):
    """Metadata exact; the samples of all events compared as one stream
    (the FFT rounding differences scale with the capture, not with each
    burst's own level)."""
    assert [meta(e) for e in port_events] == [meta(e) for e in jax_events]
    assert_close_to_max(np.concatenate([e.data for e in port_events]),
                        np.concatenate([e.data for e in jax_events]),
                        RTOL, ATOL, "event samples")


def jax_step(fdc, carry, chunk, t0):
    return fdc._jit_step(carry, jnp.asarray(c2f_host(chunk)), jnp.int32(t0))


@pytest.fixture(scope="module")
def pair():
    jf = JaxFDC(jax_flagship(**SMALL, native_emission=False))
    tf = FrequencyDomainChannelizer(_flagship(**SMALL), device="cpu")
    return jf, tf


@pytest.fixture(scope="module")
def x(pair):
    return capture(pair[1].config, n_batches=5, tail=1500)


def test_slice_step_outputs_match_jax(pair, x):
    jf, tf = pair
    bs = tf.batch_samples
    jc, tc = jf._jit_init(), tf._device_init()
    active_seen = 0
    for step in range(5):
        chunk = x[step * bs:(step + 1) * bs]
        t0 = step * tf.config.batch_blocks
        jc, jo = jax_step(jf, jc, chunk, t0)
        tc, to = tf._device_step(tc, torch.from_numpy(chunk), t0)
        assert_outputs_match(to, jo, f"step {step}")
        assert_outputs_match(carry_to_numpy(tc), jc, f"carry {step}")
        active_seen += int(np.asarray(jo["seg0"]["activated"]).sum())
    assert active_seen >= 3  # the segment carriers were detected


def test_slice_process_flush_match_jax(pair, x):
    jf, tf = pair
    jf.reset()
    tf.reset()
    rj = [jf.process(x[:20000]), jf.process(x[20000:]), jf.flush()]
    rt = [tf.process(x[:20000]), tf.process(x[20000:]), tf.flush()]
    ej = [e for r in rj for e in r.events]
    et = [e for r in rt for e in r.events]
    assert_events_match(et, ej)
    kinds = {meta(e)["ID"].split(".")[0] for e in ej}
    assert kinds == {"PowActChan", "DETECTED"}
    for a, b in zip(rt, rj):
        assert a.blocks_processed == b.blocks_processed
        for ca, cb in zip(a.throughput, b.throughput):
            assert ca.shape == cb.shape
            assert_close_to_max(ca, cb, RTOL, ATOL, "throughput stream")
        for pa, pb in zip(a.segment_power, b.segment_power):
            assert_close_to_max(pa, pb, 0.0, PRTOL, "segment power")


def test_handover_from_jax_carry(pair, x):
    """Two JAX steps, then both continue from the JAX carry (converted
    through fdc_tpu_torch.convert) and host emitter state."""
    jf, tf = pair
    bs = tf.batch_samples
    jf.reset()
    tf.reset()
    jf.process(x[:2 * bs])
    tf.reset()
    tf._carry = carry_from_numpy(
        {k: np.asarray(v) if not isinstance(v, dict)
         else {kk: np.asarray(vv) for kk, vv in v.items()}
         for k, v in jf._carry.items()},
        "cpu",
    )
    tf._t0 = jf._t0
    tf.power_emitter.set_state(jf.power_emitter.get_state())
    for et, ej in zip(tf.segment_emitters, jf.segment_emitters):
        et.set_state(ej.get_state())
    assert tf._carry["seg0"]["active"].any()  # live slots cross over
    jc, tc = jf._carry, tf._carry
    for step in range(2, 4):
        chunk = x[step * bs:(step + 1) * bs]
        t0 = step * tf.config.batch_blocks
        jc, jo = jax_step(jf, jc, chunk, t0)
        tc, to = tf._device_step(tc, torch.from_numpy(chunk), t0)
        assert_outputs_match(to, jo, f"handover step {step}")
    ej = jf.process(x[2 * bs:]).events + jf.flush().events
    et = tf.process(x[2 * bs:]).events + tf.flush().events
    assert_events_match(et, ej)


@pytest.mark.parametrize("overrides", [
    # B % R != 0: the unfolded phase path, no detection consumers
    dict(activity_controlled_channels=[], activity_detection_segments=[],
         batch_blocks=6),
    # segments without a burst bank: kernel C with no burst chain
    dict(activity_controlled_channels=[]),
    # no throughput bucket: the measures come from the |X|^2 reduces
    dict(throughput_channels=[]),
    # bounded detection (max_candidates > 0), every slot row shipped
    dict(throughput_channels=[], activity_controlled_channels=[],
         max_candidates=4, extract_budget=0),
    # burst bank without segments: the burst chain in kernel D
    dict(activity_detection_segments=[]),
    # a burst channel as wide as the throughput channels: their fused
    # bucket has per-channel windows (kernel E)
    dict(activity_controlled_channels=[(-0.45, 0.045)]),
], ids=["throughput-only", "no-burst", "no-throughput", "bounded-k",
        "powact-only", "fused-width"])
def test_other_configs_match_jax(overrides):
    """Configs off the flagship that the ported path covers: step
    outputs over 3 steps, then process + flush events."""
    kw = dict(SMALL, **overrides)
    jf = JaxFDC(jax_flagship(**kw, native_emission=False))
    tf = FrequencyDomainChannelizer(_flagship(**kw), device="cpu")
    x = capture(tf.config, n_batches=4, tail=700)
    bs = tf.batch_samples
    jc, tc = jf._jit_init(), tf._device_init()
    for step in range(3):
        chunk = x[step * bs:(step + 1) * bs]
        t0 = step * tf.config.batch_blocks
        jc, jo = jax_step(jf, jc, chunk, t0)
        tc, to = tf._device_step(tc, torch.from_numpy(chunk), t0)
        assert_outputs_match(to, jo, f"step {step}")
    jf.reset()
    ej = jf.process(x).events + jf.flush().events
    et = tf.process(x).events + tf.flush().events
    assert bool(ej) == bool(tf.config.activity_detection_segments
                            or tf.config.activity_controlled_channels)
    if ej:
        assert_events_match(et, ej)


def test_convert_roundtrip(pair):
    jf, tf = pair
    carry = jf._jit_init()
    as_np = {k: (np.asarray(v) if not isinstance(v, dict)
                 else {kk: np.asarray(vv) for kk, vv in v.items()})
             for k, v in carry.items()}
    port = carry_from_numpy(as_np, "cpu")
    assert port["hist"].dtype == torch.complex64
    assert port["seg0"]["active"].dtype == torch.bool
    assert port["seg0"]["alloc_counter"].shape == ()
    back = carry_to_numpy(port)
    assert flatten(back).keys() == flatten(as_np).keys()
    for k, v in flatten(as_np).items():
        np.testing.assert_array_equal(flatten(back)[k], v)
        assert flatten(back)[k].dtype == v.dtype
    fresh = flatten(carry_to_numpy(tf._device_init()))
    for k, v in flatten(as_np).items():
        np.testing.assert_array_equal(fresh[k], v, err_msg=k)
        assert fresh[k].dtype == v.dtype, k


def test_construction_contract():
    cfg = _flagship(**SMALL)
    # the card is the default device, with no CPU fallback
    if torch.cuda.is_available():
        assert FrequencyDomainChannelizer(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FrequencyDomainChannelizer(cfg)
    torch.backends.cuda.matmul.allow_tf32 = True
    fdc = FrequencyDomainChannelizer(cfg, device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert isinstance(fdc, torch.nn.Module)
    names = {n for n, _ in fdc.named_buffers()}
    assert {"measure_masks", "throughput.w64_folded",
            "segments.0.window_table", "power_bank.delta"} <= names
    assert not list(fdc.parameters())


def test_port_imports_without_jax():
    """fdc_tpu_torch never imports jax or fdc_tpu: import every module and
    run a step with both blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['fdc_tpu'] = None\n"
        "import pkgutil, importlib, numpy as np\n"
        "import fdc_tpu_torch\n"
        "for m in pkgutil.walk_packages(fdc_tpu_torch.__path__, "
        "'fdc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from fdc_tpu_torch.flagship import _flagship\n"
        "f = fdc_tpu_torch.FrequencyDomainChannelizer(_flagship("
        "blocksize=256, batch_blocks=4, n_channels=4), device='cpu')\n"
        "r = f.process(np.ones(f.batch_samples, np.complex64))\n"
        "assert r.blocks_processed == 4\n"
        "assert not [k for k, m in sys.modules.items() if m is not None "
        "and (k == 'jax' or k.startswith(('jax.', 'jaxlib', 'fdc_tpu.')))]\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
