"""Two-tier slot extraction (``extract_width_split``) in fdc_tpu_torch
against fdc_tpu: the split plan with its sentinel rows, the sentinel-safe
slot extraction of both buckets, the detection configurations that use
it (BASELINE configs 4, 5 and 5b, cut to a CPU-friendly size), and the
constructor's validation.

The port runs on the CPU, i.e. through the kernels' plain versions; the
JAX package runs its own CPU path (XLA + lax.scan). Inputs are made with
numpy from a seed. Tolerances (ROADMAP "How a part is held"): plans,
flags, tables and counters exact, extractions rtol 2e-4 / atol 2e-5 of
each tensor's max, powers 1e-5 of the max.

The configurations run at blocksize 1024, B = 8, with ``minchandist``
raised to 0.02 so a detection cell stays 10 bins wide as at the
configurations' own blocksize 4096 (1024 * 0.02 / 2 = 4096 * 0.005 / 2 =
10.24): with 2-bin cells the noise alone crosses the 6 dB ratio threshold
every block.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fdc_tpu.config import ChannelizerConfig as JaxConfig
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.models.segment_detection import SegmentDetector as JaxSD
from fdc_tpu.utils.cplx import c2f_host
from fdc_tpu_torch import ChannelizerConfig, FrequencyDomainChannelizer
from fdc_tpu_torch.flagship import (
    cfg4_segdet,
    cfg5_burst_hunter512,
    cfg5b_burst_hunter_4seg,
)
from fdc_tpu_torch.models.segment_detection import SegmentDetector

from test_torch_slice import (
    assert_close_to_max,
    assert_events_match,
    assert_outputs_match,
)

RTOL, ATOL = 2e-4, 2e-5
SMALL = dict(blocksize=1024, batch_blocks=8, minchandist=0.02)


def make_pair():
    """The port's and the JAX package's detector with 16 slots, 3 wide
    rows at w_cap 512 and 4 narrow rows at 64."""
    args = (0, 1024, 4, 0.1, 0.9, 6.0, 0.02, 0.2)
    kw = dict(channel_deactivation_delay=1, max_slots=16, max_candidates=8,
              max_extract_width=512, extract_budget=3,
              extract_width_split=64, extract_budget_narrow=4)
    return (SegmentDetector(*args, use_mxu=True, **kw),
            JaxSD(*args, use_mxu=True, **kw))


@pytest.mark.parametrize("occupancy,max_wlog2", [
    (0.1, 9), (0.4, 9), (0.8, 9), (0.0, 9), (0.4, 6)])
def test_extract_plan_split_matches_jax(occupancy, max_wlog2):
    """Random [B, S] flags and widths: narrow slots fill their bucket in
    slot order, narrow overflow and wide slots the wide bucket, unfilled
    rows hold the sentinel S, and overflow counts the rest."""
    sd, jsd = make_pair()
    rng = np.random.default_rng(int(occupancy * 10))
    s, nb = sd.max_slots, 6
    got = rng.random((nb, s)) < occupancy / 4
    processed = rng.random((nb, s)) < occupancy
    wlog2 = rng.integers(3, max_wlog2 + 1, s).astype(np.int32)
    ids_n, ids_w, ovf = sd.extract_plan_split(
        torch.from_numpy(got), torch.from_numpy(processed),
        torch.from_numpy(wlog2))
    j_n, j_w, j_ovf = jsd.extract_plan_split(
        jnp.asarray(got), jnp.asarray(processed), jnp.asarray(wlog2))
    np.testing.assert_array_equal(ids_n.numpy(), np.asarray(j_n))
    np.testing.assert_array_equal(ids_w.numpy(), np.asarray(j_w))
    assert ids_n.dtype == ids_w.dtype == torch.int32
    assert ovf.dtype == torch.int32 and ovf.shape == ()
    assert int(ovf) == int(j_ovf)
    need = (got | processed).any(0)
    narrow = need & (wlog2 <= 6)
    if occupancy == 0.0:
        assert (ids_n == s).all() and (ids_w == s).all() and int(ovf) == 0
    if occupancy >= 0.4:
        assert narrow.sum() > 4 and int(ovf) > 0
    if max_wlog2 == 6:
        # every slot is narrow: the overflow of the narrow bucket fills
        # the wide one, the rest is counted
        assert set(ids_w.tolist()) <= set(np.flatnonzero(narrow).tolist())
        assert int(ovf) == need.sum() - 4 - 3


@pytest.mark.parametrize("width", [None, 64])
def test_extract_slots_with_sentinels_matches_jax(width):
    """Both buckets' extraction with sentinel ids and slots wider than the
    bucket (zero rows) against the JAX package's one-hot form."""
    sd, jsd = make_pair()
    rng = np.random.default_rng(5)
    s, rows, n = sd.max_slots, 9, 1024
    wlog2 = rng.integers(0, 10, s).astype(np.int32)
    ext_start = rng.integers(0, n - (1 << wlog2)).astype(np.int32)
    state = {"ext_start": ext_start, "wlog2": wlog2}
    spec = (rng.standard_normal((rows, n))
            + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
    ids = np.array([3, s, 0, int(np.argmax(wlog2)), s, 7], np.int32)
    got = sd.extract_slots(torch.from_numpy(spec),
                           {k: torch.from_numpy(v) for k, v in state.items()},
                           torch.from_numpy(ids), width=width)
    ref = np.asarray(jsd.extract_slots(
        jnp.asarray(spec), {k: jnp.asarray(v) for k, v in state.items()},
        jnp.asarray(ids), width=width, pairs=True))
    assert got.shape == ref.shape == (len(ids), rows, width or 512, 2)
    assert_close_to_max(got.numpy(), ref, RTOL, ATOL, "extract_slots")
    assert not got[1].any() and not got[4].any()  # sentinels
    if width:
        # the widest slot (2^9 > 64) extracts zeros from the narrow bucket
        assert not got[3].any()


def band_capture(cfg, carriers, n_batches, tail, seed=0):
    """Noise and band-limited multi-tone carriers (start bin, width in
    bins, amplitude, on block, off block), each at its own amplitude."""
    rng = np.random.default_rng(seed)
    n = cfg.blocksize
    n_samples = n_batches * cfg.batch_blocks * cfg.inplen + tail
    x = 0.01 * (rng.standard_normal(n_samples)
                + 1j * rng.standard_normal(n_samples))
    for lo, w, amp, on, off in carriers:
        spec = np.zeros(n, np.complex128)
        spec[(lo + np.arange(w)) % n] = amp * np.exp(
            1j * rng.uniform(0, 2 * np.pi, w))
        g = np.zeros(n_samples)
        g[on * cfg.inplen:off * cfg.inplen] = 1.0
        x += g * np.resize(np.fft.ifft(spec) * n, n_samples)
    return x.astype(np.complex64)


def busy_carriers(cfg, n_carriers, seed):
    """Carriers spread over each segment: mostly narrow (<= 30 bins, a
    64-wide extraction) and every fourth wide (80 bins, 128), staggered
    on and off across the capture."""
    rng = np.random.default_rng(seed)
    n = cfg.blocksize
    out = []
    for lo_f, hi_f in cfg.activity_detection_segments:
        lo, hi = int((lo_f + 0.5) * n) + 12, int((hi_f + 0.5) * n) - 12
        slots = np.linspace(lo, hi, n_carriers + 1).astype(int)
        for i in range(n_carriers):
            room = slots[i + 1] - slots[i] - 12
            w = min(80 if i % 4 == 3 else int(rng.integers(12, 30)), room)
            on = int(rng.integers(0, 20))
            out.append((int(slots[i]), w, 0.3 * 1.07 ** i, on,
                        on + int(rng.integers(4, 14))))
    return out


def jax_cfg(cfg):
    return JaxConfig.from_dict({**cfg.to_dict(), "native_emission": False})


@pytest.mark.parametrize("build,overrides,n_carriers", [
    (cfg4_segdet, {}, 12),
    # tight budgets: narrow overflow spills into the wide bucket and
    # needy slots overflow both
    (cfg4_segdet, dict(extract_budget=2, extract_budget_narrow=3), 12),
    (cfg5b_burst_hunter_4seg, {}, 4),
], ids=["cfg4", "cfg4-tight", "cfg5b"])
def test_two_tier_configs_match_jax(build, overrides, n_carriers):
    cfg = build(**SMALL, **overrides)
    jf = JaxFDC(jax_cfg(cfg))
    tf = FrequencyDomainChannelizer(cfg, device="cpu")
    x = band_capture(cfg, busy_carriers(cfg, n_carriers, seed=1),
                     n_batches=4, tail=800)
    bs = tf.batch_samples
    jc, tc = jf._jit_init(), tf._device_init()
    real = {"narrow": 0, "wide": 0, "overflow": 0}
    for step in range(4):
        chunk = x[step * bs:(step + 1) * bs]
        t0 = step * cfg.batch_blocks
        jc, jo = jf._jit_step(jc, jnp.asarray(c2f_host(chunk)),
                              jnp.int32(t0))
        tc, to = tf._device_step(tc, torch.from_numpy(chunk), t0)
        assert_outputs_match(to, jo, f"step {step}")
        for i, sd in enumerate(tf.segments):
            so = to[f"seg{i}"]
            real["narrow"] += int((so["slot_ids_narrow"] < sd.max_slots).sum())
            real["wide"] += int((so["slot_ids"] < sd.max_slots).sum())
            real["overflow"] += int(so["ext_overflow"])
    assert real["narrow"] > 0 and real["wide"] > 0, real
    if overrides:
        assert real["overflow"] > 0, real
    jf.reset()
    ej = jf.process(x).events + jf.flush().events
    et = tf.process(x).events + tf.flush().events
    # every segment finalized some of its carriers
    assert {e.ID.split(".")[2] for e in ej if e.finalized} == {
        str(i) for i in range(len(cfg.activity_detection_segments))}
    assert_events_match(et, ej)


def test_512_slot_table_matches_jax():
    """Config 5's 512-slot table with K = 32 at a small width, as
    tests/test_baseline_configs.py:214-245 runs it: a crowded band."""
    cfg = cfg5_burst_hunter512(blocksize=1024, batch_blocks=2,
                               minchandist=0.002, max_extract_width=128,
                               act_det_threshold=8.0,
                               extract_width_split=32)
    jf = JaxFDC(jax_cfg(cfg))
    tf = FrequencyDomainChannelizer(cfg, device="cpu")
    assert tf.segments[0].max_slots == 512 and tf.segments[0].k_pack == 32
    rng = np.random.default_rng(0)
    n = 2 * tf.batch_samples
    t = np.arange(n)
    x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for i in range(40):
        f = -0.44 + 0.88 * (i + 0.5) / 40
        x += (1.5 + 0.01 * i) * np.exp(2j * np.pi * f * t)
    x = x.astype(np.complex64)
    bs = tf.batch_samples
    jc, tc = jf._jit_init(), tf._device_init()
    for step in range(2):
        chunk = x[step * bs:(step + 1) * bs]
        jc, jo = jf._jit_step(jc, jnp.asarray(c2f_host(chunk)),
                              jnp.int32(step * cfg.batch_blocks))
        tc, to = tf._device_step(tc, torch.from_numpy(chunk),
                                 step * cfg.batch_blocks)
        assert_outputs_match(to, jo, f"step {step}")
    assert int(tc["seg0"]["active"].sum()) >= 8
    assert int(tc["seg0"]["alloc_counter"]) >= 8


@pytest.mark.parametrize("kw,match", [
    (dict(extract_width_split=48, extract_budget_narrow=4), "power of 2"),
    (dict(extract_width_split=512, extract_budget_narrow=4), "power of 2"),
    (dict(extract_width_split=64, extract_budget_narrow=0),
     "extract_budget_narrow"),
])
def test_split_validation_matches_jax(kw, match):
    """The constructor refuses what the JAX package refuses, with its
    messages: a split width that is no power of 2 below
    max_extract_width, or no narrow budget."""
    base = dict(max_extract_width=512)
    with pytest.raises(ValueError, match=match):
        JaxSD(0, 1024, 4, 0.1, 0.9, 6.0, 0.02, 0.2, **base, **kw)
    with pytest.raises(ValueError, match=match):
        SegmentDetector(0, 1024, 4, 0.1, 0.9, 6.0, 0.02, 0.2, **base, **kw)
    with pytest.raises(ValueError, match=match):
        FrequencyDomainChannelizer(cfg4_segdet(**SMALL, **kw), device="cpu")


def test_budget_narrow_clamped_to_slots():
    """Like the wide budget, never more narrow rows than slots."""
    sd = SegmentDetector(0, 1024, 4, 0.1, 0.9, 6.0, 0.02, 0.2, max_slots=6,
                         max_extract_width=512, extract_width_split=64,
                         extract_budget_narrow=40)
    assert sd.extract_budget_narrow == 6


def bench_configs():
    """The `configs` dict of tools/bench_configs.py:main, read from its
    source (the script imports JAX only inside main)."""
    import ast
    import pathlib

    src = (pathlib.Path(__file__).parent.parent / "tools"
           / "bench_configs.py").read_text()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    env = {}
    for node in main.body:
        if isinstance(node, ast.Assign) and node.targets[0].id in (
                "n16", "n32", "configs"):
            exec(compile(ast.Module([node], []), "bench_configs", "exec"),
                 env)
    return {name: kw for name, (_, kw) in env["configs"].items()}


BUILDERS = {
    "cfg1_single_static": "cfg1_single_static",
    "cfg2_dama16": "cfg2_dama16",
    "cfg3_powact32": "powact32",
    "cfg4_segdet": "cfg4_segdet",
    "cfg5_burst_hunter512": "cfg5_burst_hunter512",
    "cfg5b_burst_hunter_4seg": "cfg5b_burst_hunter_4seg",
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_baseline_builders_match_bench_configs(name):
    """fdc_tpu_torch.flagship's builders give tools/bench_configs.py's
    configurations, parameter for parameter; each constructs on the port
    and runs a batch + flush at a cut size."""
    import fdc_tpu_torch.flagship as flagship

    build = getattr(flagship, BUILDERS[name])
    assert build() == ChannelizerConfig(**bench_configs()[name])
    fdc = FrequencyDomainChannelizer(build(blocksize=1024, batch_blocks=8),
                                     device="cpu")
    x = np.zeros(fdc.batch_samples + 100, np.complex64)
    assert fdc.process(x).blocks_processed + fdc.flush().blocks_processed == (
        9)
