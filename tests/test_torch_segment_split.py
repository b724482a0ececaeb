"""Split segments (``segment_splits``) in fdc_tpu_torch against fdc_tpu.

The pieces of the cut reconciliation on seeded states and packs, exactly
equal: ``_recompact_pack``, ``reconcile_split`` (kill, refresh priority,
spawn ownership with the batch-local chain closure) and
``split_foreign_view``. Then whole split channelizers with the
configurations and captures of ``tests/test_segment_split.py``: 2 and 4
parts, carriers inside the cores and on the cuts (the case whose
duplicate slot the kill rule discards), two-tier extraction, two split
segments; step outputs key by key (``killed`` included) and events equal
apart from the ID prefix. Last, ``cfg5s_burst_hunter_split4`` against
``tools/ablate35_tpu.py``'s configuration.

The port runs on the CPU (the kernels' plain versions), the JAX package
its CPU path. Tolerances (ROADMAP "How a part is held"): flags, tables,
plans, packs and ``killed`` exact; extractions rtol 2e-4 / atol 2e-5 of
each tensor's max; powers 1e-5 of the max.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fdc_tpu.config import ChannelizerConfig as JaxConfig
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.utils.cplx import c2f_host
from fdc_tpu_torch import ChannelizerConfig, FrequencyDomainChannelizer
from fdc_tpu_torch.flagship import cfg5s_burst_hunter_split4
from fdc_tpu_torch.models.segment_detection import SegmentDetector

from test_segment_split import _capture, _cfg_two_tier, _mk_cfg
from test_torch_slice import assert_events_match, assert_outputs_match


def jax_cfg(cfg):
    return JaxConfig.from_dict({**cfg.to_dict(), "native_emission": False})


def port_cfg(jcfg):
    return ChannelizerConfig.from_dict(jcfg.to_dict())


def pair(jcfg):
    return (JaxFDC(jcfg.replace(native_emission=False)),
            FrequencyDomainChannelizer(port_cfg(jcfg), device="cpu"))


def random_state(rng, sd, occupancy):
    """A slot table of cell-aligned detection intervals in the part."""
    g = sd.geometry
    s = sd.max_slots
    c0 = rng.integers(0, g.n_cells - 4, s)
    width = rng.integers(2, 5, s)
    ds = (g.start + c0 * g.decimation).astype(np.int32)
    de = (ds + width * g.decimation).astype(np.int32)
    active = rng.random(s) < occupancy
    return {"active": active, "tomb": active & (rng.random(s) < 0.2),
            "det_start": ds, "det_stop": de,
            "ext_start": (ds - 4).astype(np.int32),
            "wlog2": rng.integers(3, 7, s).astype(np.int32),
            "phase": rng.integers(0, 4, s).astype(np.int32),
            "phase_inc": rng.integers(0, 4, s).astype(np.int32),
            "inactive": rng.integers(0, 3, s).astype(np.int32),
            "order": rng.permutation(s).astype(np.int32),
            "alloc_counter": np.int32(s), "dropped": np.int32(0)}


def busy_pack(rng, sd, nb, margin):
    """A part's candidate pack from powers with carriers in its core and
    one in each overlap margin it has (owned by the neighbor)."""
    nc = sd.geometry.n_cells
    p = np.full((nb, nc), 1e-6) + rng.random((nb, nc)) * 2e-7
    p[:, 1:3] += 0.5  # the lower margin (part 0: its own core)
    p[:, nc - 3:nc - 1] += 0.7  # the upper margin
    for _ in range(5):
        c0 = int(rng.integers(margin + 2, nc - margin - 5))
        on = int(rng.integers(0, nb - 1))
        p[on:int(rng.integers(on + 1, nb + 1)),
          c0:c0 + int(rng.integers(2, 4))] += 1.0
    return sd._packed_candidates(torch.from_numpy(p.astype(np.float32)))


def as_torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def as_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("case", range(4))
def test_recompact_pack_matches_jax(case):
    """Random packs and keep masks: the same valid-first int32 pack."""
    jf, tf = pair(_mk_cfg(splits=[(0, 4, 2)]))
    sd, jsd = tf.segments[1], jf.segments[1]
    rng = np.random.default_rng(case)
    k = sd.k_pack
    packed = rng.integers(0, 512, (16, 7 * k)).astype(np.int32)
    keep = rng.random((16, k)) < [0.0, 0.2, 0.6, 1.0][case]
    got = sd._recompact_pack(torch.from_numpy(packed), torch.from_numpy(keep))
    ref = np.asarray(jsd._recompact_pack(jnp.asarray(packed),
                                         jnp.asarray(keep)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # valid-first: the kept count of every row, then zeros
    n_keep = keep.sum(1)
    valid = got.numpy()[:, 2 * k:3 * k]
    assert (valid == (np.arange(k)[None, :] < n_keep[:, None])).all()


@pytest.mark.parametrize("part,occupancy", [(0, 0.3), (1, 0.3), (1, 0.6),
                                            (0, 0.0), (1, 0.0)])
def test_reconcile_split_matches_jax(part, occupancy):
    """Seeded slot tables for both parts of a split with 4 cells of
    overlap (neighbor views built by split_foreign_view), packs from busy
    powers: the same state, pack and killed mask. With slots the kill
    fires; without, the margin carriers' candidates are suppressed."""
    margin = 4
    jf, tf = pair(_mk_cfg(splits=[(0, 2, margin)], max_slots=12,
                          batch_blocks=16).replace(blocksize=2048,
                                                   minchandist=0.005))
    rng = np.random.default_rng(10 + part + int(occupancy * 10))
    states = [random_state(rng, sd, occupancy) for sd in tf.segments]
    if occupancy:
        # a duplicate at the cut: part 1's slot 0 tracks part 0's slot 0
        for st in states:
            st["active"][0], st["tomb"][0] = True, False
        for key in ("det_start", "det_stop", "ext_start"):
            states[1][key][0] = states[0][key][0]
    sd, jsd = tf.segments[part], jf.segments[part]
    packed = busy_pack(rng, sd, 16, margin)
    lo, hi = tf._split_neighbors[part]
    kill_t = [] if lo is None else [
        SegmentDetector.split_foreign_view(as_torch(states[lo]))]
    sup_t = kill_t + ([] if hi is None else [
        SegmentDetector.split_foreign_view(as_torch(states[hi]))])
    kill_j = [] if lo is None else [
        jsd.split_foreign_view(as_jax(states[lo]))]
    sup_j = kill_j + ([] if hi is None else [
        jsd.split_foreign_view(as_jax(states[hi]))])
    for v_t, v_j in zip(sup_t, sup_j):
        for a, b in zip(v_t, v_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    st, pk, killed = sd.reconcile_split(as_torch(states[part]), packed,
                                        kill_t, sup_t)
    jst, jpk, jkilled = jsd.reconcile_split(
        as_jax(states[part]), jnp.asarray(packed.numpy()), kill_j, sup_j)
    np.testing.assert_array_equal(killed.numpy(), np.asarray(jkilled))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jpk))
    for key in jst:
        np.testing.assert_array_equal(np.asarray(st[key]),
                                      np.asarray(jst[key]), err_msg=key)
    k = sd.k_pack
    kept = int((pk[:, 2 * k:3 * k] != 0).sum())
    assert kept <= int((packed[:, 2 * k:3 * k] != 0).sum())
    if occupancy and lo is not None:
        assert killed.any()  # overlaps with the lower part's slots
    if not occupancy:
        # the margin carrier's candidates belong to the neighbor
        assert kept < int((packed[:, 2 * k:3 * k] != 0).sum())


def geometry(sd):
    g = sd.geometry
    return g.start, g.stop, g.width, g.decimation, g.n_cells


def cut_bin(fdc, part=0):
    return fdc.segments[part].core_bins[1]


def scenario(name):
    """(configuration, capture) of the JAX package's split tests."""
    cfg = _mk_cfg(splits=[(0, 4, 2)])
    probe = JaxFDC(cfg)
    n = cfg.blocksize
    if name == "interior4":
        carriers = []
        for p, blk in [(0, 4), (2, 12), (3, 20)]:
            lo, hi = probe.segments[p].core_bins
            carriers.append(((lo + hi) // 2 / n, 2.0, blk, blk + 8))
        return cfg, _capture(cfg, carriers)
    if name == "on-cut":
        return cfg, _capture(cfg, [(cut_bin(probe) / n, 2.0, 8, 20)])
    if name == "race-kill":
        return cfg, _capture(cfg, [(cut_bin(probe) / n, 2.0, 11, 20)])
    if name == "parts2":
        cfg = _mk_cfg(splits=[(0, 2, 2)])
        probe = JaxFDC(cfg)
        lo, hi = probe.segments[1].core_bins
        return cfg, _capture(cfg, [(cut_bin(probe) / n, 2.0, 6, 17),
                                   ((lo + hi) // 2 / n, 1.8, 10, 30)])
    if name == "near-cuts":
        cfg = _mk_cfg(splits=[(0, 4, 3)])
        probe = JaxFDC(cfg)
        g = probe.segments[0].geometry
        rng = np.random.default_rng(11)
        carriers, blk = [], 4
        for sd in probe.segments[:-1]:
            b = sd.core_bins[1] + int(rng.integers(-2 * g.decimation,
                                                   2 * g.decimation))
            carriers.append((b / n, float(rng.uniform(1.5, 2.5)), blk,
                             blk + int(rng.integers(6, 12))))
            blk += 8
        return cfg, _capture(cfg, carriers, n_blocks=48, seed=11)
    if name == "two-tier":
        cfg = _cfg_two_tier(((0, 3, 5),))
        probe = JaxFDC(cfg)
        lo1, hi1 = probe.segments[1].core_bins
        return cfg, _capture(cfg, [(cut_bin(probe) / n, 2.0, 9, 18),
                                   ((lo1 + hi1) // 2 / n, 2.0, 14, 26)])
    assert name == "two-segments"
    cfg = JaxConfig(
        blocksize=512, relinvovl=4,
        activity_detection_segments=[(0.15, 0.45), (0.55, 0.85)],
        act_det_threshold=8.0, minchandist=0.03,
        act_det_deactivation_delay=1, minchanflankpuffer=0.1,
        batch_blocks=8, max_slots=8, segment_splits=((0, 2, 2), (1, 2, 2)))
    probe = JaxFDC(cfg)
    return cfg, _capture(cfg, [(cut_bin(probe, 0) / n, 2.0, 6, 16),
                               (cut_bin(probe, 2) / n, 2.0, 12, 24)])


@pytest.mark.parametrize("name", ["interior4", "on-cut", "race-kill",
                                  "parts2", "near-cuts", "two-tier",
                                  "two-segments"])
def test_split_channelizer_matches_jax(name):
    jcfg, x = scenario(name)
    jf, tf = pair(jcfg)
    assert tf._split_neighbors == jf._split_neighbors
    assert [sd.core_bins for sd in tf.segments] == [
        sd.core_bins for sd in jf.segments]
    assert [geometry(sd) for sd in tf.segments] == [
        geometry(sd) for sd in jf.segments]
    bs, bb = tf.batch_samples, jcfg.batch_blocks
    jc, tc = jf._jit_init(), tf._device_init()
    kills = 0
    for step in range(len(x) // bs):
        chunk = x[step * bs:(step + 1) * bs]
        jc, jo = jf._jit_step(jc, jnp.asarray(c2f_host(chunk)),
                              jnp.int32(step * bb))
        tc, to = tf._device_step(tc, torch.from_numpy(chunk), step * bb)
        assert_outputs_match(to, jo, f"{name} step {step}")
        kills += sum(int(to[f"seg{i}"]["killed"].sum())
                     for i in tf._split_neighbors)
    jf.reset()
    ej = jf.process(x).events + jf.flush().events
    et = tf.process(x).events + tf.flush().events
    assert sum(e.finalized for e in ej) >= 1
    assert_events_match(et, ej)
    if name == "race-kill":
        assert kills >= 1  # the cut's duplicate slot existed and was killed


def ablate35_split_config():
    """The split configuration of tools/ablate35_tpu.py:60-73, read from
    its source (the script imports JAX inside main)."""
    src = (pathlib.Path(__file__).parent.parent / "tools"
           / "ablate35_tpu.py").read_text()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    found = {}
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            name = getattr(node.targets[0], "id", None)
            if name in ("base", "cfg_s"):
                found[name] = {kw.arg: ast.literal_eval(kw.value)
                               for kw in node.value.keywords if kw.arg}
    return {**found["base"], **found["cfg_s"]}


def test_split4_config_matches_ablate35():
    """``cfg5s_burst_hunter_split4()`` is the ablation's configuration,
    parameter for parameter, and constructs four parts of 128 slots on
    the port."""
    assert cfg5s_burst_hunter_split4() == ChannelizerConfig(
        **ablate35_split_config())
    fdc = FrequencyDomainChannelizer(
        cfg5s_burst_hunter_split4(blocksize=1024, batch_blocks=8,
                                  minchandist=0.02), device="cpu")
    assert len(fdc.segments) == 4
    assert all(sd.max_slots == 128 and sd.core_bins for sd in fdc.segments)
    x = np.zeros(fdc.batch_samples + 100, np.complex64)
    assert fdc.process(x).blocks_processed + fdc.flush().blocks_processed == (
        9)
