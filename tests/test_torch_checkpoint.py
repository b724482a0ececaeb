"""Checkpoint / resume of the port, and files that cross-restore with
``fdc_tpu`` both ways.

A stream is cut mid-batch while a burst is open and a detection slot is
live. The first half runs in one package and is saved; the second half
resumes from the file in the same or the other package. Both halves
together must give the events and streams of ``fdc_tpu``'s uninterrupted
run: metadata exact (apart from the timestamped ID prefix), streams and
event samples (as one stream) within rtol 2e-4 / atol 2e-5 of the max
(ROADMAP's tolerances: the two packages' FFTs round differently). The
port's own resume is bit-exact. The cases: the small flagship (burst
bank + one segment), a segment split into 4 parts with a carrier on a
cut, and the vcm runner. The port keeps its default emitters ("auto":
the native ones), ``fdc_tpu`` its Python ones, so each crossing also
changes emitter backend.
"""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from __graft_entry__ import _flagship as jax_flagship
from fdc_tpu.models.activity_detection import (
    ActivityDetectionChannelizer as JaxADC,
)
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu.runtime import checkpoint as jax_ckpt
from fdc_tpu_torch import (
    ActivityDetectionChannelizer,
    ChannelizerConfig,
    FrequencyDomainChannelizer,
)
from fdc_tpu_torch.runtime import checkpoint as ckpt

from test_torch_segment_split import scenario
from test_torch_slice import (
    ATOL,
    RTOL,
    assert_close_to_max,
    assert_events_match,
    capture,
    meta,
)
from test_torch_vcm import SCENES, make_spectra

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(blocksize=1024, batch_blocks=8, n_channels=16)


def flagship_case():
    jcfg = jax_flagship(**SMALL, native_emission=False)
    pcfg = ChannelizerConfig.from_dict(jcfg.to_dict()).replace(
        native_emission="auto")
    x = capture(pcfg, n_batches=5, tail=1500)
    # mid-batch, inside the burst (batches 0.6-2.3) and the second
    # detection carrier (1.2-3.6)
    return jcfg, pcfg, x, 2 * pcfg.batch_blocks * pcfg.inplen + 777


def split_case():
    jcfg, x = scenario("on-cut")  # 4 parts, a carrier on the first cut
    pcfg = ChannelizerConfig.from_dict(jcfg.to_dict()).replace(
        native_emission="auto")
    return jcfg, pcfg, x, 17 * pcfg.inplen + 100  # carrier on blocks 8-20


CASES = {"flagship": flagship_case, "split": split_case}


def restart(fdc):
    """A new stream on ``fdc``: ``reset()``, and the emitters back to their
    state at construction (``reset()`` keeps their counters, in both
    packages), so that one channelizer a package serves every run."""
    emitters = [fdc.power_emitter, *fdc.segment_emitters]
    if not hasattr(fdc, "_fresh_emitters"):
        fdc._fresh_emitters = [e and e.get_state() for e in emitters]
    fdc.reset()
    for e, st in zip(emitters, fdc._fresh_emitters):
        if e is not None:
            e.set_state(st)


@pytest.fixture(scope="module", params=sorted(CASES))
def stream(request):
    """(JAX channelizer, port channelizer, capture, cut, fdc_tpu's
    uninterrupted result, JAX file at the cut, port file at the cut);
    one channelizer a package, reset between runs (one JAX compile)."""
    jcfg, pcfg, x, cut = CASES[request.param]()
    jf = JaxFDC(jcfg)
    tf = FrequencyDomainChannelizer(pcfg, device="cpu")
    restart(jf)
    restart(tf)
    ref = [jf.process(x), jf.flush()]
    tmp = Path(request.getfixturevalue("tmp_path_factory").mktemp("ckpt"))
    restart(jf)
    head_j = jf.process(x[:cut])
    # the cut holds an open burst (flagship) and a live slot
    assert any(np.asarray(jf._carry[k]["active"]).any()
               for k in jf._carry if k.startswith("seg"))
    if jf.power_emitter is not None:
        assert np.asarray(jf._carry["powact"]["active"]).any()
    jax_ckpt.save_checkpoint(jf, str(tmp / "jax.ckpt"))
    head_t = tf.process(x[:cut])
    ckpt.save_checkpoint(tf, str(tmp / "port.ckpt"))
    return dict(jf=jf, tf=tf, x=x, cut=cut, ref=ref, head_j=head_j,
                head_t=head_t, jax_file=tmp / "jax.ckpt",
                port_file=tmp / "port.ckpt", tmp=tmp)


def assert_stream_matches(parts, ref):
    """Events and throughput streams of the joined parts against the
    uninterrupted reference, within the cross-package tolerances."""
    ev = [e for r in parts for e in r.events]
    ev_ref = [e for r in ref for e in r.events]
    assert sum(e.finalized for e in ev_ref) >= 1
    assert_events_match(ev, ev_ref)
    for ch in range(len(ref[0].throughput)):
        assert_close_to_max(
            np.concatenate([r.throughput[ch] for r in parts]),
            np.concatenate([r.throughput[ch] for r in ref]),
            RTOL, ATOL, f"throughput {ch}")


def test_port_resume_equals_uninterrupted(stream):
    tf, x, cut = stream["tf"], stream["x"], stream["cut"]
    restart(tf)
    full = [tf.process(x), tf.flush()]
    restart(tf)
    ckpt.load_checkpoint(tf, str(stream["port_file"]))
    parts = [stream["head_t"], tf.process(x[cut:]), tf.flush()]
    ev = [e for r in parts for e in r.events]
    ev_full = [e for r in full for e in r.events]
    assert [meta(e) for e in ev] == [meta(e) for e in ev_full]
    for a, b in zip(ev, ev_full):
        np.testing.assert_array_equal(a.data, b.data)
    for ch in range(len(full[0].throughput)):
        np.testing.assert_array_equal(
            np.concatenate([r.throughput[ch] for r in parts]),
            np.concatenate([r.throughput[ch] for r in full]))


def test_jax_saves_port_resumes(stream):
    tf, x, cut = stream["tf"], stream["x"], stream["cut"]
    restart(tf)
    ckpt.load_checkpoint(tf, str(stream["jax_file"]))
    assert tf._t0 == stream["jf"]._t0 and len(tf._pending)
    assert_stream_matches(
        [stream["head_j"], tf.process(x[cut:]), tf.flush()], stream["ref"])


def test_port_saves_jax_resumes(stream):
    jf, x, cut = stream["jf"], stream["x"], stream["cut"]
    restart(jf)
    jax_ckpt.load_checkpoint(jf, str(stream["port_file"]))
    assert_stream_matches(
        [stream["head_t"], jf.process(x[cut:]), jf.flush()], stream["ref"])


def test_file_format_is_fdc_tpus(stream):
    """The port's file has the JAX file's keys, node types, leaf dtypes
    and shapes, and pickles no torch object (it unpickles with torch
    blocked)."""
    def tree(obj):
        if isinstance(obj, dict):
            return {k: tree(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [tree(v) for v in obj]
        if isinstance(obj, np.ndarray):
            return (str(obj.dtype), obj.shape)
        return type(obj).__name__

    with open(stream["jax_file"], "rb") as fh:
        j = pickle.load(fh)
    with open(stream["port_file"], "rb") as fh:
        p = pickle.load(fh)
    assert p.keys() == j.keys()
    for k in ("version", "carry", "carry_iscomplex", "t0", "pending",
              "pending_spec", "spectra_mode", "samples_mode", "host_extra"):
        assert tree(p[k]) == tree(j[k]), k
        if isinstance(p[k], dict):
            assert list(p[k]) == list(j[k]), k  # the same key order
    code = ("import pickle, sys\n"
            "sys.modules['torch'] = None\nsys.modules['jax'] = None\n"
            f"pickle.load(open({str(stream['port_file'])!r}, 'rb'))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


def test_jax_file_loads_without_jax(stream):
    """The card's machine has no JAX: a JAX-written file resumes in a
    process where ``import jax`` and ``import fdc_tpu`` fail, with the
    events the port gives in this process."""
    tf, x, cut, tmp = stream["tf"], stream["x"], stream["cut"], stream["tmp"]
    np.save(tmp / "tail.npy", x[cut:])
    (tmp / "cfg.json").write_text(tf.config.to_json())
    code = (
        "import json, sys\n"
        "sys.modules['jax'] = None\nsys.modules['fdc_tpu'] = None\n"
        "import numpy as np\n"
        "from fdc_tpu_torch import ChannelizerConfig, "
        "FrequencyDomainChannelizer\n"
        "from fdc_tpu_torch.runtime.checkpoint import load_checkpoint\n"
        f"tmp = {str(tmp)!r}\n"
        "cfg = ChannelizerConfig.from_json(open(tmp + '/cfg.json').read())\n"
        "f = FrequencyDomainChannelizer(cfg, device='cpu')\n"
        f"load_checkpoint(f, {str(stream['jax_file'])!r})\n"
        "x = np.load(tmp + '/tail.npy')\n"
        "ev = f.process(x).events + f.flush().events\n"
        "json.dump([e.to_dict() for e in ev], open(tmp + '/ev.json', 'w'))\n"
        "assert not [k for k, m in sys.modules.items() if m is not None "
        "and (k == 'jax' or k.startswith(('jax.', 'jaxlib', 'fdc_tpu.')))]\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    restart(tf)
    ckpt.load_checkpoint(tf, str(stream["jax_file"]))
    ev = tf.process(x[cut:]).events + tf.flush().events
    got = json.loads((tmp / "ev.json").read_text())
    for d in got:
        d["ID"] = d["ID"].split(".", 1)[1]
    assert got == [meta(e) for e in ev]


def test_structure_mismatch_raises(stream, tmp_path):
    cfg = stream["tf"].config
    other = FrequencyDomainChannelizer(
        cfg.replace(max_slots=cfg.max_slots // 2), device="cpu")
    with pytest.raises(ValueError, match="structure"):
        ckpt.load_checkpoint(other, str(stream["jax_file"]))
    with open(stream["port_file"], "rb") as fh:
        state = pickle.load(fh)
    seg = next(k for k in state["carry"] if k.startswith("seg"))
    state["carry"][seg] = tuple(state["carry"][seg].values())  # not a dict
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(pickle.dumps(state))
    with pytest.raises(ValueError, match="structure"):
        ckpt.load_checkpoint(stream["tf"], str(bad))


# -- the vcm runner ------------------------------------------------------


@pytest.fixture(scope="module")
def vcm(tmp_path_factory):
    """The "golden" scene's spectra through fdc_tpu's runner (Python
    emitters) and the port's (native), cut after 16 of 40 blocks with
    slots live; caller-owned ``extra`` leaves ride along."""
    kw, maxblocks, (nb, carriers) = SCENES["golden"]
    spectra = make_spectra(nb, kw["blocklen"], kw["relinvovl"], carriers)
    v = dict(kw=kw, maxblocks=maxblocks,
             chunks=[spectra[lo:lo + 8] for lo in range(0, nb, 8)],
             extra={"histf": np.arange(256, dtype=np.float32).reshape(128, 2),
                    "pending": np.arange(5, dtype=np.complex64)},
             tmp=tmp_path_factory.mktemp("vcm"))
    jr, tr = fresh_runners(v)
    v["ref"] = [e for c in v["chunks"] for e in jr.process_spectra(c)]
    for name, runner, save in (
            ("jax", fresh_runners(v)[0], jax_ckpt.save_vcm_checkpoint),
            ("port", tr, ckpt.save_vcm_checkpoint)):
        v[f"head_{name}"] = [e for c in v["chunks"][:2]
                             for e in runner.process_spectra(c)]
        assert runner.has_open_slots()
        save(runner, str(v["tmp"] / f"{name}.ckpt"), extra=v["extra"])
    return v


def fresh_runners(v):
    """A new runner of each package (fdc_tpu's with its Python emitters,
    the port's with its default, native ones)."""
    jr = JaxADC(**v["kw"]).make_runner(maxblocks=v["maxblocks"],
                                       native_emission=False)
    tr = ActivityDetectionChannelizer(**v["kw"], device="cpu").make_runner(
        maxblocks=v["maxblocks"])
    return jr, tr


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax",
                                       "port-to-port"])
def test_vcm_checkpoint_cross_restores(vcm, direction):
    src, dst = direction.split("-to-")
    jr, tr = fresh_runners(vcm)
    runner, load = ((tr, ckpt.load_vcm_checkpoint) if dst == "port"
                    else (jr, jax_ckpt.load_vcm_checkpoint))
    extra = load(runner, str(vcm["tmp"] / f"{src}.ckpt"))
    np.testing.assert_array_equal(extra["histf"], vcm["extra"]["histf"])
    np.testing.assert_array_equal(extra["pending"], vcm["extra"]["pending"])
    assert runner.has_open_slots()
    tail = [e for c in vcm["chunks"][2:] for e in runner.process_spectra(c)]
    head = vcm[f"head_{src}"]
    assert len(vcm["ref"]) >= 2
    assert_events_match(head + tail, vcm["ref"])


def test_vcm_structure_mismatch_raises(vcm, tmp_path):
    kw = dict(vcm["kw"], segments=vcm["kw"]["segments"][:1])
    one = ActivityDetectionChannelizer(**kw, device="cpu").make_runner()
    with pytest.raises(ValueError, match="structure"):
        ckpt.load_vcm_checkpoint(one, str(vcm["tmp"] / "jax.ckpt"))
    with open(vcm["tmp"] / "jax.ckpt", "rb") as fh:
        state = pickle.load(fh)
    # a tuple where the JAX carry has a list is another structure
    state["carry"]["segs"] = tuple(state["carry"]["segs"])
    state["carry_iscomplex"]["segs"] = tuple(
        state["carry_iscomplex"]["segs"])
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(pickle.dumps(state))
    _, tr = fresh_runners(vcm)
    with pytest.raises(ValueError, match="structure"):
        ckpt.load_vcm_checkpoint(tr, str(bad))
    plain = tmp_path / "plain.ckpt"  # a channelizer's file, no "kind"
    plain.write_bytes(pickle.dumps({"version": 1, "carry": {}}))
    with pytest.raises(ValueError, match="not a vcm runner"):
        ckpt.load_vcm_checkpoint(tr, str(plain))
