"""The port's multi-process sharded step: two gloo processes.

``tools_torch/multihost_worker.py`` runs in two processes that join one
``torch.distributed`` process group (a file store under the test's
``tmp_path``: no port to pick and race for under xdist), build a 4x2
mesh of CPU ranks over both and run the sharded step with the time axis
crossing the process boundary: the "basic" and "rich" scenarios of
``tools/multihost_worker.py``. Both processes must print the same events
(their samples' hashes included: every process emits from the same
all-gathered outputs), process 0 holds them against the port's
single-process plain run, and this test holds process 0's pickled
results against ``fdc_tpu``'s plain channelizer on the same config and
capture: event metadata exact, event samples (as one stream) and
throughput streams within rtol 2e-4 / atol 2e-5 of the max, segment
powers within 1e-5 of the max. Also the helpers of
``fdc_tpu_torch.parallel.multihost`` in one process, where they are
no-ops, and ``host_local_batch``'s feed into the sharded step against
``fdc_tpu``'s sharded step on the forced CPU mesh. Counterparts:
tests/test_multihost_twoprocess.py and tests/test_parallel.py's
single-process helper test. The step of a mesh of several processes
is compiled in segments between its gathers, which stage on the host.
"""

import importlib.util
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from fdc_tpu.config import ChannelizerConfig as JaxConfig
from fdc_tpu.models.channelizer import FrequencyDomainChannelizer as JaxFDC
from fdc_tpu_torch.parallel import ShardedChannelizer
from fdc_tpu_torch.parallel.mesh import Mesh
from fdc_tpu_torch.parallel.multihost import (
    global_mesh,
    host_local_batch,
    initialize_multihost,
    process_allgather,
)

from test_torch_pipeline import assert_streams_match, configs, signal
from test_torch_sharded import jax_sharded
from test_torch_slice import assert_outputs_match, jax_step

_WORKER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tools_torch", "multihost_worker.py",
)


def worker_module():
    spec = importlib.util.spec_from_file_location("multihost_worker",
                                                  _WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def outputs(results):
    """(events, throughput streams, segment powers) of a result list."""
    events = [e for r in results for e in r.events]
    tp = [np.concatenate([r.throughput[i] for r in results])
          for i in range(len(results[0].throughput))]
    pw = [np.concatenate([r.segment_power[i] for r in results])
          for i in range(len(results[0].segment_power))]
    return events, tp, pw


@pytest.mark.parametrize("scenario", ["basic", "rich"])
def test_two_processes_match_single(scenario, tmp_path):
    init = f"file://{tmp_path / 'store'}"
    out_file = tmp_path / "results.pkl"
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), "2", init, scenario,
             "--out", str(out_file)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    assert "PROC0 MULTIHOST==SINGLE OK" in outs[0], outs[0][-3000:]
    lines = [[ln.split("EVENTS", 1)[1] for ln in out.splitlines()
              if ln.startswith(f"PROC{pid} EVENTS")]
             for pid, out in enumerate(outs)]
    assert lines[0] and lines[0] == lines[1]

    # process 0's results against fdc_tpu on the same config and capture
    # ("basic" feeds whole batches and is not flushed)
    with open(out_file, "rb") as f:
        results = pickle.load(f)
    mod = worker_module()
    cfg = mod.config(scenario)
    x = mod.capture(cfg, scenario)
    ref = JaxFDC(JaxConfig.from_dict(cfg.to_dict()))
    jres = [ref.process(x)]
    if scenario == "rich":
        jres.append(ref.flush())
    assert_streams_match(outputs(results), outputs(jres))


def test_helpers_in_one_process():
    """One process: no process group, the mesh of this process's ranks,
    the gather the identity with a leading axis."""
    assert initialize_multihost() == 0
    mesh = global_mesh(n_chan=2, devices=["cpu"] * 8)
    assert mesh.shape == {"time": 4, "chan": 2}
    assert (mesh.process_index, mesh.process_count) == (0, 1)
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(process_allgather(a), a[None])
    np.testing.assert_array_equal(process_allgather(a, tiled=True), a)
    t = torch.arange(4, dtype=torch.float32).to(torch.complex64)
    assert torch.equal(process_allgather(t)[0], t)
    with pytest.raises(ValueError, match="not divisible by n_chan=3"):
        global_mesh(n_chan=3, devices=["cpu"] * 8)


def test_host_local_batch_feeds_the_step():
    """fdc_tpu's float-pair feeding format goes straight into the sharded
    step, which equals fdc_tpu's sharded step on the same 4x2 mesh
    shape, output by output."""
    jcfg, pcfg = configs()
    mesh = global_mesh(n_chan=2, devices=["cpu"] * 8)
    sh = ShardedChannelizer(pcfg, mesh=mesh)
    ref = jax_sharded(jcfg, 4, 2)
    x = signal(pcfg, 1, 3)
    xf = np.ascontiguousarray(x).view(np.float32).reshape(-1, 2)
    arr = host_local_batch(mesh, xf)
    assert arr.dtype == torch.complex64 and arr.shape == (len(x),)
    _, out = sh._device_step(sh._device_init(), arr, 0)
    _, jout = jax_step(ref, ref._jit_init(), x, 0)
    assert_outputs_match(out, jout, "step")


def flat(tree, pre=""):
    """A step's output or carry tree as {path: tensor}."""
    if isinstance(tree, dict):
        return {k: v for key, val in tree.items()
                for k, v in flat(val, f"{pre}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, val in enumerate(tree)
                for k, v in flat(val, f"{pre}/{i}").items()}
    return {pre: tree}


@pytest.mark.parametrize("process_count", [1, 2])
def test_step_across_processes_is_compiled_in_segments(process_count,
                                                       monkeypatch):
    """The sharded step yields at each gather across processes; the
    compiled step runs as one graph a segment between them: with several
    processes four gathers a samples step (the history tail, the
    reach-back row, the detection statistics, the outputs), with one
    none. The mesh's process count is set as a process group of two
    would set it; in one process the gathers are the identity. Two
    compiled steps equal the eager ones bit for bit."""
    import fdc_tpu_torch.parallel.sharded as sharded_mod
    from fdc_tpu_torch.parallel.multihost import allgather

    sent = []

    def counted(tensors):
        sent.append(len(tensors))
        return allgather(tensors)

    monkeypatch.setattr(sharded_mod, "allgather", counted)
    _, pcfg = configs()
    models = [ShardedChannelizer(pcfg, mesh=Mesh(
        [["cpu"], ["cpu"]], process_index=0, process_count=process_count))
        for _ in range(2)]
    assert all(m.compile_step for m in models)
    x = signal(pcfg, 2, 3)
    bs = pcfg.batch_blocks * pcfg.inplen
    carries = [m._device_init() for m in models]
    for b in range(2):
        chunk = torch.from_numpy(x[b * bs:(b + 1) * bs])
        del sent[:]
        carries[0], got = models[0]._jit_step(carries[0], chunk,
                                              b * pcfg.batch_blocks)
        assert len(sent) == (4 if process_count > 1 else 0)
        carries[1], ref = models[1]._device_step(carries[1], chunk,
                                                 b * pcfg.batch_blocks)
        rows = pcfg.batch_blocks // process_count
        assert got["seg0"]["power"].shape[0] == rows
        for tree_a, tree_b in ((got, ref), (carries[0], carries[1])):
            fa, fb = flat(tree_a), flat(tree_b)
            assert fa.keys() == fb.keys()
            for k in fa:
                assert torch.equal(fa[k], fb[k]), k
    assert models[0]._jit_step.owns(carries[0])
