"""One process of a multi-process sharded channelizer run, checked against
a single-process plain run.

The counterpart of ``tools/multihost_worker.py`` for ``fdc_tpu_torch``:
N processes join a ``torch.distributed`` process group (gloo, host-staged
tensors), build the same global (time, chan) mesh over their own ranks
(four a process, two chan ranks: a 4x2 mesh over two processes) and run
the sharded step; the history tail, the reach-back row, the detection
statistics and the step outputs cross the process boundary through the
group. Every process prints its events; process 0 also runs the plain
channelizer over the same capture and checks its events (metadata
exact, samples within rtol 2e-4 / atol 2e-5 of the max) and throughput
streams against the sharded run's.

    python tools_torch/multihost_worker.py PROCESS_ID N_PROCESSES \\
        INIT_METHOD [basic|rich] [--cuda] [--eager] [--config CFG.json
        --capture CAP.c64] [--out RESULTS.pkl]

``INIT_METHOD``: ``file:///path/to/store`` (a file every process can
reach, created anew for each run) or ``tcp://127.0.0.1:PORT``.
``basic``: one throughput channel and one segment; each process feeds its
contiguous half of every batch (``host_local_batch``) to the step.
``rich``: multi-channel buckets, a fused throughput + burst family and two
segments, whose scans each own a chan rank; every process reads the
whole capture through ``process()`` / ``flush()``. ``--config`` and
``--capture`` (a config JSON and a raw complex64 file) replace the
scenario's, read whole as in "rich". ``--cuda``: the ranks are streams of
the first CUDA device (else CPU ranks, the kernels' plain versions); the
kernels' launch counts, the wall and the step's graphs (one a segment
between the gathers across processes) are printed. ``--eager``: the
step's eager opt-out (``compile_step``). ``--out``: process 0 pickles
its results (``ProcessResult`` list) there.
"""

import argparse
import hashlib
import os
import pickle
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fdc_tpu_torch import ChannelizerConfig, FrequencyDomainChannelizer  # noqa: E402
from fdc_tpu_torch.parallel import ShardedChannelizer  # noqa: E402
from fdc_tpu_torch.parallel.multihost import (  # noqa: E402
    global_mesh,
    host_local_batch,
    initialize_multihost,
    process_count,
)

RTOL, ATOL = 2e-4, 2e-5


def config(scenario):
    if scenario == "rich":
        return ChannelizerConfig(
            blocksize=256, relinvovl=4,
            throughput_channels=[(-0.2, 0.05), (-0.35, 0.05), (0.05, 0.02)],
            activity_controlled_channels=[(0.45, 0.05)],
            act_contr_threshold=10.0,
            activity_detection_segments=[(0.1, 0.28), (0.3, 0.42)],
            act_det_threshold=8.0, minchandist=0.02,
            freqmode="basebandfs", batch_blocks=8,
        )
    return ChannelizerConfig(
        blocksize=256, relinvovl=4,
        throughput_channels=[(-0.2, 0.05)],
        activity_detection_segments=[(0.1, 0.4)],
        act_det_threshold=8.0, minchandist=0.02,
        freqmode="basebandfs", batch_blocks=8,
    )


def capture(cfg, scenario, n_batches=3):
    """A tone and a burst (rich: a second segment's burst and a burst
    channel's), the capture of tools/multihost_worker.py."""
    n = n_batches * cfg.batch_blocks * cfg.inplen
    t = np.arange(n)
    rng = np.random.default_rng(8)
    x = (np.exp(2j * np.pi * -0.2 * t)
         + 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    bursts = [(6, 16, 2.0, 0.25)]
    if scenario == "rich":
        bursts += [(9, 19, 2.5, 0.36), (4, 13, 2.0, 0.45)]
    for lo, hi, amp, f in bursts:
        m = np.zeros(n)
        m[lo * cfg.inplen:hi * cfg.inplen] = 1.0
        x += (amp * m * np.exp(2j * np.pi * f * t)).astype(np.complex64)
    return x


def close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).max() if b.size else 0.0
    return a.shape == b.shape and bool(
        np.all(np.abs(a - b) <= ATOL * scale + RTOL * np.abs(b)))


def meta(e):
    d = e.to_dict()
    d["ID"] = d["ID"].split(".", 1)[1]  # drop the timestamp prefix
    return d


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("pid", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("init")
    ap.add_argument("scenario", nargs="?", default="basic",
                    choices=("basic", "rich"))
    ap.add_argument("--cuda", action="store_true")
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--config", default="")
    ap.add_argument("--capture", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    pid, nproc, cuda = args.pid, args.nproc, args.cuda
    dev = "cuda:0" if cuda else "cpu"
    assert initialize_multihost(args.init, nproc, pid) == pid
    assert process_count() == nproc
    mesh = global_mesh(n_chan=2, devices=[dev] * 4)
    if args.config:
        with open(args.config) as f:
            cfg = ChannelizerConfig.from_json(f.read())
        x = np.fromfile(args.capture, np.complex64)
        scenario = "file"
    else:
        scenario = args.scenario
        cfg = config(scenario)
        x = capture(cfg, scenario)
    sh = ShardedChannelizer(cfg, mesh=mesh)
    if args.eager:
        sh.compile_step = False
    counters = {}
    if cuda:
        import torch

        from fdc_tpu_torch.ops import detect, extract_fused, fft, lifecycle

        counters = {"forward_fft": fft.forward_spectrum_four_step,
                    "extract_shared": extract_fused.extract_shared,
                    "extract_shared_fold":
                        extract_fused.extract_shared_fold,
                    "extract_static": extract_fused.extract_static,
                    "candidate_packs": detect.candidate_packs,
                    "slot_lifecycle": lifecycle.slot_lifecycle_multi}
        for f in counters.values():
            f.launches = 0
        torch.cuda.synchronize()
    t = time.perf_counter()
    if scenario != "basic":
        results = [sh.process(x), sh.flush()]
    else:
        # each process feeds its contiguous half of each batch
        res = sh._new_result()
        bs = sh.batch_samples
        half = bs // nproc
        for b in range(len(x) // bs):
            chunk = x[b * bs:(b + 1) * bs]
            arr = host_local_batch(mesh, chunk[pid * half:(pid + 1) * half])
            sh._carry, out = sh._device_step(
                sh._carry if sh._carry is not None else sh._device_init(),
                arr, sh._t0)
            sh._consume_outputs(out, res, [])
            sh._t0 += cfg.batch_blocks
        results = [res]
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    events = [e for r in results for e in r.events]
    streams = [np.concatenate([r.throughput[i] for r in results])
               for i in range(len(results[0].throughput))]
    sig = [(meta(e)["ID"], e.blockstart, e.blockend,
            hashlib.sha1(np.ascontiguousarray(e.data).tobytes()).hexdigest())
           for e in events]
    print(f"PROC{pid} EVENTS {sig}", flush=True)
    launches = {k: f.launches for k, f in counters.items() if f.launches}
    print(f"PROC{pid} WALL {wall:.4f} s STEPS {sh._t0 // cfg.batch_blocks} "
          f"LAUNCHES {launches}", flush=True)
    # the compiled step's graphs: one a segment between the gathers
    graphs = sum(len(e.graphs) for e in sh._jit_step._entries.values())
    print(f"PROC{pid} GRAPHS {graphs}", flush=True)

    if pid == 0:
        ref = FrequencyDomainChannelizer(cfg, device=dev)
        rres = [ref.process(x)]
        if scenario != "basic":
            rres.append(ref.flush())
        rev = [e for r in rres for e in r.events]
        rstreams = [np.concatenate([r.throughput[i] for r in rres])
                    for i in range(len(rres[0].throughput))]
        kinds = {m["ID"].split(".")[0] + "." + m["ID"].split(".")[-2]
                 for m in map(meta, rev)}
        if scenario == "rich":
            # every event source must fire: the burst channel and both
            # segments
            assert any("PowActChan" in k for k in kinds), kinds
            assert sum("DETECTED" in k for k in kinds) >= 2, kinds
        assert rev, "the capture must trigger events"
        assert [meta(e) for e in events] == [meta(e) for e in rev], (
            [meta(e) for e in events], [meta(e) for e in rev])
        assert close(np.concatenate([e.data for e in events]),
                     np.concatenate([e.data for e in rev])), "event samples"
        for a, b in zip(streams, rstreams):
            assert close(a, b), "throughput stream"
        print(f"PROC0 MULTIHOST==SINGLE OK ({len(rev)} events)", flush=True)
        if args.out:
            with open(args.out, "wb") as f:
                pickle.dump(results, f)

    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
