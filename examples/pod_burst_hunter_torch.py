"""Pod-scale burst hunter (BASELINE config 5, scaled to this machine), on
the PyTorch port (``fdc_tpu_torch``): the counterpart of
``examples/pod_burst_hunter.py``, with its arguments, configuration,
seeded capture and printed lines.

Demonstrates the distribution story: a (time, chan) mesh of ranks, the
sharded channelizer step (the history and reach-back hand-offs between
time ranks, the gathered detection statistics, channel-sharded
extraction; one CUDA graph a step), per-host sample feeding via the
multihost helpers, waterfall-style detection messages, and a split
multi-owner pipeline.

Every host of a cluster runs this same script after
``initialize_multihost()``; here ``--devices N`` ranks are N streams of
the first CUDA card (``--accel``: one rank a CUDA device), or N CPU
ranks (the kernels' plain versions) with ``--cpu``:

    python examples/pod_burst_hunter_torch.py [--devices 8] [--n-chan 2]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main(argv=None, results=None):
    """Run the demo; ``results``: a list that receives the sharded run's
    and the split pipeline's ``ProcessResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks: streams of the first card, or CPU ranks "
                         "with --cpu (ignored with --accel)")
    ap.add_argument("--n-chan", type=int, default=2)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--accel", action="store_true",
                    help="one rank a CUDA device instead of streams of "
                         "the first")
    ap.add_argument("--cpu", action="store_true",
                    help="CPU ranks (the plain versions), not the card")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from fdc_tpu_torch import ChannelizerConfig
    from fdc_tpu_torch.parallel.multihost import (
        global_mesh,
        host_local_batch,
        initialize_multihost,
    )
    from fdc_tpu_torch.parallel.sharded import ShardedChannelizer
    from fdc_tpu_torch.utils.waterfall import Waterfall

    # the ranks: N streams of the first card, N CPU ranks, or (--accel)
    # every CUDA device
    devices = (None if args.accel and not args.cpu else
               ["cpu" if args.cpu else "cuda:0"] * args.devices)
    proc = initialize_multihost()
    mesh = global_mesh(n_chan=args.n_chan, devices=devices)
    n_time = mesh.shape["time"]
    print(f"process {proc}: mesh time={n_time} chan={args.n_chan}")

    cfg = ChannelizerConfig(
        blocksize=1024,
        relinvovl=4,
        activity_detection_segments=[(-0.45, -0.02), (0.02, 0.45)],
        act_det_threshold=8.0,
        minchandist=0.01,
        freqmode="basebandfs",
        batch_blocks=4 * n_time,
        max_slots=64,   # scaled stand-in for "512+ dynamic channels"
        max_candidates=16,
        # pod-scale output compaction: two-tier extraction — most detected
        # carriers are narrow, so ship 16 rows at width 64 and only 4 at
        # the full width
        max_extract_width=512,
        extract_budget=4,
        extract_width_split=64,
        extract_budget_narrow=16,
        debug=True,
    )
    fdc = ShardedChannelizer(cfg, mesh=mesh)

    # synthesize a busy burst scene
    rng = np.random.default_rng(0)
    n = args.batches * fdc.batch_samples
    t = np.arange(n)
    x = (0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    n_blocks = n // cfg.inplen
    for _ in range(24):
        f = float(rng.uniform(-0.44, 0.44))
        if abs(f) < 0.03:
            continue
        on = int(rng.integers(0, n_blocks - 6))
        off = on + int(rng.integers(3, 12))
        m = np.zeros(n)
        m[on * cfg.inplen: off * cfg.inplen] = 1.0
        x += (1.5 * m * np.exp(2j * np.pi * f * t)).astype(np.complex64)

    # per-host feeding path (each host passes only its local shard run on a
    # real cluster; single-process here, so local == global)
    _ = host_local_batch(mesh, x[: fdc.batch_samples])

    wf = Waterfall(blocklen=cfg.blocksize, width=512,
                   height=max(64, n_blocks))
    events = []
    res = fdc.process(x)
    events.extend(res.events)
    wf.feed_power(np.abs(res.debug_spectrum) ** 2)
    wf.feed_events(res.events)

    fin = [e for e in events if e.finalized]
    print(f"blocks processed: {res.blocks_processed}")
    print(f"events: {len(events)} ({len(fin)} finalized)")
    for e in fin[:12]:
        print(f"  {e.ID}  blocks=[{e.blockstart},{e.blockend}] "
              f"cfreq={e.rel_cfreq:.3f} bw={e.rel_bw:.4f} n={len(e.data)}")
    if args.out and wf.save_png(args.out):
        print(f"waterfall written to {args.out}")

    # event-dense deployments: split each wide segment into independent
    # sub-segment automata (cut reconciliation keeps detections exact)
    # and spread the scan chains over pipeline owner lanes (the ranks'
    # devices again: streams of the card, or CPU lanes)
    from fdc_tpu_torch.parallel.pipeline import PipelineChannelizer

    cfg_split = cfg.replace(
        batch_blocks=8,
        segment_splits=[(0, 2, 2), (1, 2, 2)],  # 2 segments -> 4 automata
        debug=False,
    )
    pipe = PipelineChannelizer(
        cfg_split, devices=mesh.local_devices, scan_owners=4,
    )
    res_p = pipe.process(x[: 2 * pipe.batch_samples])
    if results is not None:
        results += [res, res_p]
    fin_p = [e for e in res_p.events if e.finalized]
    print(f"split multi-owner pipeline: {len(pipe.segments)} automata, "
          f"{res_p.blocks_processed} blocks, {len(fin_p)} finalized events")
    return 0


if __name__ == "__main__":
    sys.exit(main())
