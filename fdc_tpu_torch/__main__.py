"""Command-line entry point: run a channelizer config over a capture file.

The PyTorch / CUDA port of ``python -m fdc_tpu`` (``fdc_tpu/__main__.py``):
the same commands, configs, flags and outputs. The reference's user entry
point is a GRC flowgraph (file source -> FrequencyDomainChannelizer ->
file/message sinks, reference: examples/FDC_example.grc); here a JSON
config (``ChannelizerConfig.to_json``) is driven over a raw complex64
capture by the streaming runtime, on the CUDA card (``--cpu``: the
kernels' plain PyTorch versions on the CPU; without it, no card is an
error).

Usage:
  python -m fdc_tpu_torch template > config.json
  python -m fdc_tpu_torch config config.json     # validate + show geometry
  python -m fdc_tpu_torch run config.json capture.c64 --out-dir out/ \\
      --events-jsonl events.jsonl --waterfall wf.png
  python -m fdc_tpu_torch serve config.json --port 0 --port-file port.txt
  python -m fdc_tpu_torch vcm config.json capture.c64

The multi-device flags of ``python -m fdc_tpu`` (``--pipeline*``,
``--dedicated-owner``, ``--time-shards``, ``--chan-shards``,
``--cpu-devices``, ``--hostpipe-*``) are parsed and refused: the port has
no multi-device module yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

__all__ = ["main"]

# flag -> (default, the fdc_tpu module the flag needs and the port
# lacks); the default, a single-device run in fdc_tpu, is accepted
_MULTI_DEVICE = {
    "pipeline": (0, "fdc_tpu/parallel/pipeline.py"),
    "dedicated_owner": (False, "fdc_tpu/parallel/pipeline.py"),
    "pipeline_shard_time": (1, "fdc_tpu/parallel/pipeline.py"),
    "pipeline_scan_owners": (1, "fdc_tpu/parallel/pipeline.py"),
    "time_shards": (1, "fdc_tpu/parallel/sharded.py"),
    "chan_shards": (1, "fdc_tpu/parallel/sharded.py"),
    "cpu_devices": (0, "fdc_tpu/parallel/mesh.py"),
    "hostpipe_owner": (0, "fdc_tpu/parallel/hostpipe.py"),
    "hostpipe_port": (0, "fdc_tpu/parallel/hostpipe.py"),
    "hostpipe_port_file": ("", "fdc_tpu/parallel/hostpipe.py"),
    "hostpipe_worker": ("", "fdc_tpu/parallel/hostpipe.py"),
    "hostpipe_connect": ("", "fdc_tpu/parallel/hostpipe.py"),
}


def _load_config(path: str):
    from fdc_tpu_torch.config import ChannelizerConfig

    with open(path) as f:
        return ChannelizerConfig.from_json(f.read())


def _device(args) -> str:
    return "cpu" if args.cpu else "cuda"


def _refuse_multi_device(args):
    """Exit non-zero on a multi-device flag, naming the module to port."""
    for dest, (default, module) in _MULTI_DEVICE.items():
        if getattr(args, dest, default) != default:
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(
                f"fdc_tpu_torch does not port yet: {flag} (the multi-device "
                f"module {module})"
            )


def _cmd_template(args) -> int:
    from fdc_tpu_torch.config import ChannelizerConfig

    cfg = ChannelizerConfig(
        throughput_channels=((0.12, 0.05),),
        activity_controlled_channels=((0.22, 0.1),),
        activity_detection_segments=((0.30, 0.42),),
    )
    print(cfg.to_json())
    return 0


def _cmd_config(args) -> int:
    """Validate a config and print the solved channel geometry (the
    introspectable output of the config compiler, reference:
    python/FrequencyDomainChannelizer.py:322-345)."""
    from fdc_tpu_torch.config import (
        solve_power_channel,
        solve_segment,
        solve_throughput_channel,
        split_segment_geometry,
    )

    cfg = _load_config(args.config)
    print(f"blocksize={cfg.blocksize} relinvovl={cfg.relinvovl} "
          f"inplen={cfg.inplen} batch_blocks={cfg.batch_blocks}")
    for i, (f, bw) in enumerate(cfg.fdc_throughput_channels()):
        g = solve_throughput_channel(cfg.blocksize, cfg.relinvovl, f, bw)
        print(f"throughput[{i}]: start={g.start} width={g.width} "
              f"out_len={g.out_len} passband={g.passband:.3f} "
              f"stopband={g.stopband:.3f}")
    for i, (f, bw) in enumerate(cfg.fdc_activity_controlled_channels()):
        g = solve_power_channel(cfg.blocksize, cfg.relinvovl, f, bw)
        print(f"power_activation[{i}]: extract=[{g.extract_start},"
              f"{g.extract_stop}) width={g.extract_width} "
              f"measure=[{g.measure_start},{g.measure_stop}) "
              f"out_len={g.out_len}")
    splits = {idx: (n, ovl) for idx, n, ovl in cfg.segment_splits}
    for i, (a, b) in enumerate(cfg.fdc_activity_detection_segments()):
        g = solve_segment(cfg.blocksize, a, b, cfg.minchandist)
        print(f"segment[{i}]: bins=[{g.start},{g.stop}) dec={g.decimation} "
              f"cells={g.n_cells}")
        if i in splits:
            n_parts, ovl = splits[i]
            for p, (gp, core) in enumerate(
                split_segment_geometry(g, n_parts, ovl)
            ):
                print(f"  part[{p}]: scan=[{gp.start},{gp.stop}) "
                      f"core=[{core[0]},{core[1]}) cells={gp.n_cells}")
    return 0


def _print_stats(n_in, blocks, n_events, wall, batches=None):
    print(f"samples in:       {n_in}")
    print(f"blocks processed: {blocks}")
    if batches is not None:
        print(f"batches:          {batches}")
    print(f"events:           {n_events}")
    if wall > 0:
        print(f"throughput:       {n_in / wall / 1e6:.3g} MS/s "
              f"(wall {wall:.1f}s, includes the kernel build)")


def _write_stream_outputs(out_dir, tp_parts):
    """Write per-channel throughput streams; event payload files were
    already written by the channelizer's FileSink."""
    for i, parts in enumerate(tp_parts):
        if parts:
            path = os.path.join(out_dir, f"throughput_ch{i}.c64")
            np.concatenate(parts).astype(np.complex64).tofile(path)
            print(f"wrote {path}")
    print(f"event files in {out_dir}/ (<ID>.fin / <ID>.parted.<n>)")


def _write_events_jsonl(path, events):
    with open(path, "w") as f:
        for e in events:
            d = e.to_dict()
            d["nsamples"] = int(len(e.data))
            f.write(json.dumps(d) + "\n")
    print(f"wrote {path}")


def _apply_splits(cfg, args):
    """--split-segment IDX:N_PARTS[:OVERLAP_CELLS] entries -> config
    segment_splits (see config.split_segment_geometry)."""
    specs = getattr(args, "split_segment", None) or []
    if not specs:
        return cfg
    splits = list(cfg.segment_splits)
    for spec in specs:
        parts = spec.split(":")
        if len(parts) not in (2, 3):
            raise SystemExit(
                f"--split-segment {spec!r}: expected IDX:N_PARTS"
                f"[:OVERLAP_CELLS]"
            )
        idx, n = int(parts[0]), int(parts[1])
        ovl = int(parts[2]) if len(parts) == 3 else 2
        splits.append((idx, n, ovl))
    return dataclasses.replace(cfg, segment_splits=tuple(splits))


def _stream_config(args, force_debug):
    """The config of ``run`` / ``serve``: file output into --out-dir,
    debug spectra for a waterfall, --split-segment."""
    cfg = _load_config(args.config)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        cfg = dataclasses.replace(cfg, fileoutput=True,
                                  outputpath=args.out_dir)
    if force_debug and not cfg.debug:
        cfg = dataclasses.replace(cfg, debug=True)
    return _apply_splits(cfg, args)


def _waterfall(cfg, args, height, blockdecimation):
    from fdc_tpu_torch.utils.waterfall import Waterfall

    return Waterfall(blocklen=cfg.blocksize, width=1024, height=height,
                     blockdecimation=blockdecimation,
                     colorscheme=args.waterfall_colorscheme,
                     db_range=(args.waterfall_db[0], args.waterfall_db[1]),
                     tagmode=args.waterfall_tagmode)


def _cmd_run(args) -> int:
    _refuse_multi_device(args)
    from fdc_tpu_torch.models.channelizer import FrequencyDomainChannelizer
    from fdc_tpu_torch.runtime.stream import StreamDriver

    cfg = _stream_config(args, force_debug=bool(args.waterfall))
    fdc = FrequencyDomainChannelizer(cfg, device=_device(args))
    if args.resume:
        from fdc_tpu_torch.runtime.checkpoint import load_checkpoint

        load_checkpoint(fdc, args.resume)
        print(f"resumed from {args.resume}")

    events = []
    tp_parts: list = [[] for _ in cfg.fdc_throughput_channels()]
    wf_hist = None
    if args.waterfall:
        from fdc_tpu_torch.utils.waterfall import DecimatingPowerHistory

        # RAM-bounded: long captures auto-decimate instead of holding the
        # full debug-spectrum history in memory
        wf_hist = DecimatingPowerHistory(max_rows=2048)
    t_start = time.time()

    def consume(res):
        events.extend(res.events)
        for i, s in enumerate(res.throughput):
            tp_parts[i].append(s)
        if wf_hist is not None and res.debug_spectrum is not None:
            wf_hist.add(np.abs(res.debug_spectrum) ** 2)

    try:
        driver = StreamDriver(fdc, use_native=not args.no_native)
    except RuntimeError:
        driver = StreamDriver(fdc, use_native=False)

    # with --checkpoint the tail must stay unprocessed (carried in the
    # checkpoint's pending buffer) instead of being zero-pad flushed
    do_flush = not args.checkpoint
    if driver.ring is not None:
        results = driver.run_file(args.capture, on_result=consume,
                                  flush=do_flush)
        assert not results  # streamed through on_result
    else:
        # Python buffering: read the whole capture, process in batches
        x = np.fromfile(args.capture, dtype=np.complex64)
        driver.push(x)
        while True:
            res = driver.run_once(timeout=0.0)
            if res is None:
                break
            consume(res)
        if do_flush:
            res = driver.flush()
            if res is not None:
                consume(res)
    if args.checkpoint:
        driver.drain_pending()
    wall = time.time() - t_start

    _print_stats(driver.stats.samples_in, driver.stats.blocks_processed,
                 len(events), wall, batches=driver.stats.batches)
    if args.out_dir:
        _write_stream_outputs(args.out_dir, tp_parts)
    if args.checkpoint:
        from fdc_tpu_torch.runtime.checkpoint import save_checkpoint

        save_checkpoint(fdc, args.checkpoint)
        print(f"wrote {args.checkpoint}")
    if args.events_jsonl:
        _write_events_jsonl(args.events_jsonl, events)
    if wf_hist is not None and wf_hist.n_blocks:
        rows = wf_hist.rows()
        wf = _waterfall(cfg, args, max(64, len(rows)), wf_hist.dec)
        wf.feed_rows(rows)
        wf.feed_events(events)
        if wf.save_png(args.waterfall):
            print(f"wrote {args.waterfall}")
        else:
            print("matplotlib unavailable; waterfall PNG skipped",
                  file=sys.stderr)
    return 0


def _cmd_serve(args) -> int:
    """Listen on a TCP port for connections of interleaved complex64
    samples and channelize them live (the network analog of ``run``)."""
    _refuse_multi_device(args)
    from fdc_tpu_torch.models.channelizer import FrequencyDomainChannelizer
    from fdc_tpu_torch.runtime.stream import StreamDriver

    cfg = _stream_config(args, force_debug=bool(args.waterfall_follow))
    live = None
    if args.waterfall_follow:
        from fdc_tpu_torch.utils.waterfall import LiveWaterfall

        live = LiveWaterfall(_waterfall(cfg, args, 512, 1),
                             interval=args.waterfall_interval,
                             png_path=args.waterfall_follow)
    fdc = FrequencyDomainChannelizer(cfg, device=_device(args))
    driver = StreamDriver(fdc)

    events = []
    tp_parts: list = [[] for _ in cfg.fdc_throughput_channels()]

    def consume(res):
        events.extend(res.events)
        for i, s in enumerate(res.throughput):
            tp_parts[i].append(s)
        if live is not None and res.debug_spectrum is not None:
            live.update(power_blocks=np.abs(res.debug_spectrum) ** 2,
                        events=res.events)

    bound_port = [args.port]

    def on_listen(p):
        bound_port[0] = p
        print(f"listening on {args.bind or '127.0.0.1'}:{p}", flush=True)
        if args.port_file:
            with open(args.port_file, "w") as f:
                f.write(str(p))

    # --max-conns: serve N sequential connections on the SAME port (0 =
    # until interrupted), one logical stream: the carry persists, and each
    # connection's sub-batch tail is zero-pad flushed when the peer closes
    t_start = time.time()
    total_samples = 0
    conns = 0
    try:
        while True:
            driver.run_socket(port=bound_port[0], bind_addr=args.bind,
                              on_result=consume, on_listen=on_listen)
            total_samples += driver.stats.samples_in
            conns += 1
            if args.max_conns and conns >= args.max_conns:
                break
    except KeyboardInterrupt:
        print("interrupted — writing outputs", file=sys.stderr)
    wall = time.time() - t_start

    if conns > 1:
        print(f"connections:      {conns}")
    _print_stats(total_samples, driver.stats.blocks_processed,
                 len(events), wall, batches=driver.stats.batches)
    if live is not None:
        live.update(force=True)  # final frame
        print(f"wrote {args.waterfall_follow} ({live.frames} frames)")
    if args.out_dir:
        _write_stream_outputs(args.out_dir, tp_parts)
    if args.events_jsonl:
        _write_events_jsonl(args.events_jsonl, events)
    return 0


def _cmd_vcm(args) -> int:
    """Standalone multi-segment detector over a capture — the analog of
    wiring the reference's activity_detection_channelizer_vcm block
    behind an external FFT (reference:
    grc/FDC_activity_detection_channelizer_vcm.xml): the port's
    overlap-save front end (``frame_blocks`` + ``forward_spectrum``, kernel
    F on the card) feeds one whole batch of spectra at a time into
    ``ActivityDetectionRunner`` (JAX: fdc_tpu/__main__.py:468-621)."""
    import torch

    from fdc_tpu_torch.models.activity_detection import (
        ActivityDetectionChannelizer,
    )
    from fdc_tpu_torch.models.channelizer import finalize_rounds_bound
    from fdc_tpu_torch.ops.fft import forward_spectrum
    from fdc_tpu_torch.ops.framing import frame_blocks
    from fdc_tpu_torch.utils.events import FileSink

    cfg = _load_config(args.config)
    if cfg.segment_splits:
        # the vcm block's segments are already independent automata: list
        # the parts as separate segments instead
        raise SystemExit(
            "segment_splits is not supported by the vcm block (its "
            "segments are already independent — list the sub-bands as "
            "separate activity_detection_segments)"
        )
    segs = [list(s) for s in cfg.fdc_activity_detection_segments()]
    if not segs:
        print("config has no activity_detection_segments", file=sys.stderr)
        return 2
    adc = ActivityDetectionChannelizer(
        blocklen=cfg.blocksize,
        segments=segs,
        thresh_db=cfg.act_det_threshold,
        relinvovl=cfg.relinvovl,
        minchandist=cfg.minchandist,
        channel_deactivation_delay=cfg.act_det_deactivation_delay,
        window_flank_puffer=cfg.minchanflankpuffer,
        max_slots=cfg.max_slots,
        max_candidates=cfg.max_candidates,
        max_extract_width=cfg.max_extract_width,
        verbose=cfg.verbose,
        extract_budget=cfg.extract_budget,
        extract_width_split=cfg.extract_width_split,
        extract_budget_narrow=cfg.extract_budget_narrow,
        device=_device(args),
    )
    sink = None
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        sink = FileSink(args.out_dir)
    runner = adc.make_runner(maxblocks=cfg.act_det_maxblocks, file_sink=sink,
                             msg_output=True,
                             native_emission=cfg.native_emission)

    inplen = cfg.inplen
    dev = adc.device
    hist = torch.zeros(cfg.ovllen, dtype=torch.complex64, device=dev)

    def front(hist, chunk):
        blocks, hist = frame_blocks(torch.from_numpy(chunk).to(dev), hist,
                                    cfg.blocksize)
        spec = forward_spectrum(blocks, use_mxu=cfg.use_mxu_fft)
        return hist, spec.cpu().numpy()

    x = np.fromfile(args.capture, dtype=np.complex64)
    if args.resume:
        from fdc_tpu_torch.runtime.checkpoint import load_vcm_checkpoint

        extra = load_vcm_checkpoint(runner, args.resume)
        # the overlap history as float32 [ovllen, 2] pairs (the JAX file's)
        histf = np.array(extra["histf"], np.float32)
        hist = torch.from_numpy(
            histf.view(np.complex64).reshape(histf.shape[:-1])).to(dev)
        x = np.concatenate([np.asarray(extra["pending"], np.complex64), x])
        print(f"resumed from {args.resume}")
    nb_total = len(x) // inplen
    if nb_total == 0 and not args.checkpoint:
        print("capture shorter than one block", file=sys.stderr)
        return 2
    events = []
    t_start = time.time()
    step = cfg.batch_blocks * inplen
    # with --checkpoint, only whole batches run (never padded): the
    # remainder is carried in the checkpoint so a split capture resumes
    # bit-identically (the run --checkpoint contract)
    n_proc = (len(x) // step) * step if args.checkpoint else nb_total * inplen
    for off in range(0, n_proc, step):
        chunk = x[off: off + step]
        chunk = chunk[: (len(chunk) // inplen) * inplen]
        if not len(chunk):
            break
        if len(chunk) < step:
            # the ragged tail zero-padded to a whole batch: zeros drive the
            # in-band power to zero, so open bursts see a falling edge
            # (the end-of-stream semantics of FrequencyDomainChannelizer
            # .flush())
            chunk = np.concatenate(
                [chunk, np.zeros(step - len(chunk), np.complex64)])
        hist, spec = front(hist, chunk)
        events.extend(runner.process_spectra(spec))
    if not args.checkpoint:
        # end-of-stream finalize: silent batches while a slot is open, so
        # the emitted events do not depend on the capture length mod batch
        zeros = np.zeros(step, np.complex64)
        for _ in range(finalize_rounds_bound(adc.segments,
                                             cfg.batch_blocks)):
            if not runner.has_open_slots():
                break
            hist, spec = front(hist, zeros)
            events.extend(runner.process_spectra(spec))
    wall = time.time() - t_start

    if args.checkpoint:
        from fdc_tpu_torch.runtime.checkpoint import save_vcm_checkpoint

        h = np.ascontiguousarray(hist.cpu().numpy(), np.complex64)
        save_vcm_checkpoint(runner, args.checkpoint, extra={
            "histf": h.view(np.float32).reshape(*h.shape, 2),
            "pending": x[n_proc:],
        })
        print(f"wrote {args.checkpoint}")
        nb_done = n_proc // inplen
    else:
        nb_done = nb_total
    print(f"blocks processed: {nb_done}")
    print(f"events:           {len(events)}")
    print(f"throughput:       {nb_done * inplen / max(wall, 1e-9) / 1e6:.3g}"
          f" MS/s (wall {wall:.1f}s, includes the kernel build)")
    if args.out_dir:
        print(f"event files in {args.out_dir}/")
    if args.events_jsonl:
        _write_events_jsonl(args.events_jsonl, events)
    return 0


def _add_waterfall_style_args(p):
    """The reference waterfall block's GRC style params (reference:
    grc/FDC_WaterfallMsgTagging.xml: colorscheme, dB range, tagmode)."""
    from fdc_tpu_torch.utils.waterfall import COLOR_SCHEMES, Waterfall

    def scheme(x):
        # index or name; Waterfall validates names
        return int(x) if str(x).lstrip("-").isdigit() else x

    p.add_argument("--waterfall-colorscheme", default=0, type=scheme,
                   help="reference scheme index 0-3 or name "
                        f"({', '.join(COLOR_SCHEMES)})")
    p.add_argument("--waterfall-db", type=float, nargs=2,
                   default=(-100.0, 0.0), metavar=("MIN", "MAX"),
                   help="dB color-binning range")
    p.add_argument("--waterfall-tagmode", default="none",
                   choices=Waterfall.TAGMODES,
                   help="draw event labels: none / id / part")


def _add_stream_args(p):
    """The output, device and split flags of ``run`` and ``serve``."""
    p.add_argument("--out-dir", default="",
                   help="write event files + throughput streams here")
    p.add_argument("--events-jsonl", default="",
                   help="write event metadata as JSON lines")
    p.add_argument("--cpu", action="store_true",
                   help="run the kernels' plain versions on the CPU")
    p.add_argument("--split-segment", action="append", default=[],
                   metavar="IDX:N_PARTS[:OVERLAP_CELLS]",
                   help="partition detection segment IDX into N_PARTS "
                        "sub-segments with OVERLAP_CELLS (default 2) of "
                        "scan margin at each cut (repeatable)")


def _add_multi_device_args(p, hostpipe):
    """``python -m fdc_tpu``'s multi-device flags: parsed, then refused."""
    refused = "not ported yet: refused"
    p.add_argument("--pipeline", type=int, nargs="?", const=-1, default=0,
                   metavar="N", help=refused)
    p.add_argument("--dedicated-owner", action="store_true", help=refused)
    p.add_argument("--pipeline-shard-time", type=int, default=1,
                   metavar="T", help=refused)
    p.add_argument("--pipeline-scan-owners", type=int, default=1,
                   metavar="N", help=refused)
    p.add_argument("--time-shards", type=int, default=1, help=refused)
    p.add_argument("--chan-shards", type=int, default=1, help=refused)
    p.add_argument("--cpu-devices", type=int, default=0, help=refused)
    if hostpipe:
        p.add_argument("--hostpipe-owner", type=int, default=0,
                       metavar="N_WORKERS", help=refused)
        p.add_argument("--hostpipe-port", type=int, default=0, help=refused)
        p.add_argument("--hostpipe-port-file", default="", help=refused)
        p.add_argument("--hostpipe-worker", default="",
                       metavar="HOST_ID:N_HOSTS", help=refused)
        p.add_argument("--hostpipe-connect", default="", metavar="ADDR:PORT",
                       help=refused)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fdc_tpu_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("template", help="print a starter config JSON")

    p_cfg = sub.add_parser("config", help="validate config, show geometry")
    p_cfg.add_argument("config")

    p_run = sub.add_parser("run", help="run a config over a capture file")
    p_run.add_argument("config")
    p_run.add_argument("capture", help="raw complex64 file")
    _add_stream_args(p_run)
    p_run.add_argument("--waterfall", default="",
                       help="render a waterfall PNG with event overlays "
                            "(forces debug spectra on)")
    _add_waterfall_style_args(p_run)
    p_run.add_argument("--no-native", action="store_true",
                       help="skip the native ring (pure-Python buffering)")
    p_run.add_argument("--checkpoint", default="",
                       help="save the streaming state here when done "
                            "(skips the end-of-stream flush: the "
                            "sub-batch tail is carried in the checkpoint)")
    p_run.add_argument("--resume", default="",
                       help="restore streaming state saved by --checkpoint "
                            "(of this package or of fdc_tpu)")
    _add_multi_device_args(p_run, hostpipe=True)

    p_srv = sub.add_parser(
        "serve", help="channelize one TCP connection of complex64 samples"
    )
    p_srv.add_argument("config")
    _add_stream_args(p_srv)
    p_srv.add_argument("--port", type=int, default=0,
                       help="TCP port (0 = ephemeral, printed on listen)")
    p_srv.add_argument("--bind", default="",
                       help="bind address (default 127.0.0.1)")
    p_srv.add_argument("--port-file", default="",
                       help="write the bound port here once listening "
                            "(for scripting with --port 0)")
    p_srv.add_argument("--max-conns", type=int, default=1,
                       help="serve this many sequential connections on "
                            "the same port (0 = forever); connections "
                            "concatenate into one logical stream")
    p_srv.add_argument("--waterfall-follow", default="",
                       help="live waterfall: overwrite this PNG as "
                            "batches arrive (forces debug spectra on)")
    p_srv.add_argument("--waterfall-interval", type=float, default=0.2,
                       help="minimum seconds between waterfall redraws")
    _add_waterfall_style_args(p_srv)
    _add_multi_device_args(p_srv, hostpipe=False)

    p_vcm = sub.add_parser(
        "vcm", help="standalone multi-segment detector (vcm semantics)"
    )
    p_vcm.add_argument("config")
    p_vcm.add_argument("capture", help="raw complex64 file")
    p_vcm.add_argument("--out-dir", default="",
                       help="write event payload files here")
    p_vcm.add_argument("--events-jsonl", default="",
                       help="write event metadata as JSON lines")
    p_vcm.add_argument("--cpu", action="store_true",
                       help="run the kernels' plain versions on the CPU")
    p_vcm.add_argument("--checkpoint", default="",
                       help="save the detector streaming state here when "
                            "done (whole batches only; the tail is "
                            "carried in the checkpoint)")
    p_vcm.add_argument("--resume", default="",
                       help="restore state saved by --checkpoint (of this "
                            "package or of fdc_tpu)")
    args = ap.parse_args(argv)

    return {"template": _cmd_template,
            "config": _cmd_config,
            "run": _cmd_run,
            "serve": _cmd_serve,
            "vcm": _cmd_vcm}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
