"""End-to-end demo mirroring the reference example flowgraph, on the
PyTorch port (``fdc_tpu_torch``): the counterpart of
``examples/fdc_example.py``, with its arguments, configuration, seeded
capture and printed lines.

The reference example (reference: examples/FDC_example.grc) feeds five
rotated random sources + noise into a FrequencyDomainChannelizer configured
with four channels [[0.12, 0.05], [0.22, 0.1], [-0.14, 0.12], [0, 0.081]]
(normalized baseband), blocklen 4096, relinvovl 4, both throughput and
activity-controlled modes, and renders a WaterfallMsgTagging display.

This script rebuilds that scenario: synthesized multicarrier capture ->
channelizer (throughput + power-activation + a detection segment) ->
waterfall PNG with detection-event overlay rectangles. The channelizer
runs on the CUDA card (the hand-written kernels, its step replayed as a
CUDA graph); ``--cpu`` runs the kernels' plain PyTorch versions on the
CPU. The PNG is skipped when matplotlib is missing.

Run:  python examples/fdc_example_torch.py [--out waterfall.png] [--cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


CHANNELS = [(0.12, 0.05), (0.22, 0.1), (-0.14, 0.12), (0.0, 0.081)]


def make_capture(n, rng):
    """Five bursty band-limited sources + noise (the reference's rotated
    random sources), complex64 at fs=1."""
    t = np.arange(n)
    x = 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    # four sources on the configured channels, bursting on/off
    for i, (f, bw) in enumerate(CHANNELS):
        # band-limited noise: filtered random source, scaled
        src = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        # crude band-limit: moving average over ~1/bw samples
        k = max(int(1.0 / bw / 4), 1)
        kernel = np.ones(k) / np.sqrt(k)
        src = np.convolve(src, kernel, mode="same")
        burst = np.zeros(n)
        lo = (i * 2 + 1) * n // 12
        hi = min(n, lo + n // 3)
        burst[lo:hi] = 1.0
        x = x + 0.8 * burst * src * np.exp(2j * np.pi * f * t)
    # fifth source: sweeping tone through the detection segment
    x = x + 0.9 * np.exp(2j * np.pi * (0.35 + 0.02 * np.sin(2 * np.pi * t / n)) * t)
    return x.astype(np.complex64)


def main(argv=None, results=None):
    """Run the demo; ``results``: a list that receives the
    ``ProcessResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="waterfall.png")
    ap.add_argument("--cpu", action="store_true",
                    help="the plain versions on the CPU, not the card")
    ap.add_argument("--blocks", type=int, default=256)
    args = ap.parse_args(argv)

    from fdc_tpu_torch import ChannelizerConfig, FrequencyDomainChannelizer
    from fdc_tpu_torch.utils.waterfall import Waterfall

    cfg = ChannelizerConfig(
        blocksize=4096,
        relinvovl=4,
        throughput_channels=CHANNELS,
        activity_controlled_channels=CHANNELS,
        activity_detection_segments=[(0.30, 0.42)],
        act_contr_threshold=10.0,
        act_det_threshold=6.0,
        minchandist=0.005,
        minchanflankpuffer=0.2,
        freqmode="normalized",
        batch_blocks=32,
        debug=True,  # expose the wideband spectrum for the waterfall
    )
    fdc = FrequencyDomainChannelizer(cfg,
                                     device="cpu" if args.cpu else "cuda")

    rng = np.random.default_rng(0)
    n = args.blocks * cfg.inplen
    print(f"synthesizing {n} samples ({args.blocks} blocks)...")
    x = make_capture(n, rng)

    print("processing...")
    result = fdc.process(x)
    if results is not None:
        results.append(result)

    print(f"blocks processed:   {result.blocks_processed}")
    print(f"events emitted:     {len(result.events)}")
    for e in result.events[:10]:
        print(
            f"  {e.ID}  fin={e.finalized} blocks=[{e.blockstart},{e.blockend}] "
            f"cfreq={e.rel_cfreq:.3f} bw={e.rel_bw:.3f} n={len(e.data)}"
        )
    if len(result.events) > 10:
        print(f"  ... {len(result.events) - 10} more")
    for i, s in enumerate(result.throughput):
        print(f"throughput ch{i}: {len(s)} samples, mean |x| = {np.abs(s).mean():.3f}")

    wf = Waterfall(blocklen=cfg.blocksize, width=1024,
                   height=max(64, args.blocks), blockdecimation=1)
    wf.feed_power(np.abs(result.debug_spectrum) ** 2)
    wf.feed_events(result.events)
    if wf.save_png(args.out):
        print(f"waterfall written to {args.out}")
    else:
        print("matplotlib unavailable; waterfall PNG skipped", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
