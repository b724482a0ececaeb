"""The one traffic generator: a seeded ring of batches from a mix's data.

A mix (``traffic/<name>.json``) is data only; this module lays it over a
configuration (the keyword arguments of its file under ``configs/``) as
a ring of ``ring_batches`` whole batches of complex64 samples, which the
harness replays seamlessly: every tone, gate and burst repeats with the
ring's period, and a burst may run across the ring's end.

What a mix can ask for, laid from the seed. Every seed lays the same
multiset of carriers (durations spread evenly over their ranges, widths
and levels cycled), in another order and at other places, so that every
seed asks the same work of the program:

- ``floor``: a comb floor, one exact-bin tone of this amplitude (of the
  1/N-scaled spectrum) in every bin, with random phases: every detection
  cell has the same power, so no ratio the detectors see lies near a
  threshold except across a carrier's edge.
- ``static_tone``: an exact-bin tone of this amplitude at the centre of
  every throughput channel.
- ``burst_channels``: in every burst channel a multi-tone carrier over the
  middle ``fill`` of its measured band, ``level_db`` over the floor, on
  and off for durations in blocks drawn from ``on_blocks`` / ``off_blocks``.
- ``segments``: in every detection segment, ``lanes`` of carriers on the
  segment's own cell grid (so each edge cell is all carrier or all
  floor), side by side with ``lane_gap_cells`` of floor between lanes.
  A lane's carriers are ``widths`` cells wide, at a level drawn from
  ``levels_db`` ([first, last, step] dB over the floor, coherent with the
  floor's bins), and follow the lane's ``mode``: ``within`` (one carrier
  a batch, inside it), ``across`` (one carrier a batch, across the
  batch's end) or ``free`` (on / off durations as the burst channels).

Every gate spans whole blocks of the overlap-save framing: it opens where
block j's new samples start and closes where block j + L - 1's window
ends, so the first and last block it touches hold 3/4 of the block
(4096-point blocks at overlap 4), and raised-cosine edges of 1/8 block
soften it. No block holds a sliver of a carrier whose power ratio could
sit near a threshold.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.channelizer import burst_channel, segment

# a carrier is placed this many blocks clear of a batch's end, so its
# channel (processed through the deactivation delay, emitted the block
# after) needs extraction rows in one batch only
END_MARGIN = 4


def rng_of(seed: int, stream: int = 0) -> np.random.Generator:
    """Generator ``stream`` of a whole-number seed, negative or above
    2**63."""
    seed = int(seed)
    words = [abs(seed) >> (32 * i) & 0xFFFFFFFF for i in range(3)]
    return np.random.default_rng(words + [int(seed < 0), stream])


def geometry(cfg: dict):
    n = int(cfg["blocksize"])
    ovl = n // int(cfg["relinvovl"])
    return n, ovl, n - ovl, int(cfg["batch_blocks"])


def _pattern(n, bins, amps):
    """One period of exact-bin tones (FFT bins, any sign)."""
    spec = np.zeros(n, np.complex128)
    np.add.at(spec, np.asarray(bins) % n, amps)
    return np.fft.ifft(spec) * n


def _spread(lo, hi, m):
    """``m`` whole numbers spread evenly over [lo, hi]."""
    return np.round(np.linspace(lo, hi, m)).astype(int)


def _cycle(values, m, rng):
    """``values`` repeated to ``m`` entries, in an order drawn from
    ``rng``: every seed gets the same multiset."""
    return list(rng.permutation(np.resize(np.asarray(values), m)))


def _free(rng, ring_blocks, on, off):
    """(first block, blocks) of on-periods alternating with off-periods
    that close the ring: durations spread evenly over the ranges (the
    off-periods stretched alike to fill the ring), in an order and from a
    phase drawn from ``rng``."""
    m = max(1, ring_blocks // ((on[0] + on[1] + off[0] + off[1]) // 2))
    ons = _spread(on[0], on[1], m)
    offs = _spread(off[0], off[1], m)
    offs += (ring_blocks - ons.sum() - offs.sum()) // m
    offs[-1] += ring_blocks - ons.sum() - offs.sum()
    ons, offs = rng.permutation(ons), rng.permutation(offs)
    spans, t = [], int(rng.integers(0, ring_blocks))
    for a, b in zip(ons, offs):
        spans.append((t % ring_blocks, int(a)))
        t += int(a + b)
    return spans


def _per_batch(rng, ring_batches, b, mode, blocks):
    """(first block, blocks) of one carrier a batch, inside each batch
    (``within``) or across each batch's end (``across``): durations spread
    evenly over the range, in an order drawn from ``rng``, at places
    drawn from it."""
    spans = []
    for j, d in enumerate(rng.permutation(_spread(*blocks, ring_batches))):
        d = int(d)
        if mode == "within":
            s = j * b + int(rng.integers(1, b - END_MARGIN - d + 1))
        else:
            before = int(rng.integers(2, d - 1))  # blocks in batch j
            s = (j + 1) * b - before
        spans.append((s, d))
    return spans


def schedule(cfg: dict, mix: dict, seed: int):
    """Every gated carrier of the ring: a list of dicts with ``kind``
    ("burst" or "segment"), ``unit``, ``first`` block, ``blocks``, FFT
    ``bins`` and ``amp`` (per bin, relative to the floor's)."""
    n, _, _, b = geometry(cfg)
    ring_blocks = int(mix["ring_batches"]) * b
    rng = rng_of(seed, 1)
    out = []
    bc = mix.get("burst_channels")
    r = int(cfg["relinvovl"])
    if bc:
        for k, (f, bw) in enumerate(cfg.get("activity_controlled_channels",
                                            ())):
            c = burst_channel(n, r, (f + 0.5) % 1.0, bw % 1.0)
            width = max(2, int((c.me - c.ms) * bc["fill"]))
            first = (c.ms + c.me - width) // 2
            for s, d in _free(rng, ring_blocks, bc["on_blocks"],
                              bc["off_blocks"]):
                out.append(dict(kind="burst", unit=k, first=s, blocks=d,
                                bins=np.arange(first, first + width) - n // 2,
                                amp=10 ** (bc["level_db"] / 20),
                                ramp=bc["edge_blocks"]))
    sg = mix.get("segments")
    if sg:
        lo, hi, step = sg["levels_db"]
        levels = np.arange(lo, hi + step / 2, step)
        gap = int(sg["lane_gap_cells"])
        for i, (a, z) in enumerate(cfg.get("activity_detection_segments",
                                           ())):
            g = segment(n, a, z, float(cfg["minchandist"]))
            cell = gap
            for lane in sg["lanes"]:
                span = max(lane["widths"]) + 2
                if cell + span + gap > g.n_cells:
                    raise ValueError(f"segment {i}: {g.n_cells} cells hold "
                                     f"fewer lanes than the mix lays")
                if lane["mode"] == "free":
                    spans = _free(rng, ring_blocks, lane["on_blocks"],
                                  lane["off_blocks"])
                else:
                    spans = _per_batch(rng, int(mix["ring_batches"]), b,
                                       lane["mode"], lane["blocks"])
                widths = _cycle(lane["widths"], len(spans), rng)
                lv = _cycle(levels, len(spans), rng)
                for (s, d), w, level in zip(spans, widths, lv):
                    w = int(w)
                    c0 = cell + int(rng.integers(0, span - w + 1))
                    bins = g.start + c0 * g.dec + np.arange(w * g.dec)
                    out.append(dict(
                        kind="segment", unit=i, first=s % ring_blocks,
                        blocks=d, bins=bins - n // 2,
                        amp=10 ** (float(level) / 20),
                        ramp=sg["edge_blocks"]))
                cell += span + gap
    return out


def ring(cfg: dict, mix: dict, seed: int) -> np.ndarray:
    """The ring: ``ring_batches`` x ``batch_blocks`` x inplen complex64
    samples, the same for the same seed."""
    n, ovl, hop, b = geometry(cfg)
    total = int(mix["ring_batches"]) * b * hop
    rng = rng_of(seed)
    floor = float(mix.get("floor", 0.0))
    phase = np.exp(2j * np.pi * rng.random(n))  # per FFT bin
    bins, amps = [np.arange(n)], [floor * phase]
    if mix.get("static_tone"):
        f = np.array([c[0] for c in cfg.get("throughput_channels", ())])
        tb = np.round(f * n).astype(int)
        bins.append(tb)
        amps.append(np.full(len(tb), float(mix["static_tone"]),
                            np.complex128))
    x = np.resize(_pattern(n, np.concatenate(bins), np.concatenate(amps))
                  .astype(np.complex64), total)
    for c in schedule(cfg, mix, seed):
        p = _pattern(n, c["bins"], floor * c["amp"] * phase[c["bins"] % n])
        s = c["first"] * hop  # block `first`'s new samples
        e = (c["first"] + c["blocks"]) * hop - ovl  # block last's window end
        seg = np.resize(np.roll(p, -(s % n)), e - s)
        ramp = min(int(c["ramp"] * n), (e - s) // 2)
        edge = 0.5 - 0.5 * np.cos(np.pi * (np.arange(ramp) + 0.5) / ramp)
        seg[:ramp] *= edge
        seg[e - s - ramp:] *= edge[::-1]
        seg = seg.astype(np.complex64)
        i = s % total
        k = min(e - s, total - i)
        x[i:i + k] += seg[:k]
        x[:e - s - k] += seg[k:]
    return x
