"""The comparison that decides ``correct`` for a channelizer cell.

The harness hands every process() call the ring batch ``k % P`` (P the
ring's batches), on one stream from silence. The reference runs the
same stream from silence for two periods: call k < 2P is its batch k,
and a later call is batch P + k % P, the same state one period on (every
carrier of the ring ends within a period, so the stream repeats once the
first period is past). Blocks of a later call are shifted by whole
periods; the burst and channel counters in the event IDs run on across
periods and are not compared.

The flush that ends the stream is not compared: its first silent block
holds the last quarter block of signal, and the comb floor cut there
smears over a segment into a detection wider than ``max_extract_width``,
past a capacity the configuration states (see ``channelizer``).

Compared, each against its limit in the configuration file (the first
two only where the configuration has streams or segments):

- ``stream_err``: the throughput streams of the sampled calls, each
  channel's largest error over its largest magnitude;
- ``power_err``: the segments' cell powers of the sampled calls, the same
  per segment;
- ``event_err``: the samples of the sampled calls' events, the same per
  event;
- ``event_miss``: events of those calls whose metadata (source, unit,
  final or part, centre, width, first and last block, bins, length)
  differs, is missing or is extra;
- ``count_miss``: calls, of every call of the run, that emitted another
  number of events than the reference's batch.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import channelizer as ref

def ref_index(k: int, period: int) -> int:
    return k if k < 2 * period else period + k % period


def event_dict(ev) -> dict:
    """A program event (``ChannelEvent``) in the reference's form."""
    _, source, unit = ev.ID.split(".")[:3]
    return dict(source=source, unit=int(unit), finalized=bool(ev.finalized),
                part=ev.part, rel_cfreq=ev.rel_cfreq, rel_bw=ev.rel_bw,
                blockstart=int(ev.blockstart), blockend=int(ev.blockend),
                vectorstart=ev.vectorstart, vectorend=ev.vectorend,
                data=np.asarray(ev.data))


def _key(e):
    return (e["source"], e["unit"], e["blockend"], e["blockstart"],
            -1 if e["vectorstart"] is None else e["vectorstart"],
            -1 if e["part"] is None else e["part"], e["finalized"])


def _meta(e, shift=0):
    m = {k: v for k, v in e.items() if k != "data"}
    m["blockstart"] += shift
    m["blockend"] += shift
    m["samples"] = len(e["data"])
    return m


def _rel(a, b) -> float:
    scale = float(np.abs(b).max()) if np.size(b) else 0.0
    if not np.size(b) and not np.size(a):
        return 0.0
    if np.shape(a) != np.shape(b):
        return float("inf")
    err = float(np.abs(np.asarray(a, np.complex128) - b).max())
    return err / scale if scale else (0.0 if err == 0 else float("inf"))


def compare_events(got, want, shift):
    """(mismatched events, worst relative sample error) of one call's
    events against the reference's, ``shift`` blocks on."""
    got = sorted((event_dict(e) for e in got), key=_key)
    want = sorted(want, key=lambda e: _key(dict(
        e, blockend=e["blockend"] + shift,
        blockstart=e["blockstart"] + shift)))
    miss = abs(len(got) - len(want))
    worst = 0.0
    for g, w in zip(got, want):
        if _meta(g) != _meta(w, shift):
            miss += 1
        else:
            worst = max(worst, _rel(g["data"], w["data"]))
    return miss, worst


def judge(cfg: dict, ring: np.ndarray, record, rnd=ref.identity) -> dict:
    """The compared numbers of a run. ``record``: ``period`` (ring
    batches), ``counts`` (events of every call, warm-up calls first) and
    ``sampled`` {call: ProcessResult}. ``rnd`` as
    :class:`~benchmark.reference.channelizer.Stream` takes it."""
    p = record.period
    b = int(cfg["batch_blocks"])
    bs = len(ring) // p
    n_calls = len(record.counts)
    need = {ref_index(k, p) for k in record.sampled}
    n_ref = max([ref_index(k, p) + 1 for k in range(min(n_calls, 2 * p))]
                + [j + 1 for j in need])
    outs = ref.run(cfg, lambda j: ring[(j % p) * bs:(j % p + 1) * bs],
                   n_ref, outputs_for=need, rnd=rnd)
    nums = dict.fromkeys(names(cfg), 0.0)
    nums["count_miss"] = float(sum(
        c != len(outs[ref_index(k, p)].events)
        for k, c in enumerate(record.counts)))
    for k, res in record.sampled.items():
        j = ref_index(k, p)
        o = outs[j]
        if "stream_err" in nums:
            nums["stream_err"] = max([nums["stream_err"]] + [
                _rel(a, w) for a, w in zip(res.throughput, o.throughput)])
        if len(res.throughput) != len(o.throughput):
            nums["stream_err"] = float("inf")
        if "power_err" in nums:
            nums["power_err"] = max([nums["power_err"]] + [
                _rel(a, w) for a, w in zip(res.segment_power, o.seg_power)])
        miss, worst = compare_events(res.events, o.events, (k - j) * b)
        nums["event_miss"] += miss
        nums["event_err"] = max(nums["event_err"], worst)
    return nums


def names(cfg: dict):
    """The compared numbers a configuration has: streams only with
    throughput channels, cell powers only with detection segments."""
    out = []
    if cfg.get("throughput_channels"):
        out.append("stream_err")
    if cfg.get("activity_detection_segments"):
        out.append("power_err")
    return out + ["event_err", "event_miss", "count_miss"]
