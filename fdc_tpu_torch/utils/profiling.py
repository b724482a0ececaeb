"""Device-step timing utilities.

Port of ``fdc_tpu.utils.profiling``: the names, arguments and returned
fields are the JAX package's. A step function
``carry, out = step(carry, *args, t)`` runs K and then 2K times with the
carry threaded and every output kept live through a :func:`checksum`;
the per-step time is the difference of the two runs over K, which
cancels the fixed cost of a run.

How a run is timed:

- on a CUDA device (the carry's or the args' first tensor), by CUDA
  events around the replay of a CUDA graph that holds the K (or 2K)
  steps, so the host's launch path is out of the time; where the step
  refuses capture (a host sync, a pageable copy), by CUDA events around
  the eager K steps, which then include the host's enqueue wherever it
  outlasts the device;
- on the CPU, by the host clock around the eager steps.

Every stats dict names its timer under ``"timer"`` ("cuda graph",
"cuda events, eager" or "host clock").
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

__all__ = [
    "checksum",
    "time_scanned",
    "time_scanned_stats",
    "time_scanned_paired",
    "measure_samples_per_sec",
]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def checksum(tree) -> torch.Tensor:
    """Float32 scalar tensor, the sum of |x| over every tensor leaf of a
    nested dict / list / tuple (on the first leaf's device): keeps every
    leaf live."""
    acc = None
    for x in _leaves(tree):
        v = x if x.is_complex() else x.to(torch.float32)
        s = v.abs().to(torch.float32).sum()
        acc = s if acc is None else acc + s.to(acc.device)
    return torch.zeros((), dtype=torch.float32) if acc is None else acc


def _device(carry, args) -> torch.device:
    for x in _leaves((carry, list(args))):
        return x.device
    return torch.device("cpu")


def _run_steps(step, carry, args, kk, perturb_arg):
    """fn() running ``kk`` steps from ``carry``: the checksum of the last
    carry plus every output's. ``perturb_arg``: the positional arg that
    gets ``previous checksum * 1e-38`` added before each step (identity
    against O(1) samples, but each step reads a tensor made from the
    last one's outputs, as a stream feeds fresh buffers)."""
    dev = _device(carry, args)

    def run():
        c = carry
        s = torch.zeros((), dtype=torch.float32, device=dev)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for t in range(kk):
            pargs = list(args)
            if perturb_arg is not None:
                a = pargs[perturb_arg]
                pargs[perturb_arg] = a + (s * 1e-38).to(a.dtype)
            c, out = step(c, *pargs, t)
            s = checksum(out).to(dev)
            total = total + s
        return checksum(c).to(dev) + total

    return run


class _Timed:
    """Seconds of one call of ``run``: CUDA graph replay between CUDA
    events where the step captures, CUDA events around the eager call
    where it does not, the host clock on the CPU. Construction warms up
    (two eager calls, then the capture)."""

    def __init__(self, run, device: torch.device):
        self.run, self.device, self.graph = run, device, None
        run()
        if device.type != "cuda":
            run()
            self.timer = "host clock"
            return
        self.timer = "cuda events, eager"
        with torch.cuda.device(device):
            # the second warm-up on a side stream, as a capture wants it
            # (libraries set up their per-stream state outside the capture)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    # kept while the graph lives: replays write there
                    self.out = run()
            except RuntimeError:  # the step refuses capture: time it eagerly
                torch.cuda.synchronize()
                return
            self.graph = graph
            self.timer = "cuda graph"
            graph.replay()
            torch.cuda.synchronize()

    def __call__(self) -> float:
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            self.run()
            return time.perf_counter() - t0
        with torch.cuda.device(self.device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            if self.graph is not None:
                self.graph.replay()
            else:
                self.run()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3


def _pair(step, carry, args, k, perturb_arg):
    dev = _device(carry, args)
    return (_Timed(_run_steps(step, carry, args, k, perturb_arg), dev),
            _Timed(_run_steps(step, carry, args, 2 * k, perturb_arg), dev))


def _stats(diffs, timer) -> dict:
    diffs = sorted(diffs)
    n = len(diffs)
    return {
        "median": diffs[n // 2],
        "q25": diffs[n // 4],
        "q75": diffs[(3 * n) // 4],
        "min": diffs[0],
        "max": diffs[n - 1],
        "n": n,
        "timer": timer,
    }


def time_scanned(
    step: Callable,
    carry,
    *args,
    k: int = 8,
    repeats: int = 3,
    perturb_arg: int = 0,
) -> float:
    """Seconds per step of ``carry, out = step(carry, *args, t)``, t the
    step's index in the run: the median of the K-against-2K differences
    (:func:`time_scanned_stats`). ``perturb_arg`` names the positional
    arg (the sample buffer) that each step reads afresh (see
    :func:`_run_steps`); ``None`` for a step whose work depends on the
    carry everywhere that matters."""
    return time_scanned_stats(
        step, carry, *args, k=k, repeats=repeats, perturb_arg=perturb_arg
    )["median"]


def time_scanned_stats(
    step: Callable,
    carry,
    *args,
    k: int = 8,
    repeats: int = 3,
    perturb_arg: int = 0,
) -> dict:
    """:func:`time_scanned` with the spread of the per-step differences:
    {"median", "q25", "q75", "min", "max", "n", "timer"}, seconds a step
    (each floored at 1 ns), over max(repeats, 5) K / 2K pairs."""
    r1, r2 = _pair(step, carry, args, k, perturb_arg)
    diffs = []
    for _ in range(max(repeats, 5)):
        ta = r1()
        tb = r2()
        diffs.append(max((tb - ta) / k, 1e-9))
    return _stats(diffs, r1.timer)


def time_scanned_paired(specs, repeats: int = 15,
                        pairs_per_round: int = 1):
    """Interleaved :func:`time_scanned_stats` over several step functions.

    ``specs``: list of ``(step, carry, args_tuple, k, perturb_arg)``.
    Each round times one K / 2K pair of every spec in turn (with
    ``pairs_per_round`` > 1, that many pairs, spec after spec, and the
    round's value is their median), so drift lands in every spec's
    samples alike and ratios between specs repeat better than ratios of
    separately timed medians.

    Returns a list of stats dicts (the fields of
    :func:`time_scanned_stats`) plus ``"rounds"``, the per-round
    per-step diffs, and ``"pair_rounds"``, each round's raw diffs, both
    index-aligned across specs.
    """
    runs = [(*_pair(step, carry, args, k, perturb_arg), k)
            for step, carry, args, k, perturb_arg in specs]
    n_rounds = max(repeats, 5)
    ppr = max(int(pairs_per_round), 1)
    rounds = [[] for _ in runs]
    pair_rounds = [[] for _ in runs]
    for _ in range(n_rounds):
        diffs = [[] for _ in runs]
        for _ in range(ppr):
            for i, (r1, r2, k) in enumerate(runs):
                ta = r1()
                tb = r2()
                diffs[i].append(max((tb - ta) / k, 1e-9))
        for i in range(len(runs)):
            pair_rounds[i].append(list(diffs[i]))
            rounds[i].append(sorted(diffs[i])[ppr // 2])
    out = []
    for i, (r1, _, _) in enumerate(runs):
        st = _stats(rounds[i], r1.timer)
        st["rounds"] = rounds[i]
        st["pair_rounds"] = pair_rounds[i]
        out.append(st)
    return out


def measure_samples_per_sec(channelizer, k: int = 8) -> float:
    """Steady-state throughput (samples/s) of a port channelizer's step
    (``FrequencyDomainChannelizer`` or one of its subclasses) on its
    device. Feeds unit-amplitude noise; detection activity is whatever
    the noise triggers. K grows until the timed window covers >= 30 ms,
    as in ``fdc_tpu``; the result is the median of 7 K / 2K pairs."""
    cfg = channelizer.config
    rng = np.random.default_rng(0)
    n = cfg.batch_blocks * cfg.inplen
    x = torch.from_numpy(
        (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64)).to(channelizer.device)
    carry = channelizer._device_init()

    def step(c, x_in, t_idx):
        return channelizer._device_step(c, x_in, t_idx * cfg.batch_blocks)

    dt = time_scanned(step, carry, x, k=k)
    k2 = k
    if dt * k < 0.025:
        k2 = int(min(4096, max(k, 0.030 / max(dt, 1e-9))))
    dt = time_scanned_stats(step, carry, x, k=k2, repeats=7)["median"]
    return n / dt
