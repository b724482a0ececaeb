"""The harness's spans, and the device trace of a profiled sub-window.

Spans are the harness's own, recorded from the benchmark's files around
its calls into the program (``Spans.wrap``): each is timed on the host
clock and, while the profiler runs, also marked in its trace
(``torch.profiler.record_function``), so that a device idle gap can be
named by the span the host was in.

:func:`read_trace` reduces a Chrome trace that ``torch.profiler`` wrote
to what the metric readers take: the device operations (kernels, copies,
memsets) and the host spans, inside the sub-window that the profiled
``bench.process`` spans cover.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "copy"}


class Spans:
    """Host spans by name: total seconds and count over the window's calls
    (``call``, set by the harness's loop; -1 outside the window), leaving
    out the calls in ``skip`` (the profiled ones, whose host time the
    profiler inflates)."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.call = -1
        self.skip = set()
        self._depth = defaultdict(int)

    def wrap(self, name, fn, outermost=False, after=None):
        """``fn`` timed as span ``name``; with ``outermost`` only the
        outermost of recursive calls counts; ``after`` runs inside the
        span once ``fn`` returned (a device synchronisation)."""
        import torch

        def timed(*args, **kwargs):
            if outermost and self._depth[name]:
                return fn(*args, **kwargs)
            self._depth[name] += 1
            t = time.perf_counter()
            try:
                with torch.profiler.record_function(name):
                    out = fn(*args, **kwargs)
                    if after is not None:
                        after()
            finally:
                self._depth[name] -= 1
            if self.call >= 0 and self.call not in self.skip:
                self.total[name] += time.perf_counter() - t
                self.count[name] += 1
            return out

        return timed


@dataclass
class Trace:
    """A profiled sub-window: ``ops`` are device operations (name, kind,
    start us, end us), ``spans`` host spans (name, start us, end us);
    ``start`` and ``end`` bound the sub-window (us); ``calls`` is the
    number of process() calls in it."""

    ops: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    start: float = 0.0
    end: float = 0.0
    calls: int = 0

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-6

    def kernels(self, match=None):
        return [o for o in self.ops if o[1] == "kernel"
                and (match is None or match(o[0]))]


def union(intervals):
    """Merged, sorted [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def read_trace(path: str, calls: int) -> Trace:
    """The Chrome trace at ``path`` reduced to the sub-window of the
    ``calls`` profiled ``bench.process`` spans."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops, spans = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ops.append((ev["name"], DEVICE_CATS[cat], s, e))
        elif cat == "user_annotation" and ev["name"].startswith("bench."):
            spans.append((ev["name"], s, e))
    proc = [sp for sp in spans if sp[0] == "bench.process"]
    if len(proc) != calls:
        raise RuntimeError(f"the trace holds {len(proc)} process() spans "
                           f"of {calls} profiled calls")
    t = Trace(start=min(sp[1] for sp in proc), end=max(sp[2] for sp in proc),
              calls=calls)
    t.ops = [(n, k, max(s, t.start), min(e, t.end)) for n, k, s, e in ops
             if e > t.start and s < t.end]
    t.spans = [sp for sp in spans if sp[2] > t.start and sp[1] < t.end]
    return t


def busy_seconds(t: Trace, kinds=("kernel", "copy")) -> float:
    return covered([(s, e) for _, k, s, e in t.ops if k in kinds]) * 1e-6


def idle_gaps(t: Trace):
    """[(start us, end us)] of the sub-window with no device operation."""
    gaps, at = [], t.start
    for s, e in union([(s, e) for _, _, s, e in t.ops]):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < t.end:
        gaps.append((at, t.end))
    return gaps


def breakdown(t: Trace, top=10):
    """{"device_ops": the device operations that took most time,
    "idle_gaps": idle seconds by the innermost span the host was in
    (outside every span: "harness", the loop between calls)},
    each [[name, seconds], ...], at most ``top`` entries."""
    by_op = defaultdict(float)
    for n, _, s, e in t.ops:
        by_op[n[:120]] += (e - s) * 1e-6
    by_span = defaultdict(float)
    for g0, g1 in idle_gaps(t):
        # split the gap where a span begins or ends inside it
        cuts = sorted({g0, g1} | {x for sp in t.spans for x in sp[1:]
                                  if g0 < x < g1})
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            inner = [sp for sp in t.spans if sp[1] <= mid < sp[2]]
            name = (min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner
                    else "harness")
            by_span[name] += (b - a) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])][:top]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_span)}
