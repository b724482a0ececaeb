"""The port's own spans and counters on its host path, off by default.

``process()`` / ``process_spectra()`` of the channelizer, the compiled
step and the kernel library open named spans at each layer boundary
(``fdc.process``, ``fdc.stage``, ``fdc.step``, ``fdc.copy_in``,
``fdc.capture``, ``fdc.replay``, ``fdc.device_wait``, ``fdc.consume``,
``fdc.to_host``, ``fdc.pairs_to_complex``, ``fdc.emit``,
``fdc.assemble``, ``fdc.result``, ``fdc.kernel_build``) and count what
they move and wait for (``h2d_bytes``, ``h2d_staged_bytes``,
``stage_waits``, ``d2h_bytes``, ``graph_captures``)::

    from fdc_tpu_torch.runtime import tracing

    tracing.enable()
    fdc.process(samples)
    tracing.summary()   # {"spans": {name: {count, total_ns, self_ns}},
                        #  "counters": {name: n}, "dropped": n}

Off (the default), :func:`span` returns one shared object that does
nothing: no clock read, no allocation, no profiler call; :func:`count`
returns at once. On, each span is a record ``(name, tag, parent, call,
start_ns, end_ns)`` on ``time.perf_counter_ns()``: ``parent`` is the
index of the enclosing span (-1 for none), ``call`` the id of the
``process()`` / ``process_spectra()`` call it belongs to (opened by
:func:`call`; -1 outside one), ``tag`` what tells spans of one name
apart (an emitter's kind and segment). Records go into a buffer of
:data:`CAPACITY` spans, allocated at :func:`enable`; past it, spans are
counted as dropped and not kept. While ``torch.profiler`` records, an
enabled span also opens ``torch.profiler.record_function(name)``, so that
it lands in the profiler's trace beside the device's kernels and
copies, on the same clock. Tracing on also synchronises the step's
stream after each compiled step (``fdc.device_wait``), so that the
device's time is not put on the next host span that waits for it.

One host thread drives the spans: the stack of open spans is the
module's.
"""

from __future__ import annotations

import time
from array import array
from collections import namedtuple

import torch

__all__ = [
    "CAPACITY",
    "Record",
    "call",
    "count",
    "disable",
    "enable",
    "enabled",
    "records",
    "reset",
    "span",
    "summarize",
    "summary",
]

# spans the buffer holds: a 50 s window of the benchmark's cells is
# ~4000 calls of ~30 spans each
CAPACITY = 1 << 18

Record = namedtuple("Record", "name tag parent call start_ns end_ns")

_on = False
_n = 0  # records written
_dropped = 0
_stack = []  # indices of the open spans (-1: a dropped one)
_call = -1  # the current call's id
_next_call = 0
_counters = {}  # (name, call id) -> total
_names = _tags = _parents = _calls = _starts = _ends = None
_clock = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled


def enabled() -> bool:
    """Whether spans and counters record."""
    return _on


def enable():
    """Record spans and counters from now on (the buffer is allocated on
    the first call)."""
    global _on, _names, _tags, _parents, _calls, _starts, _ends
    if _names is None:
        _names = [None] * CAPACITY
        _tags = [None] * CAPACITY
        _parents, _calls, _starts, _ends = (array("q", bytes(8 * CAPACITY))
                                            for _ in range(4))
    _on = True


def disable():
    """Stop recording; what was recorded stays until :func:`reset`."""
    global _on
    _on = False


def reset():
    """Forget every record and counter; call ids start again at 0 (call
    it with no span open)."""
    global _n, _dropped, _call, _next_call
    _n = _dropped = _next_call = 0
    _call = -1
    _stack.clear()
    _counters.clear()


class _Off:
    """The span of tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "tag", "opens_call", "i", "prev_call", "prof")

    def __init__(self, name, tag, opens_call):
        self.name = name
        self.tag = tag
        self.opens_call = opens_call

    def __enter__(self):
        global _n, _dropped, _call, _next_call
        if self.opens_call:
            self.prev_call = _call
            _call = _next_call
            _next_call += 1
        i = _n
        if i < CAPACITY:
            _n = i + 1
            _names[i] = self.name
            _tags[i] = self.tag
            _parents[i] = _stack[-1] if _stack else -1
            _calls[i] = _call
            _ends[i] = -1
        else:
            i = -1
            _dropped += 1
        _stack.append(i)
        self.i = i
        if _profiling():
            self.prof = torch.profiler.record_function(
                self.name, None if self.tag is None else str(self.tag))
            self.prof.__enter__()
        else:
            self.prof = None
        if i >= 0:
            _starts[i] = _clock()
        return self

    def __exit__(self, *exc):
        global _call
        t = _clock()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        if self.i >= 0:
            _ends[self.i] = t
        _stack.pop()
        if self.opens_call:
            _call = self.prev_call
        return False


def span(name: str, tag=None):
    """A context manager timing ``name`` (``tag``: what tells spans of
    one name apart) while tracing is on; a no-op while it is off."""
    if not _on:
        return _OFF
    return _Span(name, tag, False)


def call(name: str):
    """:func:`span` that also opens a new call id for the spans and
    counters inside it (a ``process()`` call)."""
    if not _on:
        return _OFF
    return _Span(name, None, True)


def count(name: str, n) -> None:
    """Add ``n`` to counter ``name`` under the current call id, while
    tracing is on."""
    if _on:
        key = (name, _call)
        _counters[key] = _counters.get(key, 0) + int(n)


def records():
    """Every kept span as a :data:`Record`, in the order they opened (a
    span still open has ``end_ns`` -1)."""
    return [Record(_names[i], _tags[i], _parents[i], _calls[i], _starts[i],
                   _ends[i]) for i in range(_n)]


def summarize(recs, counters, calls=None, dropped=0) -> dict:
    """:func:`summary` of ``recs`` and ``counters`` ({(name, call id):
    total})."""
    keep = None if calls is None else set(calls)
    covered = [0] * len(recs)
    for r in recs:
        if r.parent >= 0 and r.end_ns >= 0:
            covered[r.parent] += r.end_ns - r.start_ns
    spans = {}
    for i, r in enumerate(recs):
        if r.end_ns < 0 or (keep is not None and r.call not in keep):
            continue
        s = spans.setdefault(r.name,
                             {"count": 0, "total_ns": 0, "self_ns": 0})
        s["count"] += 1
        s["total_ns"] += r.end_ns - r.start_ns
        s["self_ns"] += r.end_ns - r.start_ns - covered[i]
    totals = {}
    for (name, c), n in counters.items():
        if keep is None or c in keep:
            totals[name] = totals.get(name, 0) + n
    return {"spans": spans, "counters": totals, "dropped": dropped}


def summary(calls=None) -> dict:
    """Per span name, over the spans of the call ids ``calls`` (default:
    every span kept): ``count``, ``total_ns`` and ``self_ns`` (the spans'
    time less what their child spans cover); ``counters``, each summed
    over those calls; ``dropped``, the spans the full buffer did not
    keep."""
    return summarize(records(), _counters, calls, _dropped)
