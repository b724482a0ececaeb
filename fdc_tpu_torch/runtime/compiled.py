"""Compiled steps: the port's counterpart of ``jax.jit`` for a step.

``fdc_tpu`` compiles each step into one XLA program and dispatches it
once a batch (``jax.jit(self._device_step)``, with ``t0`` a traced
int32). On the card the counterpart is a captured CUDA graph.
:class:`CompiledStep` wraps a step function ``fn(carry, *inputs, t0) ->
(new_carry, out)`` (``t0`` left out with ``takes_t0=False``) and runs it
with one buffer discipline on both devices:

- **Static inputs.** One set of input buffers per input shape, and
  ``t0`` as a 0-d int32 tensor: each call copies its inputs in and
  writes ``t0``. A Python ``int`` would be baked into the graph at
  capture. A page-locked host input is copied without blocking (below);
  any other input as ``copy_`` copies it.
- **Static carry.** The carry leaves are ordinary allocations outside
  the graph pool. The step's new carry is copied back into them at the
  end of the captured region; the call returns them, and the caller
  keeps the returned dict as its carry. A carry the wrapper does not own
  (the first call's, a restored checkpoint's, one made after a reset) is
  copied in first (:meth:`CompiledStep.adopt`).
- **Outputs.** Every call returns the same output tensors, overwritten
  by the next call of any step that shares the pool: copy what you keep
  to the host before the next step.
- **Rings.** A caller that reads a step's outputs several calls late (the
  pipeline) keeps a ring of steps (:func:`compiled_ring`): one step a
  slot, each with a graph pool of its own, all sharing one static carry
  (:class:`StaticCarry`). Slot k's outputs stay valid until slot k runs
  again.

Host memory meets a step in one way, on both ends, for every caller:

- **Host input.** A caller writes each call's input into its
  :class:`StagingSlot`, kept across calls and page-locked on the card, so
  that the step's copy-in is queued without blocking the host, on the
  stream the graph replays on; an event recorded behind the step holds
  the slot's next fill until the copy is done.
- **Host output.** A caller copies the outputs it reads with
  :func:`_to_host` into its :class:`HostMirror`, one host buffer kept
  across calls (page-locked where a leaf is on the card): every copy
  queued without blocking, then one event a device waited for. The
  arrays it returns are views of the mirror, valid until its next copy.

Inputs are tensors or nested lists / tuples / dicts of them (other
leaves, such as None or an int, are part of the shape's key); an input
that already is the entry's static buffer is not copied.

A graph may span several streams of the card: a step that forks streams
from the capturing stream (``Stream.wait_stream``) joins every one of
them back before it returns, as CUDA's stream capture requires; waits
between the forked streams are captured with it.

Segments: a step that exchanges tensors with other processes on the
host (a gather no graph can hold) is written as a generator that yields
the tensors it sends at each exchange and receives what the step's
``exchange`` returns (the gathered tensors). It is captured as one graph
a segment between exchanges; a call replays segment k, exchanges its
tensors on the host into the static buffers segment k + 1 reads, and so
on. Every process captures and replays in step, so the exchanges pair
up.

One graph per input shape (jit's cache per shape), captured after two
eager warm-up calls on a side stream, which fill the cached device
tables, cuFFT's plans and the kernel library's build. A capture that
fails raises :class:`CaptureError` with the failing operation's message;
there is no eager fallback on the card. On the CPU each call runs the
step eagerly where the card replays, through the same copy-in,
copy-back and output buffers; its first call per shape runs under a
guard that raises :class:`CaptureError` on an operation that would
refuse capture on the card (a host read of a device value, an output
whose size depends on the data).

Launch accounting: a kernel wrapper counts its launches in its Python
body, which under replay runs only at capture. Each graph records the
wrappers' counts during its capture and adds them on every replay, so
the counts equal the eager step's.

Tracing (``runtime.tracing``, when enabled): a call's input copies are
span ``fdc.copy_in`` (their bytes counter ``h2d_bytes``; a page-locked
input's copy is only queued there), a new shape's
capture ``fdc.capture`` (on the CPU its first, guarded run; counter
``graph_captures``), the replay ``fdc.replay`` (on the CPU the eager
run), and a synchronisation of the step's stream after it
``fdc.device_wait``, which only tracing adds. A fill of a staging slot
that waits for its last copy-in counts ``stage_waits``; a copy into a
host mirror is span ``fdc.to_host`` (counter ``d2h_bytes``).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import inspect
import sys
import weakref
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fdc_tpu_torch.runtime import tracing

__all__ = [
    "CaptureError",
    "CompiledStep",
    "GraphPool",
    "HostMirror",
    "StagingSlot",
    "StaticCarry",
    "compiled_ring",
    "drive",
    "install_carry",
    "launch_counters",
]

# (module, attribute) of every kernel wrapper that counts its launches
COUNTED = (
    ("fdc_tpu_torch.ops.extract_fused", "extract_shared"),
    ("fdc_tpu_torch.ops.extract_fused", "extract_shared_fold"),
    ("fdc_tpu_torch.ops.extract_fused", "extract_static"),
    ("fdc_tpu_torch.ops.detect", "candidate_packs"),
    ("fdc_tpu_torch.ops.detect", "greedy_accept_batch"),
    ("fdc_tpu_torch.ops.lifecycle", "slot_lifecycle_multi"),
    ("fdc_tpu_torch.ops.powact", "powact_flags"),
    ("fdc_tpu_torch.ops.fft", "forward_spectrum_four_step"),
    ("fdc_tpu_torch.ops.fft", "forward_spectrum_two_pass"),
    ("fdc_tpu_torch.ops.fft", "forward_spectrum_cluster"),
    ("fdc_tpu_torch.ops.probes", "tile_probe"),
)


class CaptureError(RuntimeError):
    """The step cannot be captured as a CUDA graph (on the CPU: it runs an
    operation that would refuse capture on the card)."""


@contextlib.contextmanager
def _collector_paused():
    """Python's cyclic garbage collector held off inside the block: a
    CUDA graph it frees while another is being captured (the freed graph's
    reset) invalidates that capture. Garbage waits for the next
    collection after the block."""
    if not gc.isenabled():
        yield
        return
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def launch_counters():
    """The kernel wrappers as their modules bind them now (a wrapper
    counts into the object its module's name refers to), each once."""
    fns = {}
    for mod, name in COUNTED:
        fn = getattr(importlib.import_module(mod), name)
        fns[id(fn)] = fn
    return list(fns.values())


class GraphPool:
    """One CUDA graph memory pool shared by the graphs of one owner's
    steps (``torch.cuda.graph_pool_handle``), made at the first capture.
    Graphs that share a pool must not run concurrently, and one graph's
    outputs are only valid until another of them replays."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def renew(self):
        """A new pool from the next capture on: once every graph of a pool
        is gone, the allocator frees it and refuses captures into it."""
        self._handle = None


class StaticCarry:
    """The static carry of one step, or of every step of a ring that
    advances one carry: the leaves the graphs read and write back."""

    def __init__(self):
        self.tree = None


# -- trees of tensors ---------------------------------------------------------

def _map(fn, tree):
    """fn over the tensor leaves of nested dicts / lists / tuples; other
    leaves as they are."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _pairs(a, b, path="carry"):
    """(path, a leaf, b leaf) over the tensor leaves of two trees of one
    structure, walked in ``a``'s order (dicts matched by key)."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            raise ValueError(f"{path}: keys {sorted(a)} against "
                             f"{sorted(b) if isinstance(b, dict) else b!r}")
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            raise ValueError(f"{path}: {len(a)} entries against {b!r}")
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        if not isinstance(b, torch.Tensor):
            raise ValueError(f"{path}: a tensor against {type(b).__name__}")
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"{path}: {a.dtype}{list(a.shape)} against "
                             f"{b.dtype}{list(b.shape)}")
        yield path, a, b


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _signature(tree):
    """A hashable key of an input tree: each tensor leaf's (shape, dtype),
    other leaves as they are."""
    if isinstance(tree, dict):
        return tuple((k, _signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_signature(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    return tree


def _storage(t):
    """The address range of the storage behind ``t``."""
    s = t.untyped_storage()
    return s.data_ptr(), s.data_ptr() + s.nbytes()


def _overlaps(t, spans):
    lo, hi = _storage(t)
    return any(lo < h and l < hi for l, h in spans)


def _same(a, b):
    """The same elements in the same layout."""
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype)


def _own(t, device):
    """A copy of ``t`` on ``device`` in an allocation of its own."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


# -- the CPU's capture guard ---------------------------------------------------

_aten = torch.ops.aten
# operations that read a device value on the host, or size their output
# by the data: on the card each synchronizes, which a capture refuses
_REFUSED = {
    _aten._local_scalar_dense, _aten.nonzero, _aten.masked_select,
    _aten.unique_consecutive, _aten._unique, _aten._unique2,
    _aten.unique_dim, _aten.equal, _aten.is_nonzero, _aten.bincount,
}
_MASK_INDEXED = {_aten.index, _aten.index_put, _aten.index_put_,
                 _aten._index_put_impl_}


def _refuses_capture(func, args, kwargs) -> bool:
    op = func.overloadpacket
    if op in _REFUSED:
        return True
    if op is _aten.repeat_interleave:
        return kwargs.get("output_size") is None
    if op in _MASK_INDEXED:
        return any(isinstance(i, torch.Tensor)
                   and i.dtype in (torch.bool, torch.uint8)
                   for i in args[1] if i is not None)
    return False


def _in_plain_version() -> bool:
    """Whether a kernel's plain version (a ``*_plain`` function of
    ``fdc_tpu_torch.ops``) is on the stack: on the card it is one kernel
    launch, whatever it does on the CPU."""
    f = sys._getframe(2)
    while f is not None:
        if (f.f_code.co_name.endswith("_plain") and f.f_globals.get(
                "__name__", "").startswith("fdc_tpu_torch.ops")):
            return True
        f = f.f_back
    return False


class _CaptureGuard(TorchDispatchMode):
    """Raises :class:`CaptureError` on an operation a CUDA graph capture
    would refuse, outside the kernels' plain versions."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _refuses_capture(func, args, kwargs) and not _in_plain_version():
            raise CaptureError(
                f"{func} would refuse CUDA graph capture (a host read of a "
                f"device value, or an output sized by the data)")
        return func(*args, **kwargs)


# -- the compiled step ---------------------------------------------------------

def drive(result, exchange):
    """A step's (new_carry, out): ``result`` itself, or where the step is
    a generator (a segmented step), its return value, each list of
    tensors it yields answered with ``exchange(tensors)``."""
    if not inspect.isgenerator(result):
        return result
    try:
        sent = next(result)
        while True:
            sent = result.send(exchange(sent))
    except StopIteration as stop:
        return stop.value


class _Entry:
    """One input shape's static inputs, graphs (one a segment), the
    exchanges between them, outputs and launches."""

    def __init__(self, inputs):
        self.inputs = inputs
        self.graphs = []
        self.exchanges = []  # (tensors a segment sends, buffers it receives)
        self.out = None
        self.launches = {}
        self.clone_new = set()  # new-carry leaves that alias the static carry
        self.clone_out = set()  # outputs that alias it


class CompiledStep:
    """``fn(carry, *inputs[, t0]) -> (new_carry, out)`` replayed as one
    CUDA graph per input shape on the card (see the module docstring).

    Call it as the step: ``carry, out = step(carry, *inputs, t0)``, with
    ``inputs`` trees of tensors on any device (a host tensor is copied to
    the card) and ``t0`` an int; a step without a carry takes and returns
    None. ``fn`` (a bound method is held weakly, so the step does not
    keep its owner alive) stays reachable as :attr:`fn`, and
    :meth:`eager` runs it. ``carry``: a :class:`StaticCarry` shared with
    other steps (a ring's). ``exchange``: for a step that yields at
    exchanges between processes (module docstring), the host function
    from the tensors it yields to the tensors it receives.
    """

    def __init__(self, fn, device, *, pool: Optional[GraphPool] = None,
                 takes_t0: bool = True, carry: Optional[StaticCarry] = None,
                 exchange=None):
        if inspect.ismethod(fn):
            self._fn = weakref.WeakMethod(fn)
        else:
            self._fn = lambda: fn
        self.device = torch.device(device)
        self.pool = pool if pool is not None else GraphPool()
        self.takes_t0 = takes_t0
        self.exchange = exchange
        self._static = carry if carry is not None else StaticCarry()
        self.release()

    @property
    def _carry(self):
        return self._static.tree

    @_carry.setter
    def _carry(self, tree):
        self._static.tree = tree

    @property
    def fn(self):
        """The eager step function."""
        return self._fn()

    def release(self):
        """Drop the graphs, their outputs and the static carry (a reset
        stream; the next call captures anew, into a new pool)."""
        self._carry = None
        self._entries = {}
        self.pool.renew()
        self._t0 = torch.zeros((), dtype=torch.int32, device=self.device)

    def eager(self, carry, *args):
        """The step run eagerly, without graph or static buffers, its
        tensor arguments moved to the step's device (the path of a caller
        that opts out)."""
        return drive(self.fn(carry, *(_map(
            lambda t: t.to(self.device), a) for a in args)), self.exchange)

    def owns(self, carry) -> bool:
        """Whether ``carry`` is this step's static carry."""
        return carry is not None and carry is self._carry

    def adopt(self, carry):
        """Copy ``carry`` into the static carry (allocated on the first
        call, then written in place: the graphs read it) and return it."""
        if self._carry is None:
            self._carry = _map(lambda t: _own(t, self.device), carry)
            return self._carry
        for _, s, c in _pairs(self._carry, carry):
            if not _same(s, c):
                s.copy_(c)
        return self._carry

    def __call__(self, carry, *args):
        inputs, t0 = (args[:-1], args[-1]) if self.takes_t0 else (args, None)
        if carry is not self._carry:
            self.adopt(carry)
        key = tuple(_signature(x) for x in inputs)
        entry = self._entries.get(key)
        fresh = entry is None
        if fresh:
            entry = _Entry(_map(lambda x: torch.empty(
                x.shape, dtype=x.dtype, device=self.device), list(inputs)))
        cuda = self.device.type == "cuda"
        with tracing.span("fdc.copy_in"):
            for _, buf, x in _pairs(entry.inputs, list(inputs), "inputs"):
                if not _same(buf, x):
                    buf.copy_(x, non_blocking=cuda and x.is_pinned())
                    tracing.count("h2d_bytes", buf.nbytes)
            if t0 is not None:
                self._t0.fill_(int(t0))
        if fresh:
            tracing.count("graph_captures", 1)
        if cuda:
            with torch.cuda.device(self.device):
                start = 0
                if fresh:
                    with tracing.span("fdc.capture"):
                        # the capture ran every segment but the last
                        start = self._capture(entry)
                with tracing.span("fdc.replay"):
                    self._replay(entry, start)
            for fn, n in entry.launches.items():
                fn.launches += n
        elif fresh:
            with tracing.span("fdc.capture"), _CaptureGuard():
                out = self._body(entry, fresh=True)
            entry.out = _map(lambda t: _own(t, self.device), out)
        else:
            with tracing.span("fdc.replay"):
                out = self._body(entry, fresh=False)
                for _, o, t in _pairs(entry.out, out, "out"):
                    o.copy_(t)
        if tracing.enabled():
            with tracing.span("fdc.device_wait"):
                if cuda:
                    torch.cuda.current_stream(self.device).synchronize()
        if fresh:
            self._entries[key] = entry
        return self._carry, entry.out

    def _args(self, carry, entry):
        return [carry, *entry.inputs] + ([self._t0] if self.takes_t0 else [])

    def _replay(self, entry, start):
        """Segments ``start``... of the entry's step, each followed by its
        exchange on the host into the buffers the next one reads."""
        for k in range(start, len(entry.graphs)):
            entry.graphs[k].replay()
            if k < len(entry.exchanges):
                mine, every = entry.exchanges[k]
                for buf, got in zip(every, self.exchange(mine)):
                    buf.copy_(got)

    def _body(self, entry, fresh, on_yield=None):
        """The step from the static buffers, its new carry copied back into
        the static carry; returns the outputs. The aliasing of the new
        carry and the outputs with the static carry is read on the first
        run (the capture) by address ranges: a leaf that overlaps it is
        cloned first, so the copy-back neither reads a leaf it already
        overwrote nor changes an output. ``on_yield`` answers a segmented
        step's exchanges (default: ``exchange``)."""
        new, out = drive(self.fn(*self._args(self._carry, entry)),
                         on_yield or self.exchange)
        pairs = list(_pairs(self._carry, new))
        out_leaves = list(_leaves(out))
        if fresh:
            spans = [_storage(s) for _, s, _ in pairs]
            entry.clone_new = {i for i, (_, s, n) in enumerate(pairs)
                               if not _same(s, n) and _overlaps(n, spans)}
            entry.clone_out = {i for i, o in enumerate(out_leaves)
                               if _overlaps(o, spans)}
        if entry.clone_out:
            ids = {id(o) for i, o in enumerate(out_leaves)
                   if i in entry.clone_out}
            out = _map(lambda t: t.clone() if id(t) in ids else t, out)
        news = [n.clone() if i in entry.clone_new else n
                for i, (_, _, n) in enumerate(pairs)]
        for (_, s, _), n in zip(pairs, news):
            if not _same(s, n):
                s.copy_(n)
        return out

    def _capture(self, entry):
        """Two eager warm-up calls on a side stream (on a clone of the
        carry, so the stream's state does not move), then the capture on
        it; the wrappers' counts are put back as they were and the
        capture's kept as the graph's launches. A segmented step's
        capture ends at each exchange, replays the segment so that what
        it sends has its values, exchanges it into buffers of its own
        (the next segment's static inputs) and captures the next segment.
        Returns the first segment the call has yet to replay. The capture
        is begun and ended directly: ``torch.cuda.graph`` would also run
        ``gc.collect()`` and empty the allocator's cache before it, a
        cost that grows with the host's heap. The garbage collector is
        paused instead from the first segment's capture to the last's
        end, so that no unreachable graph (a dropped channelizer's) is
        freed inside a capture."""
        counters = launch_counters()
        before = {fn: fn.launches for fn in counters}
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        capturing = [False]

        def begin():
            entry.graphs.append(torch.cuda.CUDAGraph())
            entry.graphs[-1].capture_begin(pool=self.pool.handle())
            capturing[0] = True

        def end():
            capturing[0] = False
            entry.graphs[-1].capture_end()

        def exchange(mine):
            end()
            entry.graphs[-1].replay()
            every = self.exchange(mine)
            entry.exchanges.append((mine, every))
            begin()
            return every

        try:
            with torch.cuda.stream(side):
                for _ in range(2):
                    drive(self.fn(*self._args(
                        _map(torch.clone, self._carry), entry)),
                        self.exchange)
                warm = {fn: fn.launches for fn in counters}
                try:
                    with _collector_paused():
                        begin()
                        try:
                            entry.out = self._body(entry, fresh=True,
                                                   on_yield=exchange)
                        finally:
                            if capturing[0]:
                                end()
                except RuntimeError as e:
                    self.pool.renew()  # the failed graph leaves it unusable
                    raise CaptureError(f"the step does not capture as a "
                                       f"CUDA graph: {e}") from e
            entry.launches = {fn: fn.launches - warm[fn] for fn in counters
                              if fn.launches != warm[fn]}
        finally:
            for fn in counters:
                fn.launches = before[fn]
            cur.wait_stream(side)
        return len(entry.graphs) - 1


def compiled_ring(fn, device, depth: int, *, pools=None,
                  takes_t0: bool = True, carry: Optional[StaticCarry] = None):
    """``depth`` compiled steps of ``fn``, slot k with graph pool
    ``pools[k]`` (default: a pool each; steps on one stream may share a
    slot's pool with another ring's slot k), all sharing one static carry:
    a caller that consumes a call's outputs up to ``depth - 1`` calls of
    the ring late gives call n the slot n % depth."""
    pools = pools or [GraphPool() for _ in range(depth)]
    carry = carry if carry is not None else StaticCarry()
    return [CompiledStep(fn, device, pool=pools[k], takes_t0=takes_t0,
                         carry=carry) for k in range(depth)]


def install_carry(steps, current, carry):
    """``carry`` (made outside the step: a restored checkpoint) written
    into the static carry of the step in ``steps`` that owns ``current``,
    the stream's carry, whose graphs read it; ``carry`` itself where none
    does (the next compiled call copies it in)."""
    for step in steps:
        if step.owns(current):
            return step.adopt(carry)
    return carry


# -- host memory that meets a step ---------------------------------------------

class StagingSlot:
    """A step's host input, written in place each call and kept across
    calls: complex64, page-locked where the step's ``device`` is CUDA, so
    that the step's copy-in does not block the host. Made on the first
    :meth:`fill` and again when the shape changes."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.tensor = None
        self._read = None  # the event behind the step that last read it

    def fill(self, shape, *parts) -> torch.Tensor:
        """The slot of ``shape`` written with the arrays ``parts`` one
        after another along its first axis, each converted as
        ``np.asarray(part, np.complex64)`` converts; returned once the step
        that last read it has copied it in (a wait is counted as
        ``stage_waits``)."""
        slot = self.tensor
        if slot is None or tuple(slot.shape) != tuple(shape):
            cuda = self.device.type == "cuda"
            slot = self.tensor = torch.empty(shape, dtype=torch.complex64,
                                             pin_memory=cuda)
            self._read = torch.cuda.Event() if cuda else None
        elif self._read is not None and not self._read.query():
            tracing.count("stage_waits", 1)
            self._read.synchronize()
        row = 0
        for part in parts:
            dst = slot[row:row + len(part)]
            row += len(part)
            # torch's copy splits a large copy over its intra-op threads:
            # taken where torch can take the part as it is
            if (part.dtype in (np.complex64, np.complex128)
                    and part.flags.c_contiguous and part.flags.writeable):
                dst.copy_(torch.from_numpy(part))
            else:
                dst.numpy()[...] = part
        return slot

    def read(self):
        """The step that copies the slot in is queued on the device's
        current stream: the slot's next fill waits for it."""
        if self._read is not None:
            self._read.record(torch.cuda.current_stream(self.device))


class HostMirror:
    """A host copy of a step's output tree, kept across calls: a leaf for
    each tensor leaf, whatever its device, of its shape and dtype, all
    views of one buffer (page-locked where a leaf is on the card, so that
    the copies into it do not block the host). The buffer is made on the
    first :meth:`copy` and again only when the leaves' shapes, dtypes or
    devices change."""

    _ALIGN = 256  # bytes between the starts of two leaves

    def __init__(self):
        self.signature = None
        self.buffer = None
        self._leaves = []  # tensors over ``buffer``
        self._arrays = []  # their numpy views
        self._done = {}  # CUDA device copied from -> the event behind it
        self._nbytes = 0

    def _fit(self, srcs: list):
        sig = tuple((tuple(t.shape), t.dtype, t.device) for t in srcs)
        if sig == self.signature:
            return
        offsets, end = [], 0
        for t in srcs:
            offsets.append(end)
            end += -(-t.nbytes // self._ALIGN) * self._ALIGN
        self._done = {t.device: torch.cuda.Event() for t in srcs
                      if t.device.type == "cuda"}
        self.buffer = torch.empty(end, dtype=torch.uint8,
                                  pin_memory=bool(self._done))
        self._leaves = [
            self.buffer[o:o + t.nbytes].view(t.dtype).view(t.shape)
            for o, t in zip(offsets, srcs)]
        self._arrays = [t.numpy() for t in self._leaves]
        self._nbytes = sum(t.nbytes for t in srcs)
        self.signature = sig

    def copy(self, tree):
        """``tree`` with its tensor leaves copied into the mirror, in the
        tree's order, as numpy views of it (other leaves as they are);
        returns once every copy has landed: an event recorded on each
        source device's current stream, which the copies were queued on,
        then each waited for. A tree without tensor leaves leaves the
        mirror as it is."""
        srcs = list(_leaves(tree))
        if srcs:
            self._fit(srcs)
            for dst, src in zip(self._leaves, srcs):
                dst.copy_(src, non_blocking=True)
            for dev, done in self._done.items():
                done.record(torch.cuda.current_stream(dev))
            for done in self._done.values():
                done.synchronize()
            tracing.count("d2h_bytes", self._nbytes)
        arrays = iter(self._arrays)
        return _map(lambda _: next(arrays), tree)


def _to_host(tree, mirror: HostMirror):
    """Nested dicts, lists and tuples of tensors -> the same tree of numpy
    arrays, copied through ``mirror`` (a compiled step's next call
    overwrites its output tensors, on the CPU too); numpy leaves, as a
    host pipeline's worker ships them, pass as they are. The next copy
    through the same mirror overwrites the arrays: nothing that outlives
    the caller's use of this batch may point into them."""
    with tracing.span("fdc.to_host"):
        return mirror.copy(tree)
