# Copied from fdc_tpu/parallel/hostpipe.py: the codec, the framing and _WorkerConn (held equal by tests/test_torch_copies.py); the owner and the worker are the port's.
"""Cross-process batch pipeline: the MPMD pipeline's multi-host leg.

Port of ``fdc_tpu.parallel.hostpipe``. The single-process
:class:`~fdc_tpu_torch.parallel.pipeline.PipelineChannelizer` keeps one
scan-owner chain and farms whole batches over local lanes. This module
stretches the same split over processes: the owner keeps the serial
stage-B scan chain and the merged, in-order emission, while every
process (the owner included) runs stages A (front end, static
extraction, candidate packs) and C (slot extraction) for its share of
batches on its own lanes.

Only the pipeline's true dependencies cross processes:

- worker -> owner PACKS: the [B, 7K] candidate packs (kernel C's layout)
  and the burst power columns (KB scale);
- owner -> worker PLANS: the post-scan slot tables and extraction plans
  (KB scale);
- worker -> owner OUT: the batch's extraction outputs for the merged
  emission and stream assembly (the bulk payload; the owner is the one
  event and stream sink).

The transport is a length-prefixed TCP message protocol carrying a typed
numpy tree (no pickle): ``fdc_tpu``'s codec and payload layout (complex
leaves as float32 [..., 2] pairs), so a port owner serves an ``fdc_tpu``
worker and the other way round. Batch b of the stream (counted from the
stream's start, ``t0 // batch_blocks``) belongs to process b % n_hosts;
every process feeds the same sample stream to ``process``, in chunks of
any size. The owner consumes batches strictly in order, so the merged
events equal the single-process pipeline's.

Scope: ``process`` (sample mode) is distributed; ``flush`` and the
finalize batches run owner-local, and ``process_spectra`` is refused.

Both ends run the pipeline's compiled stages (JAX: the jitted stages,
``parallel/hostpipe.py:369,387,513,542``): the owner's B ring holds
``window * n_hosts`` slots (its consume frontier lags by that many
batches), a worker's A / C rings two (it ships a batch's outputs before
its slot runs again).
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from queue import Queue
from typing import List, Optional

import numpy as np

from fdc_tpu_torch.config import ChannelizerConfig
from fdc_tpu_torch.convert import carry_from_numpy
from fdc_tpu_torch.parallel.pipeline import PipelineChannelizer
from fdc_tpu_torch.runtime.compiled import HostMirror, _to_host

__all__ = ["HostPipelineOwner", "HostPipelineWorker"]


# ---------------------------------------------------------------------------
# typed numpy pytree codec (length-prefixed; no pickle)
# ---------------------------------------------------------------------------

_MAGIC = b"FDCP"
_VERSION = 1


def _enc_tree(obj, bufs):
    """obj -> JSON-able spec; numpy arrays appended to ``bufs``."""
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, (bool, np.bool_)):
        return {"t": "b", "v": bool(obj)}
    if isinstance(obj, (int, np.integer)):
        return {"t": "i", "v": int(obj)}
    if isinstance(obj, (float, np.floating)):
        return {"t": "f", "v": float(obj)}
    if isinstance(obj, str):
        return {"t": "s", "v": obj}
    if isinstance(obj, dict):
        keys = list(obj.keys())
        if not all(isinstance(k, (str, int)) for k in keys):
            raise TypeError(f"unsupported dict key types: {keys!r}")
        return {
            "t": "d",
            "k": [[("s" if isinstance(k, str) else "i"), k] for k in keys],
            "v": [_enc_tree(obj[k], bufs) for k in keys],
        }
    if isinstance(obj, tuple):
        return {"t": "t", "v": [_enc_tree(x, bufs) for x in obj]}
    if isinstance(obj, list):
        return {"t": "l", "v": [_enc_tree(x, bufs) for x in obj]}
    a = np.asarray(obj)  # numpy scalars/arrays and jax arrays
    a = np.ascontiguousarray(a)
    bufs.append(a.tobytes())
    return {"t": "a", "d": a.dtype.str, "sh": list(a.shape)}


def _dec_tree(spec, bufs, pos):
    t = spec["t"]
    if t == "none":
        return None, pos
    if t in ("b", "i", "f", "s"):
        return spec["v"], pos
    if t == "d":
        out = {}
        for (kt, k), v in zip(spec["k"], spec["v"]):
            out[k if kt == "s" else int(k)], pos = _dec_tree(v, bufs, pos)
        return out, pos
    if t in ("t", "l"):
        vals = []
        for v in spec["v"]:
            x, pos = _dec_tree(v, bufs, pos)
            vals.append(x)
        return (tuple(vals) if t == "t" else vals), pos
    if t == "a":
        a = np.frombuffer(bufs[pos], dtype=np.dtype(spec["d"])).reshape(
            spec["sh"]
        )
        return a, pos + 1
    raise ValueError(f"bad spec type {t!r}")


def _send_msg(sock: socket.socket, kind: str, batch: int, payload):
    bufs: List[bytes] = []
    spec = _enc_tree(payload, bufs)
    header = json.dumps(
        {"k": kind, "b": batch, "spec": spec, "n": [len(x) for x in bufs]}
    ).encode()
    parts = [
        _MAGIC, struct.pack("<II", _VERSION, len(header)), header
    ] + bufs
    sock.sendall(b"".join(parts))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        c = sock.recv(min(n, 1 << 20))
        if not c:
            raise ConnectionError("peer closed mid-message")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket):
    magic = _recv_exact(sock, 4)
    if magic != _MAGIC:
        raise ConnectionError(f"bad magic {magic!r}")
    ver, hlen = struct.unpack("<II", _recv_exact(sock, 8))
    if ver != _VERSION:
        raise ConnectionError(f"protocol version {ver} != {_VERSION}")
    h = json.loads(_recv_exact(sock, hlen))
    bufs = [_recv_exact(sock, n) for n in h["n"]]
    payload, _ = _dec_tree(h["spec"], bufs, 0)
    return h["k"], h["b"], payload


# ---------------------------------------------------------------------------
# owner
# ---------------------------------------------------------------------------


class _WorkerConn:
    """One worker's connection: a reader thread demuxing messages by kind
    (PACKS and OUT interleave on the wire; the owner must never block on
    one kind while the other backs up the socket)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.queues = {"PACKS": Queue(), "OUT": Queue(), "BYE": Queue()}
        self._err: Optional[BaseException] = None
        self._th = threading.Thread(target=self._read_loop, daemon=True)
        self._th.start()

    def _read_loop(self):
        try:
            while True:
                kind, b, payload = _recv_msg(self.sock)
                self.queues[kind].put((b, payload))
                if kind == "BYE":
                    return
        except BaseException as e:  # surfaced on next get()
            self._err = e
            for q in self.queues.values():
                q.put((-1, None))

    def get(self, kind: str, timeout: float):
        from queue import Empty

        try:
            b, payload = self.queues[kind].get(timeout=timeout)
        except Empty:
            raise ConnectionError(
                f"timed out after {timeout:.0f}s waiting for a {kind} "
                f"message from the worker (is it still running?)"
            ) from None
        if b == -1 and self._err is not None:
            raise ConnectionError(
                f"worker connection failed: {self._err!r}"
            ) from self._err
        return b, payload

    def send(self, kind: str, batch: int, payload):
        _send_msg(self.sock, kind, batch, payload)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


def _global_batch(fdc) -> int:
    """The stream's index of the next batch: host assignment follows the
    stream, not the chunking of the ``process`` calls."""
    return fdc._t0 // fdc.config.batch_blocks


class HostPipelineOwner(PipelineChannelizer):
    """The owner end of the cross-process pipeline.

    Listens for ``n_workers`` worker connections; ``process`` then runs
    the stage-B scan chain for every batch (in batch order) while stages
    A and C of the workers' batches run in their processes. Events and
    streams come out of the owner's result only, equal to the
    single-process pipeline's. Every socket wait ends after ``timeout``
    seconds."""

    def __init__(self, config: Optional[ChannelizerConfig] = None,
                 n_workers: int = 1, port: int = 0,
                 bind_addr: str = "127.0.0.1", timeout: float = 240.0,
                 **kwargs):
        # the stage rings are sized by the hosts (_ring_depths)
        self.n_hosts = int(n_workers) + 1
        super().__init__(config, **kwargs)
        if self._owner_groups or self.shard_time > 1:
            raise ValueError(
                "HostPipelineOwner composes across HOSTS; in-process "
                "shard_time/scan_owners composition is not supported "
                "here (use PipelineChannelizer for those)"
            )
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.timeout = float(timeout)
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((bind_addr, port))
        self._lsock.listen(n_workers)
        self.port = self._lsock.getsockname()[1]
        self._conns: List[Optional[_WorkerConn]] = [None] * n_workers
        self._local_only = False
        # the host mirror the slot tables and plans are shipped from
        self._plans_mirror = HostMirror()

    def _ring_depths(self):
        # up to window * n_hosts batches in flight, about window of them
        # the owner's own, all of which may run on one lane
        return self.window, self.window * self.n_hosts

    def accept_workers(self):
        """Block until every worker has connected and identified itself
        (HELLO carries its host id 1..n_workers and its config)."""
        self._lsock.settimeout(self.timeout)
        pending = [i for i, c in enumerate(self._conns) if c is None]
        while pending:
            s, _ = self._lsock.accept()
            s.settimeout(self.timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            kind, hid, payload = _recv_msg(s)
            s.settimeout(None)  # the reader thread blocks; get() times out
            if kind != "HELLO" or not 1 <= hid < self.n_hosts:
                s.close()
                raise ConnectionError(
                    f"bad worker hello: {kind} host={hid}"
                )
            if payload != self.config.to_json():
                s.close()
                raise ValueError(
                    "worker config fingerprint mismatch — all hosts must "
                    "construct the identical ChannelizerConfig"
                )
            self._conns[hid - 1] = _WorkerConn(s)
            pending = [i for i, c in enumerate(self._conns) if c is None]

    def close(self):
        for c in self._conns:
            if c is not None:
                c.close()
        self._lsock.close()

    # -- distributed process -------------------------------------------------

    def process(self, samples: np.ndarray):
        if self._local_only:
            return super().process(samples)
        if any(c is None for c in self._conns):
            self.accept_workers()
        cfg = self.config
        if self._spectra_mode:
            raise RuntimeError(
                "process() called on a stream already driven by "
                "process_spectra()"
            )
        self._samples_mode = True
        self._adopt_carry()
        x = np.concatenate([self._pending,
                            np.asarray(samples, np.complex64)])
        bs = self.batch_samples
        n_batches = len(x) // bs
        self._pending = x[n_batches * bs:]

        result = self._new_result()
        dbg = []
        inflight = []  # (batch, host, batch parts or None)
        for k in range(n_batches):
            chunk = x[k * bs:(k + 1) * bs]
            b = _global_batch(self)
            host = b % self.n_hosts
            if host == 0:
                lane = self.worker_lanes[b % len(self.worker_lanes)]
                parts = self._dispatch([lane], self._sample_runs(1, chunk),
                                       self._t0)
            else:
                # the owner still advances the framing tail so its own
                # batches stay continuous
                self._advance_tail(chunk)
                self._take_override()
                conn = self._conns[host - 1]
                pb, packs = conn.get("PACKS", self.timeout)
                if pb != b:
                    raise ConnectionError(
                        f"worker {host} sent packs for batch {pb}, "
                        f"expected {b} (protocol desync)"
                    )
                parts = self._scan_remote_batch(conn, b, packs)
            inflight.append((b, host, parts))
            self._t0 += cfg.batch_blocks
            if len(inflight) >= self.window * self.n_hosts:
                self._consume_one(inflight.pop(0), result, dbg)
        while inflight:
            self._consume_one(inflight.pop(0), result, dbg)
        if dbg:
            result.debug_spectrum = np.concatenate(dbg)
        return result

    def _scan_remote_batch(self, conn, b, packs):
        """Stage B for a worker's batch: the scan on the owner lane from
        the shipped packs; the post-scan slot tables and plans go back.
        Returns the batch's scans and cursor."""
        dev = self.devices[0]
        pa = packs.get("pa_powers")
        with self._on(0):
            # carry_from_numpy copies: the decoded arrays are read-only
            # views of the received bytes
            pa_o = None if pa is None else [carry_from_numpy(pa, dev)]
            segk_o = [carry_from_numpy(packs["seg_packed"], dev)]
        scans = self._scan_parts(pa_o, segk_o)
        with self._on(0):
            states, plans = _to_host((
                [st for st, _ in scans["segs"]],
                [{k: so[k] for k in ("slot_ids", "slot_ids_narrow") if k in so}
                 for _, so in scans["segs"]]), self._plans_mirror)
        conn.send("PLANS", b, {"states": states, "plans": plans})
        return scans, self._t0

    def _consume_one(self, entry, result, dbg):
        b, host, parts = entry
        if host == 0:
            self._consume_pipeline_batch(parts, result, dbg)
            return
        scans, t0_b = parts
        conn = self._conns[host - 1]
        ob, payload = conn.get("OUT", self.timeout)
        if ob != b:
            raise ConnectionError(
                f"worker {host} sent outputs for batch {ob}, expected {b}"
            )
        self._consume_pipeline_batch(
            (payload["out_static"], payload["pa_ext"],
             payload["seg_powers"], payload["dbg"], scans,
             payload["extracts"], t0_b, None),
            result, dbg,
        )

    def flush(self, finalize: bool = True):
        """End of stream: the remainder and the finalize batches run
        owner-local (correctness over parallelism at stream end)."""
        self._local_only = True
        try:
            return super().flush(finalize=finalize)
        finally:
            self._local_only = False

    def process_spectra(self, spectra):
        raise RuntimeError(
            "HostPipelineOwner distributes sample-mode process() only; "
            "for pre-FFT'd vector streams use PipelineChannelizer "
            "(single process)"
        )


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------


class HostPipelineWorker(PipelineChannelizer):
    """A worker end of the cross-process pipeline: stages A and C of its
    batches on its lanes, stage B round-tripped to the owner. ``process``
    returns an empty result: events and streams come out of the owner."""

    def __init__(self, config: Optional[ChannelizerConfig] = None,
                 host_id: int = 1, n_hosts: int = 2,
                 owner_addr: str = "127.0.0.1", owner_port: int = 0,
                 timeout: float = 240.0, **kwargs):
        super().__init__(config, **kwargs)
        if self._owner_groups or self.shard_time > 1:
            raise ValueError(
                "HostPipelineWorker does not compose with in-process "
                "shard_time/scan_owners"
            )
        if not 1 <= host_id < n_hosts:
            raise ValueError("worker host_id must be in [1, n_hosts)")
        self.host_id = int(host_id)
        self.n_hosts = int(n_hosts)
        self.timeout = float(timeout)
        self._sock = socket.create_connection(
            (owner_addr, owner_port), timeout=timeout
        )
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _send_msg(self._sock, "HELLO", self.host_id, self.config.to_json())
        # the host mirrors the packs and the outputs are shipped from
        self._packs_mirror, self._out_mirror = HostMirror(), HostMirror()

    def _ring_depths(self):
        # the ship window of 2: one batch unshipped when the next starts
        return 2, 1

    def close(self):
        try:
            _send_msg(self._sock, "BYE", -1, None)
        except OSError:
            pass
        self._sock.close()

    def process(self, samples: np.ndarray):
        cfg = self.config
        self._samples_mode = True
        self._adopt_carry()
        x = np.concatenate([self._pending,
                            np.asarray(samples, np.complex64)])
        bs = self.batch_samples
        n_batches = len(x) // bs
        self._pending = x[n_batches * bs:]

        inflight = []
        for k in range(n_batches):
            chunk = x[k * bs:(k + 1) * bs]
            b = _global_batch(self)
            if b % self.n_hosts != self.host_id:
                self._advance_tail(chunk)
                self._t0 += cfg.batch_blocks
                continue
            lane = self.worker_lanes[(b // self.n_hosts)
                                     % len(self.worker_lanes)]
            dev = self.devices[lane]
            slot = self._next_slot(lane, len(self._jit_front[lane]))
            ((host_in, _),) = self._sample_runs(1, chunk)
            (out_static, pa_powers, pa_ext, seg_powers, seg_packed,
             spec_ext, dbgb) = self._front(lane, slot, host_in, self._t0)
            with self._on(lane):
                packs = _to_host({"pa_powers": pa_powers,
                                  "seg_packed": list(seg_packed)},
                                 self._packs_mirror)
            _send_msg(self._sock, "PACKS", b, packs)
            kind, pb, plans_msg = _recv_msg(self._sock)
            if kind != "PLANS" or pb != b:
                raise ConnectionError(
                    f"expected PLANS for batch {b}, got {kind} {pb}"
                )
            with self._on(lane):
                states = carry_from_numpy(plans_msg["states"], dev)
                plans = carry_from_numpy(plans_msg["plans"], dev)
            extracts = self._slots_on(lane, slot, spec_ext, states, plans)
            inflight.append((b, lane, out_static, pa_ext, seg_powers, dbgb,
                             extracts))
            self._t0 += cfg.batch_blocks
            # ship window fixed at 2: the owner's consume frontier lags
            # its scan frontier by window * n_hosts >= 2 * n_hosts
            # batches, and this worker's batches are n_hosts apart, so
            # it always ships the batch the owner waits on before it
            # blocks on its next PLANS (JAX: parallel/hostpipe.py:563-572)
            if len(inflight) >= 2:
                self._ship_out(inflight.pop(0))
        while inflight:
            self._ship_out(inflight.pop(0))
        return self._new_result()  # outputs live on the owner

    def _ship_out(self, entry):
        b, lane, out_static, pa_ext, seg_powers, dbgb, extracts = entry
        with self._on(lane):
            payload = _to_host({
                "out_static": out_static,
                "pa_ext": pa_ext,
                "seg_powers": seg_powers,
                "dbg": dbgb if self.config.debug else 0,
                "extracts": extracts,
            }, self._out_mirror)
        _send_msg(self._sock, "OUT", b, payload)

    def flush(self, finalize: bool = True):
        """No-op on workers (end-of-stream batches run owner-local)."""
        return self._new_result()

    def process_spectra(self, spectra):
        raise RuntimeError(
            "HostPipelineWorker distributes sample-mode process() only "
            "(running the inherited vector-mode pipeline here would "
            "emit a duplicate event stream)"
        )
