# Copied from fdc_tpu/runtime/stream.py; only the import lines differ.
"""Host streaming driver: source -> native ring -> batched device steps.

The framework equivalent of running a GNU Radio flowgraph: a sample source
(file, socket, or caller pushes) feeds the native SPSC ring on its own
thread; the driver pops exact device batches and runs the channelizer,
collecting events and streams. Replaces the reference's
scheduler/ring-buffer runtime (SURVEY.md §1 — gr::sync_block stream
buffers) with a double-buffered native ring + one big jitted step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, List, Optional

import numpy as np

if TYPE_CHECKING:  # break the models <-> runtime import cycle
    from fdc_tpu_torch.models.channelizer import (
        FrequencyDomainChannelizer,
        ProcessResult,
    )

__all__ = ["StreamDriver", "StreamStats"]


@dataclass
class StreamStats:
    samples_in: int = 0
    blocks_processed: int = 0
    batches: int = 0
    events: int = 0


class StreamDriver:
    """Drives a channelizer from a native ring buffer.

    Args:
      channelizer: any FrequencyDomainChannelizer (incl. ShardedChannelizer).
      ring_batches: ring capacity in units of device batches.
      use_native: require the native ring (raises if unavailable); with
        False, a pure-Python deque fallback is used.
    """

    def __init__(
        self,
        channelizer: FrequencyDomainChannelizer,
        ring_batches: int = 8,
        use_native: bool = True,
    ):
        self.fdc = channelizer
        self.batch_samples = channelizer.batch_samples
        self.stats = StreamStats()
        self._ring = None
        if use_native:
            from fdc_tpu_torch.runtime import native

            if native.available():
                self._ring = native.SampleRing(
                    ring_batches * self.batch_samples
                )
            else:
                raise RuntimeError(
                    "native runtime unavailable (g++ build failed); "
                    "pass use_native=False for the Python fallback"
                )
        self._py_buf = np.zeros(0, np.complex64)
        self._tail = np.zeros(0, np.complex64)  # post-close ring remainder

    # -- producer side --------------------------------------------------------

    @property
    def ring(self):
        return self._ring

    def push(self, samples: np.ndarray, blocking: bool = True) -> int:
        """Feed samples (producer thread). Returns samples accepted."""
        self.stats.samples_in += len(samples)
        if self._ring is not None:
            return self._ring.push(samples, blocking=blocking)
        self._py_buf = np.concatenate(
            [self._py_buf, np.asarray(samples, np.complex64)]
        )
        return len(samples)

    def close(self):
        if self._ring is not None:
            self._ring.close()

    # -- consumer side --------------------------------------------------------

    def _pop_batch(self, timeout: float) -> Optional[np.ndarray]:
        if self._ring is not None:
            # The native blocking pop consumes nothing on timeout (returns 0
            # samples) and returns a partial batch only after close — keep
            # such a post-close tail for flush() instead of discarding it
            # (ring.cc fdc_ring_pop_blocking).
            got = self._ring.pop(self.batch_samples, blocking=True,
                                 timeout=timeout)
            if len(got) == self.batch_samples:
                return got
            if len(got):
                self._tail = np.concatenate([self._tail, got])
            return None
        if len(self._py_buf) >= self.batch_samples:
            out = self._py_buf[: self.batch_samples]
            self._py_buf = self._py_buf[self.batch_samples:]
            return out
        return None

    def drain_pending(self):
        """Move the sub-batch stream tail (post-close ring remainder +
        python-fallback buffer) into the channelizer's pending buffer,
        where it is carried by checkpoints and consumed by flush()."""
        tail = self._tail
        self._tail = np.zeros(0, np.complex64)
        if self._ring is not None and len(self._ring):
            tail = np.concatenate(
                [tail, self._ring.pop(len(self._ring), blocking=False)]
            )
        if len(self._py_buf):
            tail = np.concatenate([tail, self._py_buf])
            self._py_buf = np.zeros(0, np.complex64)
        if len(tail):
            self.fdc.process(tail)  # < one batch: buffers into _pending

    def flush(self) -> Optional[ProcessResult]:
        """Process the sub-batch stream tail via the channelizer's
        zero-pad-and-trim flush (which by default also finalizes
        still-open bursts — see FrequencyDomainChannelizer.flush). None
        only if nothing was pending AND no finalize events were emitted:
        a batch-aligned capture with an open burst still returns its
        finalize events."""
        self.drain_pending()
        res = self.fdc.flush()
        if res.blocks_processed == 0 and not res.events:
            return None
        if res.blocks_processed:
            self.stats.batches += 1
        self.stats.blocks_processed += res.blocks_processed
        self.stats.events += len(res.events)
        return res

    def run_once(self, timeout: float = 10.0) -> Optional[ProcessResult]:
        """Pop one batch and process it; None if no full batch available."""
        batch = self._pop_batch(timeout)
        if batch is None:
            return None
        res = self.fdc.process(batch)
        self.stats.batches += 1
        self.stats.blocks_processed += res.blocks_processed
        self.stats.events += len(res.events)
        return res

    def run_file(
        self,
        path: str,
        on_result: Optional[Callable[[ProcessResult], None]] = None,
        chunk: int = 65536,
        timeout: float = 10.0,
        flush: bool = True,
    ) -> List[ProcessResult]:
        """Stream a complex64 file through the channelizer.

        Starts a native background reader (double-buffered data loader) and
        consumes batches until the file is drained. Returns all results
        (or streams them to ``on_result`` if given). With ``flush`` (the
        default) the sub-batch file tail is processed too (zero-padded,
        outputs trimmed — see FrequencyDomainChannelizer.flush); pass
        False for the process-whole-batches-only behavior of an
        open-ended stream.
        """
        if self._ring is None:
            raise RuntimeError("run_file requires the native ring")
        from fdc_tpu_torch.runtime import native

        # a previous source on this driver closed the ring at its
        # end-of-stream; sequential sources reopen it
        self._ring.reopen()
        src = native.FileSource(self._ring, path, chunk=chunk)
        results: List[ProcessResult] = []

        def deliver(res):
            if on_result is not None:
                on_result(res)
            else:
                results.append(res)

        try:
            self._consume_source(
                src, deliver, timeout, flush,
                err=f"file source failed: {path}",
            )
        finally:
            n_read = src.samples_read
            src.stop()
        self.stats.samples_in = n_read or self.stats.samples_in
        return results

    def run_socket(
        self,
        port: int = 0,
        bind_addr: str = "",
        on_result: Optional[Callable[[ProcessResult], None]] = None,
        on_listen: Optional[Callable[[int], None]] = None,
        chunk: int = 65536,
        timeout: float = 10.0,
        flush: bool = True,
    ) -> List[ProcessResult]:
        """Serve one TCP connection of interleaved complex64 samples.

        Listens on ``bind_addr:port`` (port 0 = ephemeral; the bound port
        is passed to ``on_listen`` and printed nowhere else), streams the
        peer's samples through the channelizer until it disconnects, then
        flushes the tail (see run_file). The network analog of run_file —
        the reference's flowgraphs get this from GNU Radio's stock
        network sources.
        """
        if self._ring is None:
            raise RuntimeError("run_socket requires the native ring")
        from fdc_tpu_torch.runtime import native

        # a previous source on this driver closed the ring at its
        # end-of-stream; sequential connections reopen it
        self._ring.reopen()
        src = native.SocketSource(self._ring, port=port,
                                  bind_addr=bind_addr, chunk=chunk)
        bound = f"{bind_addr or '127.0.0.1'}:{src.port}"
        if on_listen is not None:
            on_listen(src.port)
        results: List[ProcessResult] = []

        def deliver(res):
            if on_result is not None:
                on_result(res)
            else:
                results.append(res)

        try:
            self._consume_source(
                src, deliver, timeout, flush,
                err=f"socket source failed: {bound}",
            )
        finally:
            n_read = src.samples_read
            src.stop()
        self.stats.samples_in = n_read or self.stats.samples_in
        return results

    def _consume_source(self, src, deliver, timeout, flush, err):
        """Shared drain loop: consume batches until the source is done
        and the ring holds less than one batch, then optionally flush."""
        while True:
            res = self.run_once(timeout)
            if res is None:
                # error before done: the source sets both on failure
                # (ring.cc), and a silent empty result is worse than the
                # exception
                if src.error:
                    raise IOError(err)
                if src.done and len(self._ring) < self.batch_samples:
                    break
                continue
            deliver(res)
        if flush:
            res = self.flush()
            if res is not None:
                deliver(res)
