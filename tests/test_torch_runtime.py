"""The port's host streaming runtime: the native sample ring, its file and
socket sources, and ``StreamDriver`` over the port's channelizer.

The ring and the sources are ``fdc_tpu``'s C++ (``ring.cc``, copied) behind
the port's loader, which builds into ``fdc_tpu_torch/_build/``. StreamDriver
is held to the channelizer's own ``process`` + ``flush`` on the same
capture: the same batches go through the same step, so events and streams
must be equal bit for bit. Every blocking call has a timeout, and every
socket binds port 0.
"""

import socket
import threading
import time

import numpy as np
import pytest

from fdc_tpu_torch import FrequencyDomainChannelizer, StreamDriver
from fdc_tpu_torch.flagship import _flagship
from fdc_tpu_torch.runtime import native

from test_torch_slice import capture, meta

SMALL = dict(blocksize=1024, batch_blocks=8, n_channels=16)
JOIN_S = 60.0  # a StreamDriver thread that outlives this has hung


def test_native_library_builds_into_build_dir():
    assert native.available()
    path = native._build()
    assert "/fdc_tpu_torch/_build/libfdc_native_" in path
    assert native._build() == path  # keyed by the sources: no rebuild


def test_ring_roundtrip_and_capacity():
    ring = native.SampleRing(1024)
    assert ring.capacity == 1024
    x = (np.arange(100) + 1j * np.arange(100)).astype(np.complex64)
    assert ring.push(x) == 100
    assert len(ring) == 100
    np.testing.assert_array_equal(ring.pop(100), x)
    assert len(ring) == 0
    assert ring.push(np.zeros(2000, np.complex64)) == 1024  # truncates


def test_ring_wraparound():
    ring = native.SampleRing(128)
    rng = np.random.default_rng(0)
    ref, got = [], []
    for _ in range(50):
        x = (rng.standard_normal(37)
             + 1j * rng.standard_normal(37)).astype(np.complex64)
        ref.append(x[:ring.push(x)])
        got.append(ring.pop(64))
    got.append(ring.pop(1024))
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(ref))


def test_ring_blocking_pop_sees_producer():
    ring = native.SampleRing(4096)
    x = np.arange(1000).astype(np.complex64)
    th = threading.Thread(target=lambda: (time.sleep(0.05), ring.push(x)))
    th.start()
    y = ring.pop(1000, blocking=True, timeout=5.0)
    th.join(timeout=5.0)
    assert not th.is_alive()
    np.testing.assert_array_equal(y, x)


def test_ring_blocking_pop_timeout_consumes_nothing():
    ring = native.SampleRing(1024)
    ring.push(np.arange(10).astype(np.complex64))
    t = time.perf_counter()
    assert len(ring.pop(100, blocking=True, timeout=0.05)) == 0
    assert time.perf_counter() - t < 5.0
    assert len(ring) == 10  # buffered samples intact
    ring.push(np.arange(10, 100).astype(np.complex64))
    np.testing.assert_array_equal(ring.pop(100, blocking=True, timeout=5.0),
                                  np.arange(100).astype(np.complex64))


def test_ring_close_and_reopen():
    ring = native.SampleRing(64)
    ring.push(np.ones(10, np.complex64))
    ring.close()
    assert ring.closed
    # end of stream: a blocking pop returns the partial remainder
    assert len(ring.pop(50, blocking=True, timeout=5.0)) == 10
    assert len(ring.pop(50, blocking=True, timeout=5.0)) == 0
    ring.reopen()
    assert not ring.closed
    ring.push(np.ones(5, np.complex64))
    assert len(ring.pop(5, blocking=True, timeout=5.0)) == 5


def test_file_source(tmp_path):
    path = tmp_path / "capture.c64"
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(10000)
         + 1j * rng.standard_normal(10000)).astype(np.complex64)
    x.tofile(path)
    ring = native.SampleRing(2048)
    src = native.FileSource(ring, str(path), chunk=500)
    got = []
    deadline = time.time() + 10.0
    while time.time() < deadline:
        y = ring.pop(1024, blocking=True, timeout=1.0)
        got.append(y)
        if src.done and len(ring) == 0 and len(y) == 0:
            break
    n_read = src.samples_read
    src.stop()
    # after stop() the properties read the terminal snapshot
    assert (src.samples_read, src.done, src.error) == (n_read, True, False)
    src.stop()  # idempotent
    assert n_read == 10000
    np.testing.assert_array_equal(np.concatenate(got), x)


def test_socket_source():
    x = (np.arange(5000) * (1 + 2j)).astype(np.complex64)
    ring = native.SampleRing(8192)
    src = native.SocketSource(ring, port=0)
    assert src.port > 0

    def client():
        with socket.create_connection(("127.0.0.1", src.port),
                                      timeout=5) as s:
            raw = x.tobytes()
            for off in range(0, len(raw), 777):  # samples cross recv calls
                s.sendall(raw[off:off + 777])

    th = threading.Thread(target=client, daemon=True)
    th.start()
    got = []
    deadline = time.time() + 10.0
    while time.time() < deadline:
        got.append(ring.pop(4096, blocking=True, timeout=0.5))
        if src.done and len(ring) == 0:
            break
    th.join(timeout=5.0)
    assert not th.is_alive()
    assert src.done and not src.error and src.samples_read == len(x)
    src.stop()
    np.testing.assert_array_equal(np.concatenate(got), x)
    # a listener that never gets a client stops without hanging
    idle = native.SocketSource(native.SampleRing(64), port=0)
    port = idle.port
    idle.stop()
    assert idle.port == port and idle.samples_read == 0


@pytest.fixture(scope="module")
def stream():
    """The small flagship's capture (a ragged tail) and its
    ``process`` + ``flush`` events and streams."""
    cfg = _flagship(**SMALL)
    x = capture(cfg, n_batches=3, tail=1500)
    fdc = FrequencyDomainChannelizer(cfg, device="cpu")
    res = [fdc.process(x), fdc.flush()]
    assert res[1].blocks_processed  # the tail went through the flush
    return cfg, x, res


def assert_results_equal(got, ref):
    """Events and throughput streams, bit for bit (same batches, same
    step)."""
    ev = [e for r in got for e in r.events]
    ev_ref = [e for r in ref for e in r.events]
    assert [meta(e) for e in ev] == [meta(e) for e in ev_ref]
    assert {meta(e)["ID"].split(".")[0] for e in ev} == {"PowActChan",
                                                        "DETECTED"}
    for a, b in zip(ev, ev_ref):
        np.testing.assert_array_equal(a.data, b.data)
    for ch in range(len(ref[0].throughput)):
        np.testing.assert_array_equal(
            np.concatenate([r.throughput[ch] for r in got]),
            np.concatenate([r.throughput[ch] for r in ref]))
    assert (sum(r.blocks_processed for r in got)
            == sum(r.blocks_processed for r in ref))


def in_thread(fn):
    """fn() on a daemon thread, joined with a timeout: a hang fails the
    test instead of eating the suite's time limit."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # re-raised below
            out["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=JOIN_S)
    assert not th.is_alive(), "StreamDriver hung"
    if "error" in out:
        raise out["error"]
    return out["value"]


def test_stream_driver_run_file_matches_process_flush(stream, tmp_path):
    cfg, x, ref = stream
    path = tmp_path / "capture.c64"
    x.tofile(path)
    drv = StreamDriver(FrequencyDomainChannelizer(cfg, device="cpu"),
                       ring_batches=2)
    got = in_thread(lambda: drv.run_file(str(path), chunk=3000,
                                         timeout=1.0))
    assert drv.stats.samples_in == len(x)
    assert drv.stats.batches == len(x) // drv.batch_samples + 1
    assert_results_equal(got, ref)


def test_stream_driver_run_socket_matches_process_flush(stream):
    cfg, x, ref = stream
    drv = StreamDriver(FrequencyDomainChannelizer(cfg, device="cpu"),
                       ring_batches=2)

    def client(port):
        with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
            s.sendall(x.tobytes())

    def on_listen(port):
        threading.Thread(target=client, args=(port,), daemon=True).start()

    got = in_thread(lambda: drv.run_socket(port=0, on_listen=on_listen,
                                           timeout=1.0))
    assert drv.stats.samples_in == len(x)
    assert_results_equal(got, ref)


def test_stream_driver_python_deque_matches_process_flush(stream):
    cfg, x, ref = stream
    drv = StreamDriver(FrequencyDomainChannelizer(cfg, device="cpu"),
                       use_native=False)
    assert drv.ring is None
    drv.push(x[:10000])
    drv.push(x[10000:])
    got = []
    while (res := drv.run_once(timeout=0.0)) is not None:
        got.append(res)
    assert drv.run_once(timeout=0.0) is None
    got.append(drv.flush())
    assert drv.stats.batches == len(x) // drv.batch_samples + 1
    assert_results_equal(got, ref)


def test_stream_driver_missing_file_raises(tmp_path):
    drv = StreamDriver(FrequencyDomainChannelizer(_flagship(**SMALL),
                                                  device="cpu"),
                       ring_batches=2)
    with pytest.raises(IOError):
        in_thread(lambda: drv.run_file(str(tmp_path / "absent.c64"),
                                       timeout=0.5))


def test_stream_driver_with_sharded_channelizer(tmp_path):
    """The config-5 streaming shape of tests/test_runtime.py:254-289: a
    file through the native ring into the sharded step on a 4x2 mesh of
    CPU ranks. Equal to the sharded channelizer's own process + flush
    (bit for bit: the same batches and step) and, within the stream
    tolerance, to the plain channelizer's."""
    from fdc_tpu_torch import ChannelizerConfig
    from fdc_tpu_torch.parallel import ShardedChannelizer, make_mesh

    from test_torch_slice import ATOL, RTOL, assert_events_match
    from test_torch_slice import assert_close_to_max

    cfg = ChannelizerConfig(
        blocksize=256, relinvovl=4, throughput_channels=[(-0.2, 0.05)],
        activity_detection_segments=[(0.1, 0.4)], act_det_threshold=8.0,
        minchandist=0.02, freqmode="basebandfs", batch_blocks=8,
    )

    def sharded():
        return ShardedChannelizer(cfg, mesh=make_mesh(4, 2, ["cpu"] * 8))

    n = 4 * cfg.batch_blocks * cfg.inplen
    t = np.arange(n)
    rng = np.random.default_rng(8)
    x = (np.exp(2j * np.pi * -0.2 * t)
         + 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    m = np.zeros(n)
    m[10 * cfg.inplen: 20 * cfg.inplen] = 1.0
    x += (2.0 * m * np.exp(2j * np.pi * 0.25 * t)).astype(np.complex64)
    path = tmp_path / "pod.c64"
    x.tofile(path)

    drv = StreamDriver(sharded(), ring_batches=2)
    got = in_thread(lambda: drv.run_file(str(path), timeout=1.0))
    assert drv.stats.batches == 4
    events = [e for r in got for e in r.events]
    assert any(e.finalized for e in events)
    y = np.concatenate([r.throughput[0] for r in got])
    assert np.abs(y[200:]).mean() == pytest.approx(1.0, abs=0.07)
    sh = sharded()
    ref = [sh.process(x), sh.flush()]
    assert [meta(e) for e in events] == [meta(e) for r in ref
                                         for e in r.events]
    for a, b in zip(events, [e for r in ref for e in r.events]):
        np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(
        y, np.concatenate([r.throughput[0] for r in ref]))
    plain = FrequencyDomainChannelizer(cfg, device="cpu")
    pres = [plain.process(x), plain.flush()]
    assert_events_match(events, [e for r in pres for e in r.events])
    assert_close_to_max(y, np.concatenate([r.throughput[0] for r in pres]),
                        RTOL, ATOL, "throughput")
