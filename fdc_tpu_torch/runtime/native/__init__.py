# Copied from fdc_tpu/runtime/native/__init__.py; only the build lines differ: the library is built into fdc_tpu_torch/_build/ under a name keyed by a hash of the sources, written to a temporary name and moved into place.
"""ctypes bindings for the native streaming runtime (ring.cc).

Builds the shared library on first import if missing or stale (g++ is part
of the baked toolchain; no pybind11 in this environment, so the C ABI +
ctypes is the binding layer). All fallible paths degrade gracefully: if the
toolchain is unavailable, ``available()`` returns False and the pure-Python
driver paths keep working.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = [
    "available",
    "SampleRing",
    "FileSource",
    "SocketSource",
    "EmissionEngine",
    "RawEvent",
    "NativeBuildError",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "ring.cc"), os.path.join(_HERE, "emission.cc")]
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")
# ring.cc uses std::string without including <string>, which newer
# libstdc++ headers (<thread>, <mutex>) no longer pull in: the header is
# forced in here, and the source stays the JAX package's, verbatim
_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
          "-include", "string"]

_lock = threading.Lock()
_lib = None
_build_error = None


class NativeBuildError(RuntimeError):
    pass


def _build() -> str:
    """The library's path under ``fdc_tpu_torch/_build/``, named by a hash
    of the sources and flags; g++ builds it there first when it is
    missing, into a temporary name moved into place, so processes that
    build at once never load a partial file."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SRCS:
        with open(src, "rb") as fh:
            h.update(fh.read())
    lib = os.path.join(_BUILD, f"libfdc_native_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, *_SRCS, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"native build failed: {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise _build_error
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, NativeBuildError) as e:
            _build_error = NativeBuildError(str(e))
            raise _build_error

        lib.fdc_ring_create.restype = ctypes.c_void_p
        lib.fdc_ring_create.argtypes = [ctypes.c_size_t]
        lib.fdc_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.fdc_ring_capacity.restype = ctypes.c_size_t
        lib.fdc_ring_capacity.argtypes = [ctypes.c_void_p]
        lib.fdc_ring_size.restype = ctypes.c_size_t
        lib.fdc_ring_size.argtypes = [ctypes.c_void_p]
        lib.fdc_ring_close.argtypes = [ctypes.c_void_p]
        lib.fdc_ring_closed.restype = ctypes.c_int
        lib.fdc_ring_closed.argtypes = [ctypes.c_void_p]
        lib.fdc_ring_reopen.argtypes = [ctypes.c_void_p]
        for name in ("fdc_ring_push", "fdc_ring_pop"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_size_t
            fn.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_size_t,
            ]
        for name in ("fdc_ring_push_blocking", "fdc_ring_pop_blocking"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_size_t
            fn.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_size_t,
                ctypes.c_double,
            ]
        lib.fdc_filesource_start.restype = ctypes.c_void_p
        lib.fdc_filesource_start.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.fdc_filesource_stop.argtypes = [ctypes.c_void_p]
        lib.fdc_filesource_samples_read.restype = ctypes.c_uint64
        lib.fdc_filesource_samples_read.argtypes = [ctypes.c_void_p]
        lib.fdc_filesource_done.restype = ctypes.c_int
        lib.fdc_filesource_done.argtypes = [ctypes.c_void_p]
        lib.fdc_filesource_error.restype = ctypes.c_int
        lib.fdc_filesource_error.argtypes = [ctypes.c_void_p]
        lib.fdc_socketsource_start.restype = ctypes.c_void_p
        lib.fdc_socketsource_start.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_size_t,
        ]
        lib.fdc_socketsource_stop.argtypes = [ctypes.c_void_p]
        for name in ("fdc_socketsource_port", "fdc_socketsource_done",
                     "fdc_socketsource_error"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p]
        lib.fdc_socketsource_samples_read.restype = ctypes.c_uint64
        lib.fdc_socketsource_samples_read.argtypes = [ctypes.c_void_p]

        # emission engine
        c = ctypes
        lib.fdc_emit_create.restype = c.c_void_p
        lib.fdc_emit_create.argtypes = [
            c.c_int, c.c_int, c.c_int, c.c_longlong, c.c_longlong,
        ]
        lib.fdc_emit_destroy.argtypes = [c.c_void_p]
        lib.fdc_emit_pa_set_channel.argtypes = [
            c.c_void_p, c.c_int, c.c_longlong, c.c_double, c.c_double,
        ]
        lib.fdc_emit_pa_finished.restype = c.c_longlong
        lib.fdc_emit_pa_finished.argtypes = [c.c_void_p, c.c_int]
        lib.fdc_emit_set_want_data.argtypes = [c.c_void_p, c.c_int]
        lib.fdc_emit_lost_rows.restype = c.c_longlong
        lib.fdc_emit_lost_rows.argtypes = [c.c_void_p]
        lib.fdc_emit_kill_unit.argtypes = [c.c_void_p, c.c_int]
        u8p = c.POINTER(c.c_uint8)
        i32p = c.POINTER(c.c_int32)
        f32p = c.POINTER(c.c_float)
        lib.fdc_emit_seg_step.restype = c.c_int
        lib.fdc_emit_seg_step.argtypes = [
            c.c_void_p, c.c_int, c.c_int, c.c_int, i32p,
            u8p, u8p, u8p, i32p, f32p,
            c.c_int, c.c_int, i32p, f32p,  # narrow bucket (may be empty)
            i32p, i32p, i32p,
            c.c_char_p, c.c_longlong,
        ]
        lib.fdc_emit_pa_step.restype = c.c_int
        lib.fdc_emit_pa_step.argtypes = [
            c.c_void_p, c.c_int, c.c_int,
            u8p, u8p, u8p, i32p, f32p,
            c.c_char_p, c.c_longlong,
        ]
        lib.fdc_emit_next_event.restype = c.c_int
        lib.fdc_emit_next_event.argtypes = [
            c.c_void_p,
            c.POINTER(c.c_char_p), c.POINTER(c.c_int),
            c.POINTER(c.c_longlong),
            c.POINTER(c.c_double), c.POINTER(c.c_double),
            c.POINTER(c.c_longlong), c.POINTER(c.c_longlong),
            c.POINTER(c.c_longlong), c.POINTER(c.c_longlong),
            c.POINTER(f32p), c.POINTER(c.c_longlong),
        ]
        lib.fdc_emit_save_state.restype = c.c_longlong
        lib.fdc_emit_save_state.argtypes = [c.c_void_p, u8p]
        lib.fdc_emit_load_state.restype = c.c_int
        lib.fdc_emit_load_state.argtypes = [c.c_void_p, u8p, c.c_longlong]
        _lib = lib
        return _lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeBuildError:
        return False


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class SampleRing:
    """SPSC complex64 sample ring backed by the native library."""

    def __init__(self, capacity_samples: int):
        self._lib = _load()
        self._h = self._lib.fdc_ring_create(capacity_samples)
        if not self._h:
            raise MemoryError("fdc_ring_create failed")

    @property
    def capacity(self) -> int:
        return self._lib.fdc_ring_capacity(self._h)

    def __len__(self) -> int:
        return self._lib.fdc_ring_size(self._h)

    def close(self):
        self._lib.fdc_ring_close(self._h)

    def reopen(self):
        """Clear end-of-stream so a new producer can feed the ring (only
        after the previous source's stop() joined its thread)."""
        self._lib.fdc_ring_reopen(self._h)

    @property
    def closed(self) -> bool:
        return bool(self._lib.fdc_ring_closed(self._h))

    def push(self, samples: np.ndarray, blocking=False, timeout=10.0) -> int:
        x = np.ascontiguousarray(samples, np.complex64).view(np.float32)
        n = len(x) // 2
        if blocking:
            return self._lib.fdc_ring_push_blocking(
                self._h, _fptr(x), n, timeout
            )
        return self._lib.fdc_ring_push(self._h, _fptr(x), n)

    def pop(self, n: int, blocking=False, timeout=10.0) -> np.ndarray:
        out = np.empty(2 * n, np.float32)
        if blocking:
            got = self._lib.fdc_ring_pop_blocking(self._h, _fptr(out), n, timeout)
        else:
            got = self._lib.fdc_ring_pop(self._h, _fptr(out), n)
        return out[: 2 * got].view(np.complex64)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.fdc_ring_destroy(self._h)
                self._h = None
        except Exception:
            pass


class FileSource:
    """Background-thread complex64 file reader feeding a SampleRing."""

    def __init__(self, ring: SampleRing, path: str, chunk: int = 65536,
                 loop: bool = False):
        self._lib = _load()
        self._ring = ring  # keep alive
        self._h = self._lib.fdc_filesource_start(
            ring._h, str(path).encode(), chunk, int(loop)
        )

    @property
    def samples_read(self) -> int:
        if self._h is None:
            return self._final[0]
        return self._lib.fdc_filesource_samples_read(self._h)

    @property
    def done(self) -> bool:
        if self._h is None:
            return self._final[1]
        return bool(self._lib.fdc_filesource_done(self._h))

    @property
    def error(self) -> bool:
        if self._h is None:
            return self._final[2]
        return bool(self._lib.fdc_filesource_error(self._h))

    def stop(self):
        if getattr(self, "_h", None):
            # snapshot the terminal state: the C handle is freed below, so
            # properties read after stop() must not dereference it
            self._final = (self.samples_read, self.done, self.error)
            self._lib.fdc_filesource_stop(self._h)
            self._h = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class SocketSource:
    """Background-thread TCP reader feeding a SampleRing: listens on
    bind_addr:port (port 0 = ephemeral, read the bound one from ``.port``),
    accepts ONE connection, and streams its interleaved complex64 bytes
    into the ring until the peer closes."""

    def __init__(self, ring: SampleRing, port: int = 0,
                 bind_addr: str = "", chunk: int = 65536):
        self._lib = _load()
        self._ring = ring  # keep alive
        self._h = self._lib.fdc_socketsource_start(
            ring._h, bind_addr.encode(), port, chunk
        )
        if not self._h:
            raise OSError(f"cannot listen on {bind_addr or '127.0.0.1'}"
                          f":{port}")

    @property
    def port(self) -> int:
        if self._h is None:
            return self._final[0]
        return self._lib.fdc_socketsource_port(self._h)

    @property
    def samples_read(self) -> int:
        if self._h is None:
            return self._final[1]
        return self._lib.fdc_socketsource_samples_read(self._h)

    @property
    def done(self) -> bool:
        if self._h is None:
            return self._final[2]
        return bool(self._lib.fdc_socketsource_done(self._h))

    @property
    def error(self) -> bool:
        if self._h is None:
            return self._final[3]
        return bool(self._lib.fdc_socketsource_error(self._h))

    def stop(self):
        if getattr(self, "_h", None):
            # snapshot the terminal state: the C handle is freed below, so
            # properties read after stop() must not dereference it
            self._final = (self.port, self.samples_read, self.done,
                           self.error)
            self._lib.fdc_socketsource_stop(self._h)
            self._h = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class RawEvent:
    """One drained native event (metadata + copied complex64 samples)."""

    __slots__ = ("ID", "finalized", "part", "rel_cfreq", "rel_bw",
                 "blockstart", "blockend", "vectorstart", "vectorend", "data")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])


class EmissionEngine:
    """Native burst-assembly engine (one SegmentDetector's slots or one
    PowerActivationBank's channels). See runtime/native/emission.cc."""

    MODE_SEG = 0
    MODE_PA = 1
    MODE_SEG_VCM = 2  # vcm conventions: blockcount base 1, inline partials

    def __init__(self, mode, n_units, relinvovl, blocksize, maxblocks):
        self._lib = _load()
        self.mode = mode
        self.n_units = n_units
        self._h = self._lib.fdc_emit_create(
            mode, n_units, relinvovl, blocksize, maxblocks
        )
        if not self._h:
            raise MemoryError("fdc_emit_create failed")

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.fdc_emit_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def pa_set_channel(self, c, out_len, rel_cfreq, rel_bw):
        self._lib.fdc_emit_pa_set_channel(
            self._h, c, out_len, rel_cfreq, rel_bw
        )

    def set_want_data(self, want: bool):
        """want=False skips event sample assembly (msgoutput and
        fileoutput both off); burst state updates are unaffected."""
        self._lib.fdc_emit_set_want_data(self._h, int(bool(want)))

    def pa_finished(self, c) -> int:
        return self._lib.fdc_emit_pa_finished(self._h, c)

    @staticmethod
    def _u8(a):
        return np.ascontiguousarray(a, np.uint8).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)
        )

    @staticmethod
    def _i32(a):
        return np.ascontiguousarray(a, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        )

    def seg_step(self, activated, processed, emit, phase_used, extract,
                 ext_start, wlog2, order, ids: bytes, t0: int,
                 slot_ids=None, extract_narrow=None, slot_ids_narrow=None):
        """All flag arrays [S, B]; extract complex64 [E, B+1, l_cap] —
        compacted rows named by slot_ids [E] (None = identity, E == S);
        extract_narrow/slot_ids_narrow: optional second, narrower bucket;
        order [S] activation sequence numbers (slot iteration order)."""
        s, nb = activated.shape
        assert s == self.n_units
        ex = np.ascontiguousarray(extract, np.complex64)
        l_cap = ex.shape[2]
        if slot_ids is None:
            slot_ids = np.arange(s, dtype=np.int32)
        si = np.ascontiguousarray(slot_ids, np.int32)
        assert ex.shape[0] == len(si)
        if extract_narrow is not None:
            ex2 = np.ascontiguousarray(extract_narrow, np.complex64)
            si2 = np.ascontiguousarray(slot_ids_narrow, np.int32)
            l_cap2, n2 = ex2.shape[2], len(si2)
            ex2f = ex2.view(np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)
            )
            si2p = self._i32(si2)
        else:
            ex2 = si2 = None  # keep alive (noop)
            l_cap2, n2 = 0, 0
            ex2f = ctypes.POINTER(ctypes.c_float)()
            si2p = ctypes.POINTER(ctypes.c_int32)()
        # hold temporaries so ctypes pointers stay valid through the call
        tmp = [np.ascontiguousarray(a, np.uint8) for a in
               (activated, processed, emit)]
        pu = np.ascontiguousarray(phase_used, np.int32)
        es = np.ascontiguousarray(ext_start, np.int32)
        wl = np.ascontiguousarray(wlog2, np.int32)
        od = np.ascontiguousarray(order, np.int32)
        self._lib.fdc_emit_seg_step(
            self._h, nb, l_cap, len(si), self._i32(si),
            self._u8(tmp[0]), self._u8(tmp[1]), self._u8(tmp[2]),
            self._i32(pu),
            ex.view(np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)
            ),
            l_cap2, n2, si2p, ex2f,
            self._i32(es), self._i32(wl), self._i32(od),
            ids, t0,
        )
        return self.drain()

    @property
    def lost_rows(self) -> int:
        return self._lib.fdc_emit_lost_rows(self._h)

    def kill_unit(self, u: int):
        """Discard one unit's buffered burst without emission
        (split-segment cut reconciliation; mirrors the Python emitter's
        killed-slot reset)."""
        self._lib.fdc_emit_kill_unit(self._h, int(u))

    def pa_step(self, rise, fall, processed, phase_used, extract,
                id_prefix: bytes, t0: int):
        """All flag arrays [C, B]; extract complex64 [C, B+1, out_cap]."""
        c, nb = rise.shape
        assert c == self.n_units
        ex = np.ascontiguousarray(extract, np.complex64)
        out_cap = ex.shape[2]
        tmp = [np.ascontiguousarray(a, np.uint8) for a in
               (rise, fall, processed)]
        pu = np.ascontiguousarray(phase_used, np.int32)
        self._lib.fdc_emit_pa_step(
            self._h, nb, out_cap,
            self._u8(tmp[0]), self._u8(tmp[1]), self._u8(tmp[2]),
            self._i32(pu),
            ex.view(np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)
            ),
            id_prefix, t0,
        )
        return self.drain()

    def drain(self):
        c = ctypes
        out = []
        id_p = c.c_char_p()
        fin = c.c_int()
        part = c.c_longlong()
        cf = c.c_double()
        bw = c.c_double()
        bs = c.c_longlong()
        be = c.c_longlong()
        vs = c.c_longlong()
        ve = c.c_longlong()
        dp = c.POINTER(c.c_float)()
        ns = c.c_longlong()
        while self._lib.fdc_emit_next_event(
            self._h, c.byref(id_p), c.byref(fin), c.byref(part),
            c.byref(cf), c.byref(bw), c.byref(bs), c.byref(be),
            c.byref(vs), c.byref(ve), c.byref(dp), c.byref(ns),
        ):
            n = ns.value
            data = np.ctypeslib.as_array(dp, shape=(2 * n,)).copy().view(
                np.complex64
            ) if n else np.zeros(0, np.complex64)
            out.append(RawEvent(
                ID=id_p.value.decode(),
                finalized=bool(fin.value),
                part=(None if part.value < 0 else int(part.value)),
                rel_cfreq=cf.value,
                rel_bw=bw.value,
                blockstart=bs.value,
                blockend=be.value,
                vectorstart=(None if vs.value < 0 else int(vs.value)),
                vectorend=(None if ve.value < 0 else int(ve.value)),
                data=data,
            ))
        return out

    # -- checkpoint support ----------------------------------------------------

    def save_state(self) -> bytes:
        n = self._lib.fdc_emit_save_state(self._h, None)
        buf = np.empty(n, np.uint8)
        self._lib.fdc_emit_save_state(self._h, self._u8(buf))
        return buf.tobytes()

    def load_state(self, blob: bytes):
        buf = np.frombuffer(blob, np.uint8)
        ok = self._lib.fdc_emit_load_state(self._h, self._u8(buf), len(buf))
        if not ok:
            raise ValueError("corrupt native emission state")
