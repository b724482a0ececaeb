"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

The kernels ship as CUDA C++ sources with a plain C interface. On first
use, ``nvcc`` compiles each source for ``sm_90a`` into an object (one
compiler process per source, all started together) and links the
objects into one shared library under ``fdc_tpu_torch/_build/``, named by
a hash of the sources (headers included) and flags, so an edited source
rebuilds. The library is loaded with ``ctypes``. Nothing here runs at
import time: the CPU tests import every module, and only a CUDA tensor
reaching a kernel wrapper triggers the build.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``;
:func:`check` raises when that is not 0. The wrappers call them through
:func:`launch`, which makes the tensors' device the current one for the
call: an entry point reads ``cudaGetDevice`` for its shared-memory
opt-in (``csrc/smem_optin.cuh``), and a pipeline lane may run on another
device than the current one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["library", "check", "launch", "stream_ptr", "build_info"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (csrc/*.cu)
_SIGNATURES = {
    "fdc_extract_shared": [_P, _I, _I, _P, _I, _P, _I, _I, _P, _I, _I, _I,
                           _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                           _P],
    "fdc_extract_static": [_P, _I, _I, _P, _I, _P, _I, _I, _P, _I, _I, _I,
                           _I, _I, _P, _P],
    "fdc_greedy_accept": [_P, _P, _P, _P, _I, _I, _P],
    "fdc_candidate_packs": [_I, _P, _P, _P, _I, _P, _P],
    "fdc_slot_lifecycle": [_I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                           _I, _P, _P, _P, _P, _P, _F, _I, _P, _P, _P,
                           _P, _P, _P, _P, _P],
    "fdc_powact": [_P, _I, _I, _P, _P, _P, _P, _F, _I, _P, _P, _P, _P,
                   _P, _P, _P, _P],
    "fdc_forward_fft": [_P, _I, _I, _P, _P, _P],
    "fdc_forward_fft_2pass": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "fdc_tile_probe": [_I, _P, _P, _P, _P, _I, _P, _P],
}

_lib = None
_info = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the fdc_tpu_torch "
            "kernels are built from csrc/ on first use on a CUDA device"
        )
    return path


def _run(cmds) -> str:
    """Run the commands at once; their stderr, or raise if one failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (stdout, stderr) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{stdout}{stderr}")
    return "".join(stderr for _, stderr in outs)


def _build() -> Path:
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = _BUILD / f"libfdc_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        _info.update(path=str(out), seconds=0.0, cached=True)
        return out
    nvcc = _nvcc()
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{p.stem}.o") for p in sources]
    t = time.perf_counter()
    ptxas = _run([[nvcc, *_FLAGS, "-c", "-o", str(o), str(p)]
                  for p, o in zip(sources, objs)])
    _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, out)  # atomic: no build loads a partial file
    for o in objs:
        o.unlink()
    _info.update(
        path=str(out), seconds=time.perf_counter() - t, cached=False,
        ptxas=ptxas,
    )
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def build_info() -> dict:
    """Path, build seconds and ``ptxas -v`` report of the loaded library."""
    library()
    return dict(_info)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_ptr(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and the current stream
    of ``device``, with ``device`` the current CUDA device; raise if the
    launch failed."""
    with torch.cuda.device(device):
        rc = getattr(library(), name)(*args, stream_ptr(device))
    check(rc, name)
