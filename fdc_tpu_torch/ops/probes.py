"""Kernel P: the four-step FFT's tile probes.

Replaces the Pallas lowering probes of the fused four-step FFT,
``m1`` ... ``m6`` of ``tools/pallas_fft_micro.py:39-90`` and ``p1`` ...
``p6`` of ``tools/pallas_fft_micro2.py:44-92``. Each probe computes one
piece of the fused FFT (a reshape, a product, a transposed contraction,
an even/odd row select, lane halves, the per-block pipeline) on its own
shapes. Kernel P (``csrc/fft_probes.cu``) cuts each output into slices,
one CTA a slice (the grid column of ``_PROBE``): a product probe's CTA
stages its rows of ``x`` and its columns of the constant matrices in
shared memory by asynchronous copies and multiplies from there; a copy
probe moves a float4 a thread. No path of either package runs a probe.
:func:`probe_inputs` makes each probe's inputs as its file does (numpy,
seed 0).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fdc_tpu_torch import kernels

__all__ = ["PROBES", "probe_flops", "probe_inputs", "tile_probe",
           "tile_probe_plain"]

_M, _TB, _N = 64, 8, 4096
_GEMM64 = 2 * _TB * _M * _M * _M  # [tb*64, 64] @ [64, 64]
_P4_BLOCK = 4 * _M ** 3 + _M * _M  # two 64^3 products and the twiddle
# Every probe: (output shape, CTAs: a [16, 32] slice of a product, a
# block's 8 columns of a p4 pipeline (p4d: block 0's, which also zero the
# rest), a float4 a thread of a copy at 128 threads; fp32 operations: its
# products and elementwise multiplies). The order is the op index: it must
# match the Op enum of csrc/fft_probes.cu, whose kGrid refuses another
# grid.
_PROBE = {
    "m1": ((_TB, _N), 64, _TB * _N),
    "m2": ((_TB, _N), 64, _GEMM64),
    "m2p": ((_TB, _N), 64, _GEMM64),
    "m2f": ((_M, _M), 8, 2 * _M ** 3),
    "m3": ((_TB, _N), 64, _GEMM64),
    "m5": ((_TB * _M, _M), 64, _GEMM64),
    "m6": ((_TB, _N), 64, 2 * _TB * 32 * 128 * 128),
    "m4": ((_TB, _N), 64, _GEMM64),
    "p1": ((_M, _M), 8, 2 * _M ** 3),
    "p2": ((_M, _M), 8, 0),
    "p3": ((_M, _M), 8, 0),
    "p4": ((_TB * 32, 128), 64, _TB * _P4_BLOCK),
    "p4c": ((_TB * 32, 128), 64, _TB * 2 * _M ** 3),
    "p4d": ((_TB * 32, 128), 8, _P4_BLOCK),
    "p5": ((32, 128), 8, 0),
    "p6": ((32, 128), 8, 0),
}
PROBES = tuple(_PROBE)


def probe_flops(name: str) -> int:
    """The fp32 operations of probe ``name`` on its inputs."""
    return _PROBE[name][2]


def probe_inputs(name: str):
    """The probe's float32 inputs as its file makes them (numpy
    ``default_rng(0)``; ``pallas_fft_micro.py:99-105``,
    ``pallas_fft_micro2.py:94-100``)."""
    rng = np.random.default_rng(0)
    if name.startswith("m"):
        x = rng.standard_normal((_TB, _N)).astype(np.float32)
        f = np.eye(_M, dtype=np.float32) * 2.0
        fj2 = rng.standard_normal((_M, _M)).astype(np.float32)
        return {"m2f": (fj2, fj2), "m5": (x.reshape(_TB * _M, _M), f),
                "m1": (x,), "m6": (x, np.eye(128, dtype=np.float32)),
                }.get(name, (x, f))
    x64 = rng.standard_normal((_M, _M)).astype(np.float32)
    x128 = rng.standard_normal((32, 128)).astype(np.float32)
    xtall = rng.standard_normal((_TB * 32, 128)).astype(np.float32)
    f, g, t = (rng.standard_normal((_M, _M)).astype(np.float32)
               for _ in range(3))
    return {"p1": (x64, f), "p2": (x64,), "p3": (x128,),
            "p4": (xtall, f, g, t), "p4c": (xtall, f),
            "p4d": (xtall, f, g, t), "p5": (x64,), "p6": (x64,)}[name]


@functools.lru_cache(maxsize=None)
def _input_shapes(name: str):
    return [a.shape for a in probe_inputs(name)]


def _halves(blk):
    """[32, 128] -> [64, 64]: the lane halves stacked."""
    return torch.cat([blk[:, :_M], blk[:, _M:]], dim=0)


def _pack(xk):
    """[64, 64] -> [32, 128]: rows 2p and 2p + 1 side by side."""
    return torch.cat([xk[0::2], xk[1::2]], dim=1)


def tile_probe_plain(name: str, x, f=None, g=None, t=None):
    """Plain PyTorch version of :func:`tile_probe` (same arguments and
    result)."""
    if name == "m1":
        return x.reshape(_TB, _M, _M).reshape(_TB, _N) * 2.0
    if name in ("m2", "m2p", "m3", "m4"):
        return (x.reshape(_TB * _M, _M) @ f).reshape(_TB, _N)
    if name in ("m2f", "m5"):
        return x @ f
    if name == "m6":
        return (x.reshape(_TB * 32, 128) @ f).reshape(_TB, _N)
    if name == "p1":
        return x.T @ f
    if name == "p2":
        return torch.cat([x[0::2], x[1::2]], dim=0)
    if name == "p3":
        return _halves(x)
    if name == "p5":
        return _pack(x)
    if name == "p6":
        return torch.cat([x[:32], x[32:]], dim=1)
    out = torch.zeros(_PROBE[name][0], dtype=x.dtype, device=x.device)
    for b in range(1 if name == "p4d" else _TB):
        s = _halves(x[b * 32:(b + 1) * 32]).T @ f
        if name != "p4c":
            s = g @ (s * t)
        out[b * 32:(b + 1) * 32] = _pack(s)
    return out


def tile_probe(name: str, x, f=None, g=None, t=None):
    """Run probe ``name`` (one of :data:`PROBES`) on its float32 inputs
    (:func:`probe_inputs`' shapes). CPU tensors take the plain version;
    CUDA tensors launch kernel P."""
    if name not in PROBES:
        raise ValueError(f"tile_probe: unknown probe {name!r}")
    if x.device.type == "cpu":
        return tile_probe_plain(name, x, f, g, t)
    ins = [v for v in (x, f, g, t) if v is not None]
    for v in ins:
        if (v.dtype != torch.float32 or v.device != x.device
                or not v.is_contiguous() or v.data_ptr() % 16):
            raise ValueError("tile_probe: contiguous, 16-byte aligned "
                             "float32 tensors on one device expected")
    want = _input_shapes(name)
    if [tuple(v.shape) for v in ins] != want:
        raise ValueError(f"tile_probe: {name} takes inputs of {want}")
    shape, ctas, _ = _PROBE[name]
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    kernels.launch(
        "fdc_tile_probe", x.device,
        PROBES.index(name), *(v.data_ptr() if v is not None else None
                              for v in (x, f, g, t)),
        ctas, out.data_ptr(),
    )
    tile_probe.launches += 1
    return out


tile_probe.launches = 0
