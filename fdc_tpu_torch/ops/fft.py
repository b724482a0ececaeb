"""FFT front-end and the matmul-DFT subband transforms.

Port of the parts of ``fdc_tpu.ops.fft`` on the port's paths:

- :func:`forward_spectrum`: the batched forward FFT, fftshifted and scaled
  by 1/N (reference: python/FrequencyDomainChannelizer.py:206,214-216),
  routed as the JAX package routes it: ``use_mxu`` (the ``use_mxu_fft``
  knob, on by default) and N >= 256 take :func:`forward_spectrum_four_step`
  (the JAX package's four-step DFT-as-product form as its plain version;
  on the card, by N alone (:func:`_front_kernel`): kernel F, a radix FFT,
  ``csrc/forward_fft.cu``, up to N = 16384; F2c, the same split on a
  thread-block cluster, ``csrc/forward_fft_cluster.cu``, from 32768 to
  131072; F's two-pass form, ``csrc/forward_fft_2pass.cu``, above),
  anything else ``torch.fft``.
- :func:`subband_ifft` / :func:`interp_subband_ifft`: the subband inverse
  transforms of the FFT route (``use_mxu_fft=False``) on ``torch.fft``
  (cuFFT on the card), as the JAX package computes them with ``jnp.fft``.
- :func:`_rr_idft_matrix`: the numpy real-representation IDFT matrices
  (copied; the extraction kernels fold windows into them).
- :func:`interp_subband_ifft_mxu`: the variable-width slot transform as
  one fp32 ``torch.matmul`` (a plain large product, as the JAX package
  leaves it to XLA).
"""

from __future__ import annotations

import ctypes
import functools
import logging

import numpy as np
import torch

from fdc_tpu_torch import kernels

__all__ = [
    "FOUR_STEP_MAX_N",
    "CLUSTER_MAX_N",
    "TWO_PASS_MAX_N",
    "RADIX_PLANS",
    "TWO_PASS_PLANS",
    "forward_spectrum",
    "forward_spectrum_cluster",
    "forward_spectrum_cluster_plain",
    "forward_spectrum_four_step",
    "forward_spectrum_four_step_plain",
    "forward_spectrum_two_pass",
    "forward_spectrum_two_pass_plain",
    "subband_ifft",
    "interp_subband_ifft",
    "interleave_rows",
    "interp_subband_ifft_mxu",
]

_log = logging.getLogger(__name__)

# kernel F keeps a block's N values in shared memory: 16384 at most
FOUR_STEP_MAX_N = 16384
# F2c keeps a block in a cluster's shared memories: 8 CTAs hold 131072
CLUSTER_MAX_N = 131072
# its two-pass form runs m1- and m2-point FFTs, each at most 16384 points
TWO_PASS_MAX_N = 16384 * 16384

# kernel F's schedule (csrc/forward_fft.cu runs the same): N -> (values a
# thread holds, the radices of its Stockham passes in order)
RADIX_PLANS = {
    256: (8, (8, 8, 4)),
    512: (8, (8, 8, 8)),
    1024: (16, (16, 16, 4)),
    2048: (16, (16, 16, 8)),
    4096: (16, (16, 16, 16)),
    8192: (16, (16, 16, 16, 2)),
    16384: (32, (16, 16, 16, 4)),
}
# the two-pass form's column and row transforms (csrc/forward_fft_2pass.cu
# runs the same): kernel F's plans, and 128 points for m2 at N = 32768
TWO_PASS_PLANS = {128: (8, (8, 4, 4)), **RADIX_PLANS}


def forward_spectrum(blocks: torch.Tensor, use_mxu: bool = True,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """[..., N] complex blocks -> [..., N] spectrum, DC at bin N/2, 1/N
    scaled (reference: python/FrequencyDomainChannelizer.py:206,214-216).

    ``use_mxu`` takes the kernel :func:`_front_kernel` names for N, as
    ``fdc_tpu.ops.fft.forward_spectrum`` takes ``forward_spectrum_mxu``
    (N >= 256): :func:`forward_spectrum_four_step` (kernel F) up to N =
    16384, :func:`forward_spectrum_cluster` (F2c) from 32768 to 131072 and
    :func:`forward_spectrum_two_pass` (F2) above; otherwise ``torch.fft``,
    shifted and scaled. With ``out`` (a contiguous tensor of the result's
    shape) the spectrum is written there and ``out`` is returned."""
    n = blocks.shape[-1]
    kernel = _front_kernel(n) if use_mxu else "torch.fft"
    if kernel == "F2":
        return forward_spectrum_two_pass(blocks, out=out)
    if kernel == "F2c":
        return forward_spectrum_cluster(blocks, out=out)
    if kernel == "F":
        return forward_spectrum_four_step(blocks, out=out)
    spec = torch.fft.fftshift(torch.fft.fft(blocks, dim=-1), dim=-1)
    return _into(spec * (1.0 / n), out)


def _front_kernel(n: int) -> str:
    """The front end's kernel for N with ``use_mxu``, by N alone: "F"
    from 256 to 16384, "F2c" from 32768 to 131072, "F2" above (an N that
    is not a power of two is refused by the kernel's wrapper), and
    "torch.fft" below 256. There is no fallback from one to another."""
    if n < 256:
        return "torch.fft"
    if n <= FOUR_STEP_MAX_N:
        return "F"
    if n <= CLUSTER_MAX_N:
        return "F2c"
    return "F2"


def _into(spec: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    if out is None:
        return spec
    return out.copy_(spec)


@functools.lru_cache(maxsize=None)
def _four_step_matrices(n: int):
    """Constant matrices of the four-step forward DFT (copied from
    ``fdc_tpu.ops.fft._four_step_matrices``): N = m1*m2, m1 =
    2^ceil(log2(N)/2); stage 1's rr matrix W1 [2m1, 2m1] of the forward
    DFT e^{-2pi i a b / m1}; the twiddle (tr, ti) [m1, m2], T[k1, n2] =
    e^{-2pi i k1 n2 / N}; stage 2's rr matrix E2 [2m2, 2m2] of W_{m2}
    transposed, with the output fftshift folded in as (-1)^{n2} signs and
    the 1/N scale. Made in float64, rounded once to float32."""
    if n & (n - 1):
        raise ValueError(f"forward_spectrum_mxu needs power-of-2 N, got {n}")
    log2n = int(np.log2(n))
    m1 = 1 << ((log2n + 1) // 2)
    m2 = n // m1

    def dft(m):
        a = np.arange(m)[:, None].astype(np.float64)
        b = np.arange(m)[None, :].astype(np.float64)
        ang = -2.0 * np.pi * (a * b % m) / m
        return np.cos(ang), np.sin(ang)

    wr1, wi1 = dft(m1)
    w1 = np.block([[wr1, -wi1], [wi1, wr1]]).astype(np.float32)
    tang = -2.0 * np.pi * (
        np.arange(m1)[:, None] * np.arange(m2)[None, :] % n
    ).astype(np.float64) / n
    tr = np.cos(tang).astype(np.float32)
    ti = np.sin(tang).astype(np.float32)
    wr2, wi2 = dft(m2)
    s = np.where(np.arange(m2) % 2 == 0, 1.0, -1.0)[:, None]
    e_re = wr2.T * s / n
    e_im = wi2.T * s / n
    e2 = np.block([[e_re, e_im], [-e_im, e_re]]).astype(np.float32)
    return m1, m2, w1, tr, ti, e2


@functools.lru_cache(maxsize=None)
def _four_step_tables(n: int, device: torch.device):
    """The float32 tables of :func:`_four_step_matrices` on ``device``:
    (m1, m2, w1, tr, ti, e2). The kernel and its plain version read
    these same tensors, row-major (``np.block`` of transposed blocks is
    column-major)."""
    m1, m2, *mats = _four_step_matrices(n)
    return (m1, m2, *(torch.from_numpy(np.ascontiguousarray(m)).to(device)
                      for m in mats))


@functools.lru_cache(maxsize=None)
def _radix_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """Kernel F's twiddle table: complex64 [n], W_n^k = e^{-2 pi i k / n},
    made in float64 and rounded once."""
    k = np.arange(n, dtype=np.float64)
    w = np.exp(-2j * np.pi * k / n).astype(np.complex64)
    return torch.from_numpy(w).to(device)


def forward_spectrum_four_step_plain(blocks: torch.Tensor,
                                     out: torch.Tensor | None = None
                                     ) -> torch.Tensor:
    """Plain PyTorch version of :func:`forward_spectrum_four_step`, a
    direct port of ``fdc_tpu.ops.fft.forward_spectrum_mxu`` in fp32: view
    each block as [m1, m2], DFT the columns (rr product with W1), twiddle,
    DFT the rows (rr product with E2, fftshift signs and 1/N folded in),
    then spec[k] = X[k % m1, k // m1]. With ``out``, copied there."""
    n = blocks.shape[-1]
    m1, m2, w1, tr, ti, e2 = _four_step_tables(n, blocks.device)
    lead = blocks.shape[:-1]
    z = blocks.reshape(lead + (m1, m2))
    y_ri = torch.matmul(w1, torch.cat([z.real, z.imag], dim=-2))
    yr, yi = y_ri[..., :m1, :], y_ri[..., m1:, :]
    zr = yr * tr - yi * ti
    zi = yr * ti + yi * tr
    o_ri = torch.matmul(torch.cat([zr, zi], dim=-1), e2)
    x_mat = torch.complex(o_ri[..., :m2], o_ri[..., m2:])  # [k1, k2]
    return _into(x_mat.transpose(-1, -2).reshape(lead + (n,)), out)


def _check_card_fft(what: str, blocks: torch.Tensor, lo: int, hi: int,
                    out: torch.Tensor | None) -> torch.Tensor:
    """Check a card FFT's operands; returns ``out`` or a new tensor."""
    n = blocks.shape[-1]
    if blocks.dtype != torch.complex64:
        raise TypeError(f"{what}: complex64 blocks expected")
    if n & (n - 1) or not lo <= n <= hi:
        raise ValueError(f"{what}: N must be a power of 2 in [{lo}, {hi}], "
                         f"got {n}")
    if not blocks.is_contiguous():
        raise ValueError(f"{what}: contiguous blocks expected")
    if out is None:
        return torch.empty_like(blocks)
    if (out.shape != blocks.shape or out.dtype != blocks.dtype
            or out.device != blocks.device or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be a contiguous complex64 "
                         "tensor of the blocks' shape on their device")
    return out


def forward_spectrum_four_step(blocks: torch.Tensor,
                               out: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """The fftshifted, 1/N-scaled spectrum of [..., N] complex64 blocks,
    N a power of two in [256, 16384]. CPU tensors take the plain version
    (the four-step DFT-as-product form); CUDA tensors launch kernel F
    (``csrc/forward_fft.cu``, a radix FFT). ``out``: a contiguous
    complex64 tensor of the blocks' shape to write into (e.g. rows 1..B
    of the step's extended spectrum), else a new tensor."""
    if blocks.device.type == "cpu":
        return forward_spectrum_four_step_plain(blocks, out)
    n = blocks.shape[-1]
    out = _check_card_fft("forward_spectrum_four_step", blocks, 256,
                          FOUR_STEP_MAX_N, out)
    tw = _radix_twiddles(n, blocks.device)
    rows = blocks.numel() // n
    if rows:
        kernels.launch(
            "fdc_forward_fft", blocks.device,
            blocks.data_ptr(), rows, n, tw.data_ptr(), out.data_ptr(),
        )
        forward_spectrum_four_step.launches += 1
    return out


forward_spectrum_four_step.launches = 0


def forward_spectrum_two_pass(blocks: torch.Tensor,
                              out: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Kernel F's two-pass form (``csrc/forward_fft_2pass.cu``) on CUDA
    [..., N] complex64 blocks, N a power of two in (16384, 2^28] (the
    front end takes it above 131072, :func:`_front_kernel`): the
    four-step split N = m1 * m2 of :func:`_four_step_matrices`, pass 1 the
    m1-point FFTs of the columns into a scratch tensor, twiddled, pass 2
    the m2-point FFTs of the rows into ``out``, shifted and scaled.
    Its plain version is :func:`forward_spectrum_four_step_plain`, which
    CPU tensors take. One count a call (its two launches)."""
    if blocks.device.type == "cpu":
        return forward_spectrum_four_step_plain(blocks, out)
    n = blocks.shape[-1]
    out = _check_card_fft("forward_spectrum_two_pass", blocks,
                          2 * FOUR_STEP_MAX_N, TWO_PASS_MAX_N, out)
    m1, m2 = _two_pass_split(n)
    rows = blocks.numel() // n
    if rows:
        dev = blocks.device
        scratch = torch.empty_like(blocks)
        tw1, tw2, twn = (_radix_twiddles(m, dev) for m in (m1, m2, n))
        kernels.launch(
            "fdc_forward_fft_2pass", dev,
            blocks.data_ptr(), rows, m1, m2, tw1.data_ptr(), tw2.data_ptr(),
            twn.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        )
        forward_spectrum_two_pass.launches += 1
    return out


forward_spectrum_two_pass.launches = 0
# its plain version is the four-step product form's
forward_spectrum_two_pass_plain = forward_spectrum_four_step_plain


def forward_spectrum_cluster(blocks: torch.Tensor,
                             out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel F2c (``csrc/forward_fft_cluster.cu``) on CUDA [..., N]
    complex64 blocks, N a power of two in [32768, 131072]: F2's four-step
    split, one thread-block cluster a block holding it in its CTAs' shared
    memories, the transpose between the column and the row FFTs through
    distributed shared memory (one pass over device memory, no scratch).
    Its plain version is :func:`forward_spectrum_four_step_plain`, which
    CPU tensors take."""
    if blocks.device.type == "cpu":
        return forward_spectrum_four_step_plain(blocks, out)
    n = blocks.shape[-1]
    out = _check_card_fft("forward_spectrum_cluster", blocks,
                          2 * FOUR_STEP_MAX_N, CLUSTER_MAX_N, out)
    rows = blocks.numel() // n
    if rows:
        dev = blocks.device
        _cluster_fit(n, dev)
        m1, m2 = _two_pass_split(n)
        tw1, tw2 = (_radix_twiddles(m, dev) for m in (m1, m2))
        twk = _cluster_twiddles(n, dev)
        kernels.launch(
            "fdc_forward_fft_cluster", dev,
            blocks.data_ptr(), rows, n, tw1.data_ptr(),
            tw2.data_ptr(), twk.data_ptr(), out.data_ptr(),
        )
        forward_spectrum_cluster.launches += 1
    return out


forward_spectrum_cluster.launches = 0
# its plain version is the four-step product form's
forward_spectrum_cluster_plain = forward_spectrum_four_step_plain


@functools.lru_cache(maxsize=None)
def _cluster_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """F2c's twiddle table: complex64 [m1, m2], W_N^(k1 n2), the values
    of :func:`_radix_twiddles` at k1 n2 (made in float64, rounded once)
    row by row, as the kernel reads them."""
    m1, m2 = _two_pass_split(n)
    k = (np.arange(m1)[:, None] * np.arange(m2)[None, :]).astype(np.float64)
    w = np.exp(-2j * np.pi * k / n).astype(np.complex64)
    return torch.from_numpy(w).to(device)


@functools.lru_cache(maxsize=None)
def _cluster_fit(n: int, device: torch.device) -> int:
    """The clusters of F2c's build at N that ``device`` runs at once
    (``cudaOccupancyMaxActiveClusters``), logged once; raises if none can
    be scheduled."""
    fit = (ctypes.c_int * 1)()
    kernels.launch("fdc_forward_fft_cluster_fit", device, n,
                   ctypes.addressof(fit))
    if fit[0] < 1:
        raise RuntimeError(f"forward_spectrum_cluster: N = {n} cannot be "
                           f"scheduled on {device}")
    _log.info("forward_spectrum_cluster: N = %d: %d clusters at once on %s",
              n, fit[0], device)
    return fit[0]


def _two_pass_split(n: int):
    """(m1, m2) of the four-step split: m1 = 2^ceil(log2(N)/2)."""
    log2n = n.bit_length() - 1
    m1 = 1 << ((log2n + 1) // 2)
    return m1, n // m1


@functools.lru_cache(maxsize=None)
def _alternating_signs(n: int, device: torch.device) -> torch.Tensor:
    """(-1)^m, m < n, float32 on ``device``: made once a device (a copy
    from the host each call would stall the stream's host side)."""
    return torch.from_numpy(
        np.where(np.arange(n) % 2 == 0, 1.0, -1.0).astype(np.float32)
    ).to(device)


def subband_ifft(z: torch.Tensor) -> torch.Tensor:
    """Unnormalized IFFT of the fftshifted slice, ``l * ifft(z) * (-1)^m``
    over the last axis (``fdc_tpu.ops.fft.subband_ifft``, reference:
    lib/SegmentDetection_impl.cc:413-416,649-657); z [..., l] complex64,
    l even."""
    l = z.shape[-1]
    y = torch.fft.ifft(z, dim=-1)
    return y * (_alternating_signs(l, z.device) * l)


def interp_subband_ifft(z_pad: torch.Tensor, w_max: int) -> torch.Tensor:
    """``w_max * ifft(z_pad)`` over the last axis
    (``fdc_tpu.ops.fft.interp_subband_ifft``): sample m*q of a slot of
    width w = W/q, zero-padded to W, is its w-point unnormalized IFFT at
    m, without the fftshift signs."""
    return torch.fft.ifft(z_pad, dim=-1) * float(w_max)


@functools.lru_cache(maxsize=None)
def _rr_idft_matrix(
    l: int, keep_from: int, signs: bool, gain: float, pairs: bool = False
):
    """[2l, 2(l-keep_from)] float32 real-representation IDFT matrix.

    ``[zr zi] @ M == [yr yi]`` for ``y[m] = gain * l * ifft(z)[m]``
    (times ``(-1)^m`` when ``signs``), output columns restricted to
    ``m in [keep_from, l)``. ``pairs`` interleaves the output columns
    (re0, im0, re1, im1, ...) so the product is the float32 ``[..., k, 2]``
    pair layout directly. (Copied from ``fdc_tpu.ops.fft``.)
    """
    k = np.arange(l)[:, None].astype(np.float64)
    m = np.arange(keep_from, l)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * (k * m % l) / l
    e_re = np.cos(ang) * gain
    e_im = np.sin(ang) * gain
    if signs:
        s = np.where(np.arange(keep_from, l) % 2 == 0, 1.0, -1.0)[None, :]
        e_re = e_re * s
        e_im = e_im * s
    top = np.concatenate([e_re, e_im], axis=1)
    bot = np.concatenate([-e_im, e_re], axis=1)
    mat = np.concatenate([top, bot], axis=0).astype(np.float32)
    if pairs:
        kept = mat.shape[1] // 2
        mat = np.stack([mat[:, :kept], mat[:, kept:]], axis=2).reshape(
            mat.shape[0], 2 * kept
        )
    return mat


def interleave_rows(mat: np.ndarray) -> np.ndarray:
    """Reorder a [2l, X] real-representation matrix's rows from
    (re0..re_{l-1}, im0..im_{l-1}) to (re0, im0, re1, im1, ...), so it
    contracts against the raw interleaved float pairs of a complex64
    slice (``torch.view_as_real``) — no planar copy of the operand."""
    l = mat.shape[0] // 2
    return np.ascontiguousarray(
        np.stack([mat[:l], mat[l:]], axis=1).reshape(mat.shape)
    )


def interp_subband_ifft_mxu(z_pairs: torch.Tensor,
                            mat: torch.Tensor) -> torch.Tensor:
    """Variable-width slot transform (``fdc_tpu.ops.fft.
    interp_subband_ifft_mxu`` with ``pairs=True``): [..., W, 2] windowed
    slices in pair layout times the interleaved-row W-point unnormalized
    IDFT matrix ``mat`` [2W, 2W] -> [..., W, 2] pairs. One fp32 matmul
    (TF32 off, see the channelizer)."""
    w = z_pairs.shape[-2]
    y = torch.matmul(z_pairs.reshape(*z_pairs.shape[:-2], 2 * w), mat)
    return y.reshape(*y.shape[:-1], w, 2)
