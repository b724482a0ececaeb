"""Static ("throughput") channels: fixed always-on extraction.

Port of ``fdc_tpu.models.throughput`` (reference:
python/FrequencyDomainChannelizer.py:218-231): channels sharing an FFT
width form one bucket, extracted together by kernel A — or by kernel E
when their windows differ (channels of different bandwidths that round
to one power-of-2 width) — or, with ``use_mxu=False``, on the FFT route
(``ops.extract.FftTable``).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from fdc_tpu_torch.config import WindowType, solve_throughput_channel
from fdc_tpu_torch.ops.extract import (
    FftTable,
    apply_phase_pairs,
    bucket_folded,
)
from fdc_tpu_torch.ops.windows import base_window

__all__ = ["BucketTables", "ThroughputChannelizer", "split_rows"]


def split_rows(a, parts: int):
    """Zero-pad axis 0 of ``a`` (numpy or a tensor) to a multiple of
    ``parts`` and split it into ``parts`` equal slices (JAX:
    ``parallel/sharded.py``'s ``_pad_rows`` / ``_split_rows``)."""
    pad = (-a.shape[0]) % parts
    if pad:
        if isinstance(a, np.ndarray):
            a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
        else:
            a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
    m = a.shape[0] // parts
    return [a[r * m:(r + 1) * m] for r in range(parts)]


class BucketTables:
    """The width buckets of a channel bank (an ``nn.Module`` with
    ``buckets``, each with ``starts``, ``windows``, ``channel_ids`` and
    the buffers ``{name}_starts`` and ``{name}_folded`` (the product
    route, ``use_mxu``) or ``{name}_windows`` (the FFT route), and a
    transform ``gain``)."""

    def _register_tables(self, bucket, blocksize: int):
        """Register a bucket's device tables for the bank's route."""
        starts = torch.from_numpy(bucket.starts)
        self.register_buffer(f"{bucket.name}_starts", starts)
        keep_from = bucket.width - bucket.out_len
        if self.use_mxu:
            self.register_buffer(f"{bucket.name}_folded", torch.from_numpy(
                bucket_folded(blocksize, bucket.starts, bucket.windows,
                              keep_from=keep_from, gain=self.gain(bucket))))
        else:
            self.register_buffer(f"{bucket.name}_windows",
                                 torch.from_numpy(bucket.windows))

    def tables(self, bucket):
        """(starts, table) device tables of a bucket: the folded matrix
        on the product route, an ``FftTable`` on the FFT route."""
        starts = getattr(self, f"{bucket.name}_starts")
        if self.use_mxu:
            return starts, getattr(self, f"{bucket.name}_folded")
        return starts, FftTable(getattr(self, f"{bucket.name}_windows"),
                                self.gain(bucket),
                                bucket.width - bucket.out_len)

    def row_slice(self, c: int, parts: int):
        """Chan rank ``c`` of ``parts``: a copy of this bank whose every
        bucket holds the rank's zero-padded slice of its channel rows
        (starts, windows and per-channel matrices; a shared matrix is
        every rank's), numbered from 0. The other buffers and attributes
        are this bank's."""
        out = copy.copy(self)
        out.__dict__["_buffers"] = dict(self._buffers)
        out.buckets = []
        for b in self.buckets:
            for key in ("starts", "folded", "windows"):
                t = self._buffers.get(f"{b.name}_{key}")
                # a shared matrix is every rank's
                if t is not None and not (key == "folded" and t.dim() == 2):
                    out._buffers[f"{b.name}_{key}"] = (
                        split_rows(t, parts)[c].contiguous())
            rows = split_rows(b.starts, parts)[c]
            out.buckets.append(dataclasses.replace(
                b, channel_ids=tuple(range(len(rows))), starts=rows,
                windows=split_rows(b.windows, parts)[c]))
        return out


@dataclass(frozen=True)
class _Bucket:
    width: int
    out_len: int
    channel_ids: tuple  # original channel indices, in order
    starts: np.ndarray  # [C] int32
    windows: np.ndarray  # [C, width] float32 phase-0 window amplitudes
    name: str  # buffer prefix of the bucket's device tables


class ThroughputChannelizer(BucketTables, nn.Module):
    """Width-bucketed fixed-channel extractor. Buffers per bucket:
    ``{name}_starts`` [C] int32 and, with ``use_mxu`` (the ``use_mxu_fft``
    knob), ``{name}_folded`` (window * gain l * trim * IDFT, rows
    interleaved): [2l, 2k] float32 shared by the bucket (kernel A), or
    [C, 2l, 2k] when the windows differ (kernel E); without it
    ``{name}_windows`` [C, l], the FFT route's."""

    def __init__(self, blocksize: int, relinvovl: int, channels,
                 windowtype: WindowType = WindowType.RECTANGULAR,
                 use_mxu: bool = False):
        super().__init__()
        self.blocksize = blocksize
        self.relinvovl = relinvovl
        self.use_mxu = bool(use_mxu)
        self.geometry = [
            solve_throughput_channel(blocksize, relinvovl, f, bw)
            for f, bw in channels
        ]
        by_width = {}
        for i, g in enumerate(self.geometry):
            by_width.setdefault(g.width, []).append(i)
        self.buckets = []
        for width in sorted(by_width):
            ids = by_width[width]
            starts = np.array(
                [self.geometry[i].start for i in ids], dtype=np.int32
            )
            wins = np.stack([
                base_window(windowtype, width, self.geometry[i].passband,
                            self.geometry[i].stopband)
                for i in ids
            ]).astype(np.float32)
            bucket = _Bucket(
                width=width, out_len=width - width // relinvovl,
                channel_ids=tuple(ids), starts=starts, windows=wins,
                name=f"w{width}",
            )
            self.buckets.append(bucket)
            self._register_tables(bucket, blocksize)

    @staticmethod
    def gain(bucket) -> float:
        """The trailing multiply_const l of the reference's chain
        (reference: python/FrequencyDomainChannelizer.py:231)."""
        return float(bucket.width)

    @property
    def num_channels(self) -> int:
        return len(self.geometry)

    def finish_bucket(self, bucket: _Bucket, y: torch.Tensor, t0,
                      prephased: bool = False) -> torch.Tensor:
        """[C, B, out_len, 2] trimmed extraction -> the per-channel stream
        matrix [C, B*out_len, 2]; applies the overlap-save phase
        compensation (window index (t * start) % R, reference:
        lib/phase_shifting_windowing_vcc_impl.cc:80-83) unless
        ``prephased``. ``t0``, the first row's global block index: an int,
        or a 0-d int32 tensor on ``y``'s device (the compiled step's: an
        int would be baked into its graph)."""
        b = y.shape[1]
        if not prephased:
            starts, _ = self.tables(bucket)
            t = t0 + torch.arange(b, dtype=torch.int32, device=y.device)
            y = apply_phase_pairs(
                y, (t[None, :] * starts[:, None]) % self.relinvovl,
                self.relinvovl,
            )
        return y.reshape(len(bucket.channel_ids), b * bucket.out_len, 2)
