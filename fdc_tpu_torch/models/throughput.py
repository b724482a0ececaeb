"""Static ("throughput") channels: fixed always-on extraction.

Port of ``fdc_tpu.models.throughput`` (reference:
python/FrequencyDomainChannelizer.py:218-231): channels sharing an FFT
width form one bucket, extracted together by kernel A — or by kernel E
when their windows differ (channels of different bandwidths that round
to one power-of-2 width).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from fdc_tpu_torch.config import WindowType, solve_throughput_channel
from fdc_tpu_torch.ops.extract import apply_phase_pairs, bucket_folded
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
    the buffers ``{name}_starts`` / ``{name}_folded``)."""

    def tables(self, bucket):
        """(starts, folded) device tables of a bucket."""
        return (getattr(self, f"{bucket.name}_starts"),
                getattr(self, f"{bucket.name}_folded"))

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
            starts, folded = self.tables(b)
            out._buffers[f"{b.name}_starts"] = (
                split_rows(starts, parts)[c].contiguous())
            if folded.dim() == 3:
                out._buffers[f"{b.name}_folded"] = (
                    split_rows(folded, parts)[c].contiguous())
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
    ``{name}_starts`` [C] int32 and ``{name}_folded`` (window * gain l *
    trim * IDFT, rows interleaved): [2l, 2k] float32 shared by the bucket
    (kernel A), or [C, 2l, 2k] when the windows differ (kernel E)."""

    def __init__(self, blocksize: int, relinvovl: int, channels,
                 windowtype: WindowType = WindowType.RECTANGULAR):
        super().__init__()
        self.blocksize = blocksize
        self.relinvovl = relinvovl
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
            self.register_buffer(f"{bucket.name}_starts",
                                 torch.from_numpy(starts))
            self.register_buffer(f"{bucket.name}_folded", torch.from_numpy(
                bucket_folded(
                    blocksize, starts, wins,
                    keep_from=width - bucket.out_len, gain=float(width),
                )
            ))

    @property
    def num_channels(self) -> int:
        return len(self.geometry)

    def finish_bucket(self, bucket: _Bucket, y: torch.Tensor, t0: int,
                      prephased: bool = False) -> torch.Tensor:
        """[C, B, out_len, 2] trimmed extraction -> the per-channel stream
        matrix [C, B*out_len, 2]; applies the overlap-save phase
        compensation (window index (t * start) % R, reference:
        lib/phase_shifting_windowing_vcc_impl.cc:80-83) unless
        ``prephased``."""
        b = y.shape[1]
        if not prephased:
            starts, _ = self.tables(bucket)
            t = t0 + torch.arange(b, dtype=torch.int32, device=y.device)
            y = apply_phase_pairs(
                y, (t[None, :] * starts[:, None]) % self.relinvovl,
                self.relinvovl,
            )
        return y.reshape(len(bucket.channel_ids), b * bucket.out_len, 2)
