# Copied from fdc_tpu/config.py; only the import paths differ.
"""Typed configuration for the TPU channelizer.

This module is the "config compiler" of the framework: it normalizes user
frequencies per frequency mode, rounds block geometry to powers of two, and
solves per-channel FFT geometry — the same derivation rules as the reference
hier block (reference: python/FrequencyDomainChannelizer.py:70-141,322-345)
and the reference C++ constructors
(lib/PowerActivationChannel_impl.cc:314-355, lib/SegmentDetection_impl.cc:592-637),
re-expressed as plain dataclasses that produce static, JIT-friendly geometry
tables.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass

import numpy as np

def nextpow2(k) -> int:
    """Smallest power of two >= k (reference: python/FrequencyDomainChannelizer.py:37-40)."""
    if k < 1:
        raise ValueError(f"Cannot evaluate next power of 2 of {k}")
    return 1 << int(math.ceil(math.log2(k)))


def is_pow2(k: int) -> bool:
    return k >= 1 and (k & (k - 1)) == 0


def mod1(x: float) -> float:
    """Positive modulo-1 wrap (reference: lib/SegmentDetection_impl.cc:700-703)."""
    return (x % 1.0 + 1.0) % 1.0


class FreqMode(enum.IntEnum):
    """Frequency-coordinate conventions for user-provided channel specs.

    All frequencies are stored internally normalized to FFT-bin coordinates in
    [0, 1) with 0.5 = DC (reference: python/FrequencyDomainChannelizer.py:68-89).
    """

    normalized = 0
    basebandfs = 1
    centerfreqfs = 2


class WindowType(enum.IntEnum):
    """Extraction window shapes (reference: lib/windows.h:28-32)."""

    RECTANGULAR = 0
    HANN = 1
    RAMP = 2


class VerboseMode(enum.IntEnum):
    """Logging modes (reference: python/FrequencyDomainChannelizer.py:34-35)."""

    NOLOG = 0
    LOGTOCONSOLE = 1
    LOGTOFILE = 2


_FREQMODE_ALIASES = {
    "normalized": FreqMode.normalized,
    "basebandfs": FreqMode.basebandfs,
    "centerfreqfs": FreqMode.centerfreqfs,
}

_WINDOW_ALIASES = {
    "rect": WindowType.RECTANGULAR,
    "rectangular": WindowType.RECTANGULAR,
    "hann": WindowType.HANN,
    "ramp": WindowType.RAMP,
}


def _as_freqmode(m) -> FreqMode:
    if isinstance(m, str):
        return _FREQMODE_ALIASES[m.lower()]
    return FreqMode(m)


def _as_windowtype(w) -> WindowType:
    if isinstance(w, str):
        return _WINDOW_ALIASES[w.lower()]
    return WindowType(w)


@dataclass(frozen=True)
class FreqConverter:
    """Maps user frequencies <-> internal [0,1) FDC coordinates.

    (reference: python/FrequencyDomainChannelizer.py:70-89)
    """

    mode: FreqMode
    fs: float = 1.0
    centerfrequency: float = 0.0

    def to_fdc_freq(self, f: float) -> float:
        if self.mode == FreqMode.normalized:
            return (f + 0.5) % 1.0
        if self.mode == FreqMode.basebandfs:
            return (f / self.fs + 0.5) % 1.0
        return ((f - self.centerfrequency) / self.fs + 0.5) % 1.0

    def from_fdc_freq(self, f: float) -> float:
        if self.mode == FreqMode.normalized:
            return f - 0.5
        if self.mode == FreqMode.basebandfs:
            return (f - 0.5) * self.fs
        return (f - 0.5) * self.fs + self.centerfrequency

    def to_fdc_bw(self, bw: float) -> float:
        if self.mode == FreqMode.normalized:
            return bw % 1.0
        return (bw / self.fs) % 1.0

    def from_fdc_bw(self, bw: float) -> float:
        if self.mode == FreqMode.normalized:
            return bw
        return bw * self.fs


# ---------------------------------------------------------------------------
# Solved static geometry records
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ThroughputChannelGeometry:
    """Solved geometry for one fixed always-on channel.

    Mirrors ``get_opt_channelparams``
    (reference: python/FrequencyDomainChannelizer.py:322-345): the channel is
    a contiguous slice of ``width`` FFT bins starting at ``start``, windowed
    and inverse-FFT'd, with the first ``width//relinvovl`` output samples
    (time-domain overlap) discarded.
    """

    start: int  # first FFT bin of the slice (fftshifted coordinates)
    width: int  # slice length l (power of 2)
    out_len: int  # l - l//relinvovl samples kept per block
    passband: float
    stopband: float


def solve_throughput_channel(
    blocksize: int, relinvovl: int, freq: float, bw: float
) -> ThroughputChannelGeometry:
    """Channel-parameter solver, same derivation as the reference.

    (reference: python/FrequencyDomainChannelizer.py:322-345)
    """
    passsamps = blocksize * bw
    width = nextpow2(passsamps)
    if width < 1.2 * passsamps:  # 20% headroom
        width *= 2

    passband = float(passsamps) / float(width) * 1.1
    stopband = 1.0
    if passband >= 1.0:
        passband = 1.0
    elif passband < 0.7:
        stopband = passband + 0.25

    start = int(round(freq * blocksize)) % blocksize
    start -= width // 2
    if start < 0:
        start = (start + blocksize) % blocksize
    if start + width > blocksize:
        start = blocksize - width

    out_len = int(width) - int(width) // relinvovl
    return ThroughputChannelGeometry(
        start=int(start),
        width=int(width),
        out_len=int(out_len),
        passband=float(passband),
        stopband=float(stopband),
    )


@dataclass(frozen=True)
class PowerChannelGeometry:
    """Solved geometry for one power-activated burst channel.

    Mirrors ``set_startstop`` (reference: lib/PowerActivationChannel_impl.cc:314-355):
    extraction slice [extract_start, extract_stop) of power-of-2 width,
    power measured over [measure_start, measure_stop).
    """

    extract_start: int
    extract_stop: int
    extract_width: int
    measure_start: int
    measure_stop: int
    ovl_skip: int  # extract_width // relinvovl, dropped per block
    out_len: int  # extract_width - ovl_skip
    delta_phase: int  # extract_start % relinvovl


def solve_power_channel(
    blocksize: int, relinvovl: int, cfreq: float, bw: float
) -> PowerChannelGeometry:
    bw = abs(bw)
    if bw > 1.0 or cfreq - bw / 2.0 < 0.0 or cfreq + bw / 2.0 > 1.0:
        raise ValueError(
            f"Desired channel is out of band: cfreq={cfreq}, bw={bw}"
        )

    extract_width = nextpow2(int(math.ceil(bw * blocksize)))
    if extract_width > blocksize:
        extract_width = blocksize

    mid = int(round(cfreq * blocksize))
    extract_start = mid - extract_width // 2
    if extract_start < 0:
        extract_start = 0
    extract_stop = extract_start + extract_width
    if extract_stop > blocksize:
        extract_stop = blocksize
        extract_start = extract_stop - extract_width

    measure_start = int(round((cfreq - bw / 2.0) * blocksize))
    measure_stop = int(round((cfreq + bw / 2.0) * blocksize))
    measure_start = max(measure_start, extract_start)
    measure_stop = min(measure_stop, extract_stop)

    ovl_skip = extract_width // relinvovl
    return PowerChannelGeometry(
        extract_start=extract_start,
        extract_stop=extract_stop,
        extract_width=extract_width,
        measure_start=measure_start,
        measure_stop=measure_stop,
        ovl_skip=ovl_skip,
        out_len=extract_width - ovl_skip,
        delta_phase=extract_start % relinvovl,
    )


@dataclass(frozen=True)
class SegmentGeometry:
    """Solved geometry for one activity-detection segment.

    Mirrors ``set_chan_start_stop_width_dec``
    (reference: lib/SegmentDetection_impl.cc:592-637): the segment covers
    ``width`` bins from ``start``, scanned as ``n_cells`` decimated power
    cells of ``decimation`` bins each.

    Deviation from the reference: when the segment is clamped at the upper
    band edge the reference erroneously resets ``d_start`` to 0
    (``d_start=d_stop-d_blocklen`` at lib/SegmentDetection_impl.cc:632); we
    keep the intended ``start = stop - width``.
    """

    start: int
    stop: int
    width: int
    decimation: int
    n_cells: int


def solve_segment(
    blocksize: int, seg_start: float, seg_stop: float, minchandist: float
) -> SegmentGeometry:
    minchandist = mod1(minchandist)
    seg_start = mod1(seg_start)
    seg_stop = mod1(seg_stop)

    if seg_start == seg_stop:
        raise ValueError("Segment start must not equal stop")
    if seg_start > seg_stop:
        seg_start, seg_stop = seg_stop, seg_start

    dec_f = blocksize * minchandist / 2.0
    decimation = 1 if dec_f < 2.0 else int(dec_f)

    width = int((seg_stop - seg_start) * blocksize)
    if width % decimation:
        width += decimation - width % decimation
    if width > blocksize:
        width = blocksize - (blocksize % decimation)

    mid = int(0.5 * (seg_start + seg_stop) * blocksize)
    start = 0 if mid < width // 2 else mid - width // 2
    stop = start + width
    if stop > blocksize:
        stop = blocksize
        start = stop - width  # reference bug fixed here (see docstring)

    return SegmentGeometry(
        start=start,
        stop=stop,
        width=width,
        decimation=decimation,
        n_cells=width // decimation,
    )


def split_segment_geometry(
    parent: SegmentGeometry, n_parts: int, overlap_cells: int
):
    """Partition one solved segment into ``n_parts`` sub-segments whose
    scan regions overlap by ``overlap_cells`` decimated cells at each cut.

    Each part scans ``[core - overlap, core + overlap)`` cells of the
    parent (clamped to the parent), on the parent's exact decimation grid
    — so every part computes bit-identical cell powers and edge ratios
    for the cells it shares with the parent (and with its neighbors).
    Candidate OWNERSHIP is by midpoint: a part keeps only candidates
    whose extraction midpoint bin (the same ``mid`` the reference's
    activate() centers on, lib/SegmentDetection_impl.cc:290-344) falls in
    its half-open core ``[core_start_bin, core_stop_bin)``. Cores tile
    the parent exactly, so a candidate seen by two parts in the overlap
    region is kept by exactly one (no double-spawn) and every candidate
    midpoint has an owner (no lost carrier), PROVIDED both its edges lie
    within the owner's scan region — carriers wider than
    ``2 * overlap_cells * decimation`` bins centered at a cut are the
    documented bounded deviation. Size ``overlap_cells`` to the widest
    expected carrier (not half): the margin must also cover the greedy
    ACCEPTANCE interaction of two carriers competing across a cut
    (candidates within each other's width — see
    tests/test_segment_split.py::test_split_under_margin_deviation_is_bounded
    for the under-margined regime's bound: never a lost or duplicated
    carrier, extents within one deactivation period).

    Why this exists: segments are independent automata (the reference
    runs one std::thread per segment,
    lib/activity_detection_channelizer_vcm_impl.cc:293-304), so more
    segments = more scan owners in the pipeline — this transform buys
    that parallelism for a single wide segment without changing the
    per-part detection math. Sub-segment borders behave exactly like the
    reference's own adjacent-segment borders (a carrier drifting across
    a cut retires in one part and spawns fresh in the next).

    Returns a list of ``(SegmentGeometry, (core_start_bin, core_stop_bin))``.
    """
    n_parts = int(n_parts)
    overlap_cells = int(overlap_cells)
    if n_parts < 2:
        raise ValueError("n_parts must be >= 2")
    if overlap_cells < 0:
        raise ValueError("overlap_cells must be >= 0")
    nc, dec = parent.n_cells, parent.decimation
    if n_parts > nc:
        raise ValueError(
            f"n_parts={n_parts} exceeds the segment's {nc} cells"
        )
    cpp = -(-nc // n_parts)  # ceil
    parts = []
    for p in range(n_parts):
        core_lo = p * cpp
        core_hi = min((p + 1) * cpp, nc)
        if core_lo >= core_hi:
            break  # fewer non-empty parts than requested (nc % n_parts)
        scan_lo = max(0, core_lo - overlap_cells)
        scan_hi = min(nc, core_hi + overlap_cells)
        g = SegmentGeometry(
            start=parent.start + scan_lo * dec,
            stop=parent.start + scan_hi * dec,
            width=(scan_hi - scan_lo) * dec,
            decimation=dec,
            n_cells=scan_hi - scan_lo,
        )
        core = (
            parent.start + core_lo * dec,
            parent.start + core_hi * dec,
        )
        parts.append((g, core))
    return parts


def solve_segment_vcm(
    blocksize: int, seg_start: float, seg_stop: float, minchandist: float
) -> SegmentGeometry:
    """Segment geometry with the multi-segment block's derivation rules
    (reference: lib/activity_detection_channelizer_vcm_impl.cc:248-279):
    rounding instead of truncation, while-loop width clamp, and a correct
    upper-edge clamp. Segments must be given as 0 <= start < stop <= 1."""
    if not (0.0 <= seg_start < seg_stop <= 1.0):
        raise ValueError(
            f"Segment must satisfy 0 <= start < stop <= 1, got "
            f"({seg_start}, {seg_stop})"
        )

    dec_f = blocksize * minchandist / 2.0
    decimation = 1 if dec_f < 2.0 else int(dec_f)

    mid = int(abs(round((seg_stop + seg_start) * 0.5 * blocksize)))
    width = int(abs(round((seg_stop - seg_start) * blocksize)))
    if width % decimation:
        width += decimation - width % decimation
    while width >= blocksize:
        width = blocksize - (blocksize % decimation)

    start = 0 if mid - width // 2 <= 0 else mid - width // 2
    stop = start + width
    if stop > blocksize:
        stop = blocksize
        start = blocksize - width

    return SegmentGeometry(
        start=start,
        stop=stop,
        width=width,
        decimation=decimation,
        n_cells=width // decimation,
    )


# ---------------------------------------------------------------------------
# Top-level config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChannelizerConfig:
    """Full system configuration, parameter-compatible with the reference
    hier block (reference: python/FrequencyDomainChannelizer.py:46-60 and the
    GRC schema grc/FDC_FrequencyDomainChannelizer.xml).

    TPU-specific knobs (no reference analog) are grouped at the bottom.
    """

    blocksize: int = 4096
    relinvovl: int = 4

    # (freq, bw) pairs in `freqmode` coordinates
    throughput_channels: tuple = ()
    # (cfreq, bw) pairs in `freqmode` coordinates
    activity_controlled_channels: tuple = ()
    act_contr_threshold: float = 10.0  # dB
    # (start_freq, stop_freq) pairs in `freqmode` coordinates
    activity_detection_segments: tuple = ()
    act_det_threshold: float = 6.0  # dB
    minchandist: float = 0.005
    act_det_deactivation_delay: int = 1
    minchanflankpuffer: float = 0.2
    pow_act_deactivation_delay: int = 0
    pow_act_maxblocks: int = 128
    act_det_maxblocks: int = 256

    fs: float = 1.0
    centerfrequency: float = 0.0
    freqmode: FreqMode = FreqMode.normalized
    windowtype: WindowType = WindowType.RECTANGULAR

    msgoutput: bool = True
    fileoutput: bool = False
    outputpath: str = ""
    verbose: VerboseMode = VerboseMode.NOLOG
    debug: bool = False

    # --- TPU-specific knobs ------------------------------------------------
    batch_blocks: int = 32  # FFT blocks processed per jitted step
    max_slots: int = 32  # per-segment fixed-capacity dynamic-channel table
    # Per-block detection candidates considered, strongest rising edges
    # first. 0 = exact: consider EVERY possible rising edge (K = n_cells-1),
    # matching the reference (lib/SegmentDetection_impl.cc:208-243); a
    # positive value bounds detection work to the strongest K edges per block.
    max_candidates: int = 0
    slot_capacity_blocks: int = 0  # 0 => derived: maxblocks + 2*batch_blocks
    max_extract_width: int = 0  # 0 => blocksize (dynamic channels)
    # Device-side detection-output compaction: ship only this many slots'
    # extraction rows per step (0 = all max_slots rows). Needy slots beyond
    # the budget lose their samples (counted + logged) — size it to the
    # worst-case concurrent channel count, not the slot-table capacity.
    extract_budget: int = 0
    # Optional SECOND, narrower extraction bucket: slots with extraction
    # width <= extract_width_split are served from a separate
    # [extract_budget_narrow, B+1, extract_width_split] tensor instead of
    # paying the full max_extract_width IFFT (pod-scale configs detect
    # mostly narrow carriers). 0 disables; wide slots (and narrow overflow)
    # spill into the main bucket.
    extract_width_split: int = 0
    extract_budget_narrow: int = 0
    # Subband inverse transforms as one real-representation matmul-DFT on
    # the MXU (Precision.HIGH) instead of the VPU FFT lowering. ON by
    # default: ~40% faster extraction on TPU (the overlap trim is folded
    # into the constant DFT matrix so dropped samples are never computed),
    # rel-RMS vs the FFT path ~1e-5. Set False to force the FFT lowering.
    use_mxu_fft: bool = True
    # "auto" = C++ emission engine when the native toolchain is available;
    # True forces it (raises if unavailable), False forces pure Python
    native_emission: object = "auto"
    # Segment partitioning: (seg_index, n_parts, overlap_cells) entries.
    # The indexed activity_detection_segment is expanded into n_parts
    # sub-segments scanning the parent's decimation grid with
    # overlap_cells of shared margin at each cut (see
    # split_segment_geometry) — more segments = more independent scan
    # automata = more pipeline scan owners. Sub-segments take consecutive
    # segment ids in expansion order (segment numbering shifts, exactly
    # as if the config had listed the parts as separate segments).
    segment_splits: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "blocksize", nextpow2(self.blocksize))
        object.__setattr__(self, "relinvovl", nextpow2(self.relinvovl))
        object.__setattr__(self, "freqmode", _as_freqmode(self.freqmode))
        object.__setattr__(self, "windowtype", _as_windowtype(self.windowtype))
        object.__setattr__(self, "verbose", VerboseMode(self.verbose))
        if self.act_contr_threshold <= 0.0:
            raise ValueError("act_contr_threshold is dB and must be > 0")
        if self.act_det_threshold < 0.0:
            raise ValueError("act_det_threshold is dB and must be >= 0")
        if self.minchanflankpuffer < 0.0:
            raise ValueError("minchanflankpuffer must be >= 0")
        for name in ("throughput_channels", "activity_controlled_channels",
                     "activity_detection_segments"):
            v = getattr(self, name)
            if v is None:
                v = ()
            # reject non-pair entries with the reference's error contract
            # (reference: python/FrequencyDomainChannelizer.py:99-102,349-357
            # — get_channel returns None for anything but a 2-list/tuple
            # and the caller raises ValueError)
            norm = []
            for c in v:
                if (not isinstance(c, (list, tuple, np.ndarray))
                        or len(c) != 2):
                    raise ValueError(
                        f"Cannot convert {c!r} to a {name} entry: must be "
                        f"a (frequency, bandwidth) / (start, stop) pair"
                    )
                norm.append(tuple(float(x) for x in c))
            object.__setattr__(self, name, tuple(norm))
        splits = []
        seen_idx = set()
        for s in (self.segment_splits or ()):
            if not isinstance(s, (list, tuple)) or len(s) != 3:
                raise ValueError(
                    f"segment_splits entry {s!r}: must be "
                    f"(seg_index, n_parts, overlap_cells)"
                )
            idx, n_parts, ovl = (int(x) for x in s)
            if not 0 <= idx < len(self.activity_detection_segments):
                raise ValueError(
                    f"segment_splits index {idx} out of range for "
                    f"{len(self.activity_detection_segments)} segments"
                )
            if idx in seen_idx:
                raise ValueError(f"segment_splits: duplicate index {idx}")
            seen_idx.add(idx)
            if n_parts < 2:
                raise ValueError("segment_splits n_parts must be >= 2")
            if ovl < 0:
                raise ValueError("segment_splits overlap_cells must be >= 0")
            splits.append((idx, n_parts, ovl))
        object.__setattr__(self, "segment_splits", tuple(splits))

    # -- derived geometry ----------------------------------------------------

    @property
    def ovllen(self) -> int:
        return self.blocksize // self.relinvovl

    @property
    def inplen(self) -> int:
        """New samples consumed per FFT block."""
        return self.blocksize - self.ovllen

    @property
    def converter(self) -> FreqConverter:
        return FreqConverter(self.freqmode, self.fs, self.centerfrequency)

    @property
    def slot_capacity(self) -> int:
        if self.slot_capacity_blocks:
            return self.slot_capacity_blocks
        base = max(self.act_det_maxblocks, 1)
        return base + 2 * self.batch_blocks + 2

    @property
    def dyn_extract_width(self) -> int:
        return self.max_extract_width or self.blocksize

    def fdc_throughput_channels(self):
        conv = self.converter
        return [
            (conv.to_fdc_freq(f), conv.to_fdc_bw(bw))
            for f, bw in self.throughput_channels
        ]

    def fdc_activity_controlled_channels(self):
        conv = self.converter
        return [
            (conv.to_fdc_freq(f), conv.to_fdc_bw(bw))
            for f, bw in self.activity_controlled_channels
        ]

    def fdc_activity_detection_segments(self):
        conv = self.converter
        return [
            (conv.to_fdc_freq(a), conv.to_fdc_freq(b))
            for a, b in self.activity_detection_segments
        ]

    def fdc_minchandist(self) -> float:
        return self.converter.to_fdc_bw(self.minchandist)

    def replace(self, **kw) -> "ChannelizerConfig":
        return dataclasses.replace(self, **kw)

    # -- declarative form (the GRC XML schema role, reference:
    # grc/FDC_FrequencyDomainChannelizer.xml param blocks) -------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["freqmode"] = self.freqmode.name
        d["windowtype"] = self.windowtype.name
        d["verbose"] = self.verbose.name
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ChannelizerConfig":
        d = dict(d)
        if isinstance(d.get("verbose"), str):
            d["verbose"] = VerboseMode[d["verbose"]]
        return cls(**d)

    def to_json(self) -> str:
        import json

        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ChannelizerConfig":
        import json

        return cls.from_dict(json.loads(s))
