"""FrequencyDomainChannelizer — the top-level system, on PyTorch.

Port of ``fdc_tpu.models.channelizer`` (reference:
python/FrequencyDomainChannelizer.py:42-316): one overlap-save FFT
front-end feeding throughput channels, power-activated burst channels
and activity-detection segments. Construction solves the static
geometry and registers the constant tables as buffers on ``device``; the
step ``(carry, samples, t0) -> (carry, outputs)`` processes
``batch_blocks`` FFT blocks at a time through the hand-written kernels,
and the host loop (``process`` / ``flush``) buffers samples
into batches and runs the emission layer. As ``fdc_tpu`` jits its
steps, ``process``, ``process_spectra`` and ``flush`` run theirs
compiled (``runtime.compiled.CompiledStep``: one captured CUDA graph a
batch shape on the card), with ``t0`` a device scalar; ``_device_step``
stays the eager step. ``process_spectra`` is the
pre-FFT'd entry point (the reference's vector-input mode): it feeds
normalized fftshifted spectra past the framing and the FFT.

The carry is a plain dict of tensors with the JAX package's keys
(``hist``, ``prev_spec``, ``powact``, ``seg{i}``) and the step outputs
follow its contract (``throughput_buckets``, ``powact{...}``,
``seg{i}{...}``) with extraction outputs in the float32 [..., 2] pair
layout, so the two implementations compare key by key and a carry moves
between them (``fdc_tpu_torch.convert``).

Both settings of ``use_mxu_fft`` run, as in ``fdc_tpu``: on (the default)
the static buckets extract through kernels A / E and the slots through
one product with an IDFT matrix; off, every subband transform is
``torch.fft`` (cuFFT on the card) and the detection measures are a
separate pass. Any power-of-2 blocksize runs: kernel F up to 16384
points, its two-pass form above.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from fdc_tpu_torch.config import (
    ChannelizerConfig,
    VerboseMode,
    solve_segment,
    split_segment_geometry,
)
from fdc_tpu_torch.models.power_activation import (
    _FLOAT_MIN as _PA_FLOAT_MIN,
    PowerActivationBank,
)
from fdc_tpu_torch.models.segment_detection import (
    SegmentDetector,
    scan_slots_multi,
)
from fdc_tpu_torch.models.throughput import ThroughputChannelizer
from fdc_tpu_torch.ops import detect as detect_ops
from fdc_tpu_torch.ops.extract import (
    FftTable,
    bucket_folded,
    extract_bucket,
    extract_bucket_measured,
    extract_bucket_phased,
    measures_ride,
)
from fdc_tpu_torch.ops.extract_fused import mask_extent
from fdc_tpu_torch.ops.fft import forward_spectrum
from fdc_tpu_torch.ops.framing import frame_blocks
from fdc_tpu_torch.runtime.compiled import (
    CompiledStep,
    GraphPool,
    HostMirror,
    StagingSlot,
    _to_host,
    install_carry,
)
from fdc_tpu_torch.runtime.emission import (
    NativePowerActivationEmitter,
    NativeSegmentDetectionEmitter,
    PowerActivationEmitter,
    SegmentDetectionEmitter,
)
from fdc_tpu_torch.runtime import tracing
from fdc_tpu_torch.utils.events import ChannelEvent, FileSink
from fdc_tpu_torch.utils.logging import make_logger

__all__ = [
    "FrequencyDomainChannelizer",
    "ProcessResult",
    "finalize_rounds_bound",
]


def resolve_device(device) -> torch.device:
    """The module's torch device: ``"cuda"`` (the default of the entry
    points) must have a CUDA device behind it; there is no CPU fallback
    (``"cpu"`` asks for the kernels' plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fdc_tpu_torch: no CUDA device (the kernels run on the card); "
            "pass device='cpu' for their plain PyTorch versions"
        )
    return dev


def finalize_rounds_bound(segments, batch_blocks: int) -> int:
    """Upper bound on the end-of-stream silence batches a finalize pass
    may need: burst channels fall on the first silent block; detection
    slots age out after deactivation_delay + 1 silent blocks (plus one
    block for the emit itself)."""
    max_delay = max((sd.deactivation_delay for sd in segments), default=0)
    return -(-(max_delay + 2) // batch_blocks) + 1


@dataclass
class ProcessResult:
    """Host-side result of processing a chunk of samples."""

    # per configured throughput channel: contiguous complex64 output stream
    throughput: List[np.ndarray] = field(default_factory=list)
    # burst / detection events in emission order (PDU equivalents)
    events: List[ChannelEvent] = field(default_factory=list)
    # [B_total, N] normalized spectra if debug=True (reference debug port,
    # python/FrequencyDomainChannelizer.py:152-158,314-315)
    debug_spectrum: Optional[np.ndarray] = None
    # [B_total, n_cells] decimated power per detection segment
    segment_power: List[np.ndarray] = field(default_factory=list)
    blocks_processed: int = 0


def emitter_classes(native_emission):
    """(burst emitter class, segment emitter class): the native (C++) ones
    for a true ``native_emission``, the Python ones for a false one, and
    for ``"auto"`` the native ones when their library builds (JAX:
    models/channelizer.py:226-240)."""
    use_native = native_emission
    if use_native == "auto":
        from fdc_tpu_torch.runtime import native

        use_native = native.available()
    if use_native:
        return NativePowerActivationEmitter, NativeSegmentDetectionEmitter
    return PowerActivationEmitter, SegmentDetectionEmitter


def _pairs_to_complex(a: np.ndarray) -> np.ndarray:
    """float32 [..., 2] pairs -> complex64 [...]."""
    with tracing.span("fdc.pairs_to_complex"):
        return np.ascontiguousarray(a, np.float32).view(np.complex64)[..., 0]


def emit_segment(emitter, so, t0: int, i: int):
    """Segment ``i``'s step outputs on the host (views of a host mirror)
    into its emitter: the extraction pairs as complex, then the emitter's
    events at block ``t0``."""
    so["extract"] = _pairs_to_complex(so["extract"])
    if "extract_narrow" in so:
        so["extract_narrow"] = _pairs_to_complex(so["extract_narrow"])
    with tracing.span("fdc.emit", i):
        return emitter.process_step(so, so["slot_meta"], t0)


class FrequencyDomainChannelizer(nn.Module):
    """Parameter-compatible top-level channelizer on one torch device.

    ``device`` defaults to ``"cuda"``, the hand-written kernels (the
    constructor raises without a CUDA device); ``"cpu"`` runs their plain
    PyTorch versions. Use
    ``process(samples)`` / ``flush()`` for the buffered streaming API
    (or ``process_spectra(spectra)`` / ``flush()`` on pre-FFT'd spectra;
    one entry point per stream), or drive ``_device_step`` directly.
    Constructing one sets ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False process-wide: TF32 would
    cost ~40 dB of extraction SNR (the reference keeps fp32).

    The streaming API runs the step compiled (``_jit_step``,
    ``_jit_step_spectra``, as ``fdc_tpu`` names its jitted steps): its
    outputs are overwritten by the next step, so ``_consume_outputs``
    copies them to the host first, into the stream's host mirror
    (``runtime.compiled.HostMirror``) whose views nothing kept past the
    batch points into, and ``self._carry`` is the compiled step's static
    carry. A subclass whose step cannot run so sets ``compile_step =
    False`` and runs ``_device_step`` eagerly. Each batch is written
    once, the buffered remainder first, into the stream's staging slot
    (``runtime.compiled.StagingSlot``); what is left of less than a batch
    is buffered as a copy.
    """

    compile_step = True

    def __init__(self, config: Optional[ChannelizerConfig] = None, *,
                 device="cuda", **kwargs):
        super().__init__()
        if config is None:
            config = ChannelizerConfig(**kwargs)
        elif kwargs:
            config = config.replace(**kwargs)
        self.config = cfg = config
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.log = make_logger(cfg.verbose, "gr-FDC.FreqDomChan.log")

        # -- sub-models (static geometry solved here) -------------------------
        self.throughput: Optional[ThroughputChannelizer] = None
        tp_chans = cfg.fdc_throughput_channels()
        if tp_chans:
            self.throughput = ThroughputChannelizer(
                cfg.blocksize, cfg.relinvovl, tp_chans, cfg.windowtype,
                use_mxu=cfg.use_mxu_fft,
            )
        self.power_bank: Optional[PowerActivationBank] = None
        pa_chans = cfg.fdc_activity_controlled_channels()
        if pa_chans:
            self.power_bank = PowerActivationBank(
                cfg.blocksize, cfg.relinvovl, pa_chans,
                cfg.act_contr_threshold, use_mxu=cfg.use_mxu_fft,
            )
        # -- fused extraction plan ---------------------------------------------
        # throughput + burst channels sharing an FFT width extract as one
        # bucket over spec_ext (JAX: models/channelizer.py:255-271); the
        # throughput gain folds into its (linear) windows. Their windows
        # differ, so the table is per channel (kernel E), or the windows
        # on the FFT route.
        self._fused = {}
        if self.throughput and self.power_bank:
            tp_by_w = {b.width: b for b in self.throughput.buckets}
            pa_by_w = {b.width: b for b in self.power_bank.buckets}
            for w in sorted(set(tp_by_w) & set(pa_by_w)):
                tb, pb = tp_by_w[w], pa_by_w[w]
                starts = np.concatenate([tb.starts, pb.starts])
                wins = np.concatenate([tb.windows * np.float32(w),
                                       pb.windows])
                name = f"fused_w{w}"
                self.register_buffer(f"{name}_starts",
                                     torch.from_numpy(starts))
                if cfg.use_mxu_fft:
                    self.register_buffer(f"{name}_folded", torch.from_numpy(
                        bucket_folded(cfg.blocksize, starts, wins,
                                      keep_from=w - pb.out_len, gain=1.0)
                    ))
                else:
                    self.register_buffer(f"{name}_windows",
                                         torch.from_numpy(wins))
                self._fused[w] = (name, tb)
        # a split segment expands into parts on the parent's cell grid
        # with overlapping scan margins (config.split_segment_geometry),
        # each a SegmentDetector with the next segment id; the adjacency
        # {part: (lower part | None, upper part | None)} drives the cut
        # reconciliation (JAX: models/channelizer.py:128-181)
        self.segments = nn.ModuleList()
        self._split_neighbors = {}
        splits = {idx: (n, ovl) for idx, n, ovl in cfg.segment_splits}
        for i, (a, b) in enumerate(cfg.fdc_activity_detection_segments()):
            geoms = [(None, None)]
            if i in splits:
                parent = solve_segment(cfg.blocksize, a, b,
                                       cfg.fdc_minchandist())
                geoms = split_segment_geometry(parent, *splits[i])
            base = len(self.segments)
            if len(geoms) > 1:
                for p in range(len(geoms)):
                    self._split_neighbors[base + p] = (
                        base + p - 1 if p > 0 else None,
                        base + p + 1 if p + 1 < len(geoms) else None,
                    )
            for geom, core in geoms:
                self.segments.append(SegmentDetector(
                    len(self.segments), cfg.blocksize, cfg.relinvovl, a, b,
                    cfg.act_det_threshold, cfg.fdc_minchandist(),
                    cfg.minchanflankpuffer if cfg.minchanflankpuffer >= 0
                    else 0.2,
                    cfg.act_det_deactivation_delay
                    if cfg.act_det_deactivation_delay >= 0 else 0,
                    cfg.max_slots, cfg.max_candidates, cfg.max_extract_width,
                    geometry=geom,
                    extract_budget=cfg.extract_budget,
                    extract_width_split=cfg.extract_width_split,
                    extract_budget_narrow=cfg.extract_budget_narrow,
                    core_bins=core,
                    use_mxu=cfg.use_mxu_fft,
                ))

        # -- per-component lifecycle loggers (reference:
        # lib/SegmentDetection_impl.cc:49-57,474-481,
        # lib/PowerActivationChannel_impl.cc:52-60,245-253) -----------------
        verbose_on = cfg.verbose != VerboseMode.NOLOG
        seg_logs = []
        for i, sd in enumerate(self.segments):
            lg = None
            if verbose_on:
                lg = make_logger(cfg.verbose, f"gr-FDC.ActDetChan.ID_{i}.log")
                g = sd.geometry
                # constructor banner (reference: lib/SegmentDetection_impl.cc:109-113)
                lg(f"Threshold               {sd.thresh:g}")
                lg(f"decimation factor       {g.decimation}")
                lg(f"start                   {g.start}")
                lg(f"stop                    {g.stop}")
                lg(f"width                   {g.width}")
            seg_logs.append(lg)
        pa_logs = None
        if self.power_bank and verbose_on:
            pa_logs = []
            for c, g in enumerate(self.power_bank.geometry):
                lg = make_logger(cfg.verbose, f"gr-FDC.PowActChan.{c}.log")
                # constructor banner (reference:
                # lib/PowerActivationChannel_impl.cc:112-123)
                s0 = "############################\n\n"
                lg(
                    s0 + f"# gr-FDC.PowActChan.{c}\n\n" + s0
                    + f"# extract_start: {g.extract_start}\n"
                    + f"# extract_stop: {g.extract_stop}\n"
                    + f"# extract_width: {g.extract_width}\n"
                    + f"# measure_start: {g.measure_start}\n"
                    + f"# measure_stop: {g.measure_stop}\n\n"
                    + "# equivalent cfreq: "
                    + f"{(g.extract_start + g.extract_width / 2) / cfg.blocksize:.6f}\n"
                    + f"# equivalent bw: {g.extract_width / cfg.blocksize:.6f}\n"
                )
                pa_logs.append(lg)

        # -- host emission layer: the native (C++) emitters, or the Python
        # ones ("auto": native when g++ builds the engine) ------------------
        sink = FileSink(cfg.outputpath, self.log) if cfg.fileoutput else None
        pa_cls, sd_cls = emitter_classes(cfg.native_emission)
        self.power_emitter = (
            pa_cls(self.power_bank, cfg.pow_act_maxblocks, sink,
                   cfg.msgoutput, channel_logs=pa_logs)
            if self.power_bank else None
        )
        self.segment_emitters = [
            sd_cls(sd, cfg.act_det_maxblocks, sink, cfg.msgoutput,
                   log=seg_logs[i])
            for i, sd in enumerate(self.segments)
        ]

        # -- fused power measures ---------------------------------------------
        # One [N, Cm] 0/1 mask matrix holding every detection consumer's
        # measure columns (burst bands + segment decimation cells), zero
        # padded to a multiple of 128 columns. Kernel A computes
        # |X|^2 @ masks alongside the first throughput bucket's extraction;
        # its accumulation order differs from the separate reduces at
        # ~1e-7 rel, far inside the dB-scale detection thresholds.
        self.register_buffer("measure_masks", None)
        self._measure_cols = {}
        self._measure_extent = None
        if (self.power_bank or len(self.segments)) and self.throughput:
            cols = []
            off = 0
            if self.power_bank:
                cols.append(self.power_bank.measure_masks.numpy())
                self._measure_cols["powact"] = (
                    0, self.power_bank.num_channels
                )
                off = self.power_bank.num_channels
            for i, sd in enumerate(self.segments):
                g = sd.geometry
                m = np.zeros((cfg.blocksize, g.n_cells), np.float32)
                for c in range(g.n_cells):
                    m[g.start + c * g.decimation:
                      g.start + (c + 1) * g.decimation, c] = 1.0
                cols.append(m)
                self._measure_cols[f"seg{i}"] = (off, off + g.n_cells)
                off += g.n_cells
            mm = np.concatenate(cols, axis=1)
            pad = (-mm.shape[1]) % 128
            if pad:
                mm = np.pad(mm, ((0, 0), (0, pad)))
            self.register_buffer("measure_masks", torch.from_numpy(mm))
            # the used columns and the bins they cover: kernel A skips the
            # zero padding and the bins no measure reads
            self._measure_extent = mask_extent(mm)

        # -- streaming state ---------------------------------------------------
        self._carry = None
        self._t0 = 0  # global index of next block
        self._pending = np.zeros(0, np.complex64)  # host sample buffer
        # pre-FFT'd mode: buffered spectrum rows, and which entry point
        # drives this stream (flush feeds silence in its flavor)
        self._pending_spec = np.zeros((0, cfg.blocksize), np.complex64)
        self._spectra_mode = False
        self._samples_mode = False
        # the staging slot a batch is written into and copied in from, and
        # the host mirror the step's outputs are copied out into
        # (``_consume``); reset() keeps both
        self._staging = StagingSlot(self.device)
        self._mirror = HostMirror()
        self.to(self.device)
        # the compiled steps (JAX: jax.jit of the same functions) share
        # one graph memory pool; the init only allocates the carry, which
        # the first compiled call copies into its static buffers
        pool = GraphPool()
        self._jit_step = CompiledStep(self._device_step, self.device,
                                      pool=pool)
        self._jit_step_spectra = CompiledStep(self._device_step_spectra,
                                              self.device, pool=pool)
        self._jit_init = self._device_init

        if cfg.verbose:
            self.log("# fdc_tpu_torch FrequencyDomainChannelizer")
            self.log(f"Blocksize     = {cfg.blocksize}")
            self.log(f"Relinvovl     = {cfg.relinvovl}")
            self.log(f"Ovllen        = {cfg.ovllen}")
            self.log(f"BatchBlocks   = {cfg.batch_blocks}")
            self.log(f"Throughput channels:         {cfg.throughput_channels}")
            self.log(f"Activity control channels:   {cfg.activity_controlled_channels}")
            self.log(f"Activity detection segments: {cfg.activity_detection_segments}")

    # -- device functions -------------------------------------------------------

    def _device_init(self):
        cfg = self.config
        dev = self.device
        carry = {
            "hist": torch.zeros(cfg.ovllen, dtype=torch.complex64,
                                device=dev),
            "prev_spec": torch.zeros(cfg.blocksize, dtype=torch.complex64,
                                     device=dev),
        }
        if self.power_bank:
            carry["powact"] = self.power_bank.init_state(dev)
        for i, sd in enumerate(self.segments):
            carry[f"seg{i}"] = sd.init_state(dev)
        return carry

    def _device_step(self, carry, x: torch.Tensor, t0):
        """One step over B = len(x) // inplen blocks.

        x: [B*inplen] complex64 samples on the module's device; t0: global
        index of the first block, an int or (compiled) a 0-d int32 tensor
        on the module's device. Returns (new_carry, outputs)."""
        cfg = self.config
        blocks, hist = frame_blocks(x, carry["hist"], cfg.blocksize)
        # the front end writes rows 1..B of the extended spectrum in place
        # (row 0: the previous batch's last row), so no copy joins them
        spec_ext = torch.empty((blocks.shape[0] + 1, cfg.blocksize),
                               dtype=torch.complex64, device=blocks.device)
        spec_ext[0] = carry["prev_spec"]
        forward_spectrum(blocks, use_mxu=cfg.use_mxu_fft, out=spec_ext[1:])
        new_carry = dict(carry)
        new_carry["hist"] = hist
        return self._step_from_spec(new_carry, spec_ext, t0)

    def _device_step_spectra(self, carry, spec: torch.Tensor, t0):
        """Pre-FFT'd step (the reference's vector-input mode, reference:
        python/FrequencyDomainChannelizer.py:201-216): spec is [B, N]
        complex64, already normalized fftshifted spectra; the framing
        history is left as it is."""
        spec_ext = torch.cat([carry["prev_spec"][None], spec])
        return self._step_from_spec(dict(carry), spec_ext, t0)

    def _step_from_spec(self, new_carry, spec_ext, t0):
        """The step after the front end. ``spec_ext``: [B + 1, N], the
        carried last row of the previous batch, then this batch's
        spectra; ``t0`` as :meth:`_device_step` takes it."""
        cfg = self.config
        spec = spec_ext[1:]
        new_carry["prev_spec"] = spec[-1].clone()

        out, pa_powers, pa_ext, seg_powers, seg_packed = (
            self._extract_static(spec, spec_ext, t0)
        )
        scans = self._scan_detections(new_carry, pa_powers, seg_packed)
        extracts = self._extract_slots_all(
            spec_ext, [st for st, _ in scans["segs"]],
            [so for _, so in scans["segs"]])
        self._assemble_detections(out, scans, extracts, pa_ext, seg_powers)
        if cfg.debug:
            out["debug_spectrum"] = torch.view_as_real(spec)
        return new_carry, out

    def _extract_static(self, spec, spec_ext, t0, detect=True):
        """Throughput / burst extraction and the detection power measures
        and candidate packs — everything that does not depend on
        detection state. ``spec``: [b, N] rows of global blocks t0 ...
        t0 + b - 1 (a batch, or a time rank's run of one), t0 a multiple
        of b; ``detect=False`` skips the measures and packs (a rank that
        extracts only its channel rows). Returns (out, pa_powers, pa_ext,
        seg_powers, seg_packed)."""
        cfg = self.config
        r = cfg.relinvovl
        out = {}
        # fused throughput + burst buckets over spec_ext: the throughput
        # part takes rows 1..B and its phase from t0 (finish_bucket), the
        # burst part keeps every row (JAX: models/channelizer.py:405-418)
        fused_mats = {}
        fused_pa_ext = {}
        for w, (name, tb) in self._fused.items():
            y = extract_bucket(spec_ext, *self._fused_tables(name, w))
            n_tp = len(tb.channel_ids)
            fused_mats[w] = self.throughput.finish_bucket(tb, y[:n_tp, 1:],
                                                          t0)
            fused_pa_ext[w] = y[n_tp:]
        powers_fused = None
        if self.throughput:
            # t0 is a multiple of b, so with b % R == 0 the per-row phase
            # pattern is static (extract_bucket_phased)
            fold_phase = spec.shape[0] % r == 0
            mats = []
            for bucket in self.throughput.buckets:
                if bucket.width in fused_mats:
                    mats.append(fused_mats[bucket.width])
                    continue
                starts, folded = self.throughput.tables(bucket)
                if not fold_phase:
                    y = extract_bucket(spec, starts, folded)
                    mats.append(self.throughput.finish_bucket(bucket, y, t0))
                    continue
                if (detect and self.measure_masks is not None
                        and powers_fused is None and measures_ride(folded)):
                    # the detection measures ride the first non-fused
                    # shared-matrix bucket's kernel A launch (the FFT
                    # route returns no powers: the |X|^2 pass below)
                    y, powers_fused = extract_bucket_measured(
                        spec, starts, folded, r, self.measure_masks,
                        self._measure_extent
                    )
                else:
                    y = extract_bucket_phased(spec, starts, folded, r)
                mats.append(self.throughput.finish_bucket(
                    bucket, y, t0, prephased=True
                ))
            out["throughput_buckets"] = mats
        sq = None
        if (detect and (self.power_bank or len(self.segments))
                and powers_fused is None):
            sf = torch.view_as_real(spec)
            sq = sf[..., 0] * sf[..., 0] + sf[..., 1] * sf[..., 1]
        pa_powers = None
        pa_ext = None
        if self.power_bank:
            pa = self.power_bank
            if powers_fused is not None:
                lo, hi = self._measure_cols["powact"]
                pa_powers = torch.clamp(powers_fused[:, lo:hi],
                                        min=float(_PA_FLOAT_MIN))
            elif detect:
                pa_powers = pa.measure(sq)
            # burst extraction is flag-independent: every channel, every
            # row of spec_ext (the flags select what the host emits)
            pa_ext = dict(fused_pa_ext)
            for bucket in pa.buckets:
                if bucket.width not in pa_ext:
                    pa_ext[bucket.width] = extract_bucket(
                        spec_ext, *pa.tables(bucket))
        seg_powers = []
        for i, sd in enumerate(self.segments if detect else ()):
            if powers_fused is not None:
                lo, hi = self._measure_cols[f"seg{i}"]
                seg_powers.append(powers_fused[:, lo:hi])
            else:
                seg_powers.append(sd.measure(sq))
        # every segment's candidate pack in one kernel B launch: views of
        # one flat buffer in kernel C's layout
        seg_packed = detect_ops.candidate_packs(
            seg_powers, [sd.pack_spec for sd in self.segments]
        ) if seg_powers else []
        return out, pa_powers, pa_ext, seg_powers, seg_packed

    def _fused_tables(self, name: str, w: int):
        """(starts, table) of the fused family ``name`` of width ``w``:
        its per-channel matrices, or an ``FftTable`` on the FFT route."""
        starts = getattr(self, f"{name}_starts")
        if self.config.use_mxu_fft:
            return starts, getattr(self, f"{name}_folded")
        tb = self._fused[w][1]
        return starts, FftTable(getattr(self, f"{name}_windows"), 1.0,
                                w - tb.out_len)

    def _scan_detections(self, carry_io, pa_powers, seg_packed):
        """The sequential detection logic — slot lifecycles and the burst
        hysteresis in one kernel C launch, or the burst hysteresis alone
        in kernel D without segments — and the extraction plans. Updates
        ``carry_io`` in place; returns the flags/plans."""
        scans = {"segs": []}
        seg_killed = self._reconcile_splits(
            carry_io, seg_packed,
            {i: carry_io[f"seg{i}"] for i in self._split_neighbors},
        )
        if not len(self.segments):
            if self.power_bank:
                carry_io["powact"], scans["powact"] = (
                    self.power_bank.scan_flags(pa_powers, carry_io["powact"])
                )
            return scans
        states = [carry_io[f"seg{i}"] for i in range(len(self.segments))]
        if self.power_bank:
            seg_scans, (pa_state, flags) = scan_slots_multi(
                self.segments, states, seg_packed,
                powact=(self.power_bank, pa_powers, carry_io["powact"]),
            )
            carry_io["powact"] = pa_state
            scans["powact"] = flags
        else:
            seg_scans = scan_slots_multi(self.segments, states, seg_packed)
        for i, sd in enumerate(self.segments):
            seg_state, flags = seg_scans[i]
            carry_io[f"seg{i}"] = seg_state
            so = sd.plan_outputs(seg_state, flags)
            if i in seg_killed:
                so["killed"] = seg_killed[i]
            scans["segs"].append((seg_state, so))
        return scans

    def _reconcile_splits(self, carry_io, seg_packed, entry_states):
        """The split parts' cut reconciliation
        (:meth:`SegmentDetector.reconcile_split`) against
        ``entry_states``, every part's state at the end of the previous
        batch: kills duplicate slots at the cuts (the lower part wins) and
        suppresses candidates a neighbor tracks. Updates ``carry_io`` and
        the packs of ``seg_packed`` in place; returns {segment: killed [S]
        bool} for the emitters (JAX: models/channelizer.py:567-595)."""
        seg_killed = {}
        for i, (lo, hi) in self._split_neighbors.items():
            kill_from = [] if lo is None else [
                SegmentDetector.split_foreign_view(entry_states[lo])]
            suppress_from = list(kill_from)
            if hi is not None:
                suppress_from.append(
                    SegmentDetector.split_foreign_view(entry_states[hi]))
            carry_io[f"seg{i}"], packed, seg_killed[i] = (
                self.segments[i].reconcile_split(
                    entry_states[i], seg_packed[i], kill_from,
                    suppress_from))
            # back into its place in the flat buffer kernel C reads
            if packed is not seg_packed[i]:
                seg_packed[i].copy_(packed)
        return seg_killed

    def _extract_slots_all(self, spec_ext, seg_states, plans):
        """Detection-slot extraction for every segment, given the scan's
        slot tables and plans (each a dict with ``slot_ids`` and, for a
        two-tier segment, ``slot_ids_narrow``): the pipeline's third
        stage, the only extraction that depends on detection state (JAX:
        models/channelizer.py:628-645)."""
        return [sd.extract_planned(spec_ext, st, plan)
                for sd, st, plan in zip(self.segments, seg_states, plans)]

    def _assemble_detections(self, out, scans, extracts, pa_ext,
                             seg_powers):
        """Join the three stages' pieces into the step's detection
        outputs: the burst flags with the burst extractions, and each
        segment's scan outputs with its slot extractions and powers."""
        if self.power_bank:
            rise, fall, processed, phase_used = scans["powact"]
            out["powact"] = {
                "rise": rise,
                "fall": fall,
                "processed": processed,
                "phase_used": phase_used,
                "extract": pa_ext,
            }
        for i, ((_, so), eo, power) in enumerate(
            zip(scans["segs"], extracts, seg_powers)
        ):
            so = dict(so)
            so.update(eo)
            so["power"] = power
            out[f"seg{i}"] = so

    # -- host streaming API ------------------------------------------------------

    @property
    def batch_samples(self) -> int:
        return self.config.batch_blocks * self.config.inplen

    def _new_result(self) -> ProcessResult:
        return ProcessResult(
            throughput=[
                np.zeros(0, np.complex64)
                for _ in range(
                    self.throughput.num_channels if self.throughput else 0
                )
            ],
            segment_power=[
                np.zeros((0, sd.geometry.n_cells), np.float32)
                for sd in self.segments
            ],
        )

    def reset(self):
        self._carry = None
        # the graphs and their pool's memory go with the stream
        self._jit_step.release()
        self._jit_step_spectra.release()
        self._t0 = 0
        self._pending = np.zeros(0, np.complex64)
        self._pending_spec = np.zeros((0, self.config.blocksize),
                                      np.complex64)
        self._spectra_mode = False
        self._samples_mode = False

    def _host_extra_state(self) -> dict:
        """Checkpoint hook: subclass-owned host state to snapshot. Base:
        nothing (JAX: models/channelizer.py:703-709)."""
        return {}

    def _restore_host_extra_state(self, extra: dict):
        """Checkpoint hook: restore what :meth:`_host_extra_state` saved
        (called after the carry and emitter state are in place)."""

    def _set_carry(self, carry):
        """Make ``carry`` (a restored checkpoint's) the stream's carry:
        written into the static carry of the compiled step that holds the
        stream, whose graph reads it, else bound as it is."""
        self._carry = install_carry(
            (self._jit_step, self._jit_step_spectra), self._carry, carry)

    def _graphed(self) -> bool:
        """Whether the step runs compiled: ``compile_step``, the class's
        or the instance's."""
        return self.compile_step

    def _run_step(self, compiled: CompiledStep, slot: torch.Tensor):
        """One batch, the staging slot of host samples or spectrum rows,
        through ``compiled`` at the stream's cursor (eagerly where the
        class opts out); returns the step's outputs. The slot's next fill
        waits for this step's copy-in."""
        step = compiled if self._graphed() else compiled.eager
        with tracing.span("fdc.step"):
            self._carry, out = step(self._carry, slot, self._t0)
            if step is compiled:
                tracing.count("h2d_staged_bytes", slot.nbytes)
            self._staging.read()
        return out

    def _stage(self, pend: np.ndarray, x: np.ndarray, pos: int, rows: int):
        """The staging slot written with the stream's next ``rows`` rows
        (samples or spectrum rows): the buffered ``pend`` first, then ``x``
        from row ``pos``. Returns (slot, what is left of ``pend``, the
        next row of ``x``)."""
        k = min(len(pend), rows)
        slot = self._staging.fill((rows,) + x.shape[1:], pend[:k],
                                  x[pos:pos + rows - k])
        return slot, pend[k:], pos + rows - k

    def _run_batches(self, compiled: CompiledStep, pend: np.ndarray,
                     x: np.ndarray, rows: int):
        """Every whole batch of ``rows`` rows of the stream ``pend`` then
        ``x`` through ``compiled``, each written into the staging slot;
        returns (the result, the remainder in memory of its own)."""
        bb = self.config.batch_blocks
        with tracing.span("fdc.result"):
            result = self._new_result()
        dbg = []
        pos = 0
        for _ in range((len(pend) + len(x)) // rows):
            with tracing.span("fdc.stage"):
                slot, pend, pos = self._stage(pend, x, pos, rows)
            out = self._run_step(compiled, slot)
            self._consume_outputs(out, result, dbg)
            self._t0 += bb
            result.blocks_processed += bb
        with tracing.span("fdc.stage"):  # in memory of its own
            rest = np.concatenate([pend, x[pos:]]).astype(np.complex64,
                                                          copy=False)
        if dbg:
            with tracing.span("fdc.result"):
                result.debug_spectrum = np.concatenate(dbg)
        return result, rest

    def process(self, samples: np.ndarray) -> ProcessResult:
        """Buffered streaming entry point: any-length complex64 sample
        arrays; whole batches are processed, the remainder is buffered
        (copied: the caller may reuse ``samples`` once this returns)."""
        with tracing.call("fdc.process"):
            return self._process(samples)

    def _process(self, samples: np.ndarray) -> ProcessResult:
        if self._spectra_mode:
            raise RuntimeError(
                "process() called on a stream already driven by "
                "process_spectra(); use one entry point per stream "
                "(reset() starts a new one)"
            )
        x = np.asarray(samples)
        if x.ndim != 1:
            raise ValueError(f"samples must be one-dimensional, got shape "
                             f"{x.shape}")
        self._samples_mode = True
        if self._carry is None:
            self._carry = self._jit_init()
        result, self._pending = self._run_batches(
            self._jit_step, self._pending, x, self.batch_samples)
        return result

    def flush(self, finalize: bool = True) -> ProcessResult:
        """End-of-stream: zero-pad the buffered remainder to one batch, run
        it, trim the stream outputs to the blocks holding real samples,
        and (``finalize``) feed whole batches of silence until every burst
        channel and detection slot has deactivated — the emitted event set
        then does not depend on the capture length mod batch_blocks."""
        cfg = self.config
        n_pend = len(self._pending)
        n_pend_spec = len(self._pending_spec)
        if n_pend == 0 and n_pend_spec == 0:
            res = self._new_result()
            if cfg.debug:
                res.debug_spectrum = np.zeros((0, cfg.blocksize),
                                              np.complex64)
        else:
            if n_pend_spec:
                # spectra mode: pad the buffered rows with silent rows
                n_real = n_pend_spec
                res = self.process_spectra(np.zeros(
                    (cfg.batch_blocks - n_pend_spec, cfg.blocksize),
                    np.complex64))
            else:
                n_real = -(-n_pend // cfg.inplen)  # blocks w/ real samples
                res = self.process(
                    np.zeros(self.batch_samples - n_pend, np.complex64)
                )
            if self.throughput:
                for bucket in self.throughput.buckets:
                    for chan in bucket.channel_ids:
                        res.throughput[chan] = res.throughput[chan][
                            : n_real * bucket.out_len
                        ]
            if res.debug_spectrum is not None:
                res.debug_spectrum = res.debug_spectrum[:n_real]
            res.segment_power = [p[:n_real] for p in res.segment_power]
            res.blocks_processed = n_real
        if finalize:
            for _ in range(self._finalize_rounds()):
                if not self._open_bursts():
                    break
                res.events.extend(self._feed_silence().events)
        return res

    def _feed_silence(self) -> ProcessResult:
        """One whole batch of end-of-stream silence, in the flavor of the
        stream's entry point (zero samples, or zero spectrum rows)."""
        cfg = self.config
        if self._spectra_mode:
            return self.process_spectra(
                np.zeros((cfg.batch_blocks, cfg.blocksize), np.complex64))
        return self.process(np.zeros(self.batch_samples, np.complex64))

    def _finalize_rounds(self) -> int:
        if not (self.power_bank or len(self.segments)):
            return 0
        return finalize_rounds_bound(self.segments, self.config.batch_blocks)

    def _open_bursts(self) -> bool:
        """Any burst channel or detection slot still active on device."""
        if self._carry is None:
            return False
        c = self._carry
        if self.power_bank and bool(c["powact"]["active"].any()):
            return True
        return any(
            bool(c[f"seg{i}"]["active"].any())
            for i in range(len(self.segments))
        )

    def process_spectra(self, spectra: np.ndarray) -> ProcessResult:
        """Pre-FFT'd streaming entry point (the reference's vector-input
        mode, reference: python/FrequencyDomainChannelizer.py:201-216):
        [B, blocksize] normalized fftshifted complex spectra, any B; whole
        batches are processed, the row remainder is buffered. The framing
        front end is bypassed, so a stream uses this or :meth:`process`,
        not both; :meth:`flush` pads a buffered remainder with silent
        rows."""
        with tracing.call("fdc.process_spectra"):
            return self._process_spectra(spectra)

    def _process_spectra(self, spectra: np.ndarray) -> ProcessResult:
        cfg = self.config
        if self._samples_mode:
            raise RuntimeError(
                "process_spectra() called on a stream already driven by "
                "process(); use one entry point per stream (reset() "
                "starts a new one)"
            )
        spectra = np.asarray(spectra)
        if spectra.ndim != 2 or spectra.shape[1] != cfg.blocksize:
            raise ValueError(f"spectra must be [B, {cfg.blocksize}], "
                             f"got {spectra.shape}")
        if self._carry is None:
            self._carry = self._jit_init()
        self._spectra_mode = True
        result, self._pending_spec = self._run_batches(
            self._jit_step_spectra, self._pending_spec, spectra,
            cfg.batch_blocks)
        return result

    def _consume_outputs(self, out, result: ProcessResult, dbg: list,
                         t0: int = None):
        # t0 defaults to the streaming cursor; the pipeline passes each
        # batch's own t0, since it consumes outputs deferred. Every output
        # is copied to the host here: the compiled step's next call
        # overwrites them
        with tracing.span("fdc.consume"):
            self._consume(out, result, dbg,
                          self._t0 if t0 is None else t0)

    def _consume(self, out, result: ProcessResult, dbg: list, t0: int):
        # the whole tree into the reused host mirror: what is kept past
        # this batch is copied out of it (the concatenations below, the
        # emitters' own copies; the burst extract and the debug rows here)
        out = _to_host(out, self._mirror)
        if self.throughput:
            for bucket, mat in zip(self.throughput.buckets,
                                   out["throughput_buckets"]):
                m = _pairs_to_complex(mat)  # [C, B*out_len]
                with tracing.span("fdc.assemble"):
                    for row, chan in enumerate(bucket.channel_ids):
                        result.throughput[chan] = np.concatenate(
                            [result.throughput[chan], m[row]]
                        )
        if self.power_bank:
            po = out["powact"]
            # the Python emitter keeps a history row as a view
            po["extract"] = {
                w: _pairs_to_complex(v).copy()
                for w, v in po["extract"].items()
            }
            with tracing.span("fdc.emit", "powact"):
                result.events.extend(self.power_emitter.process_step(po, t0))
        for i in range(len(self.segments)):
            so = out[f"seg{i}"]
            result.events.extend(
                emit_segment(self.segment_emitters[i], so, t0, i))
            with tracing.span("fdc.assemble"):
                result.segment_power[i] = np.concatenate(
                    [result.segment_power[i], so["power"]]
                )
        if self.config.debug and "debug_spectrum" in out:
            dbg.append(_pairs_to_complex(out["debug_spectrum"]).copy())
