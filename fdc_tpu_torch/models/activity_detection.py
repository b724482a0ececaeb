"""Multi-segment activity-detection channelizer (the vcm block), on PyTorch.

Port of ``fdc_tpu.models.activity_detection`` (reference:
lib/activity_detection_channelizer_vcm_impl.cc): several detection
segments sharing one stream of pre-FFT'd spectra, one threshold, one
decimation rule and one window table. Each segment is a
:class:`SegmentDetector` with the vcm conventions: the 1/decimation power
normalization (:630-650), FLT_MIN zero-denominator edge ratios (:701-705,
0/0 is a falling edge), the vcm segment geometry
(``config.solve_segment_vcm``), and on the host the blockcount-from-1
convention and inline maxblocks partial emission (the copied
emitters, native or Python). All segments' lifecycle scans run in one
kernel C launch (``scan_slots_multi``); their candidates go through
kernel B.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from fdc_tpu_torch.config import VerboseMode, solve_segment_vcm
from fdc_tpu_torch.models.channelizer import (
    _pairs_to_complex,
    _to_host,
    emitter_classes,
    resolve_device,
)
from fdc_tpu_torch.models.segment_detection import (
    SegmentDetector,
    scan_slots_multi,
)
from fdc_tpu_torch.ops import detect
from fdc_tpu_torch.utils.logging import make_logger

__all__ = ["ActivityDetectionChannelizer", "ActivityDetectionRunner"]


class ActivityDetectionChannelizer(nn.Module):
    """Bank of detection segments with shared configuration on one torch
    device, with the reference constructor's parameters (reference:
    include/FDC/activity_detection_channelizer_vcm.h make(...)): blocklen,
    segments [[start, stop]] in FDC [0, 1) coordinates, thresh (dB),
    relinvovl, minchandist, channel_deactivation_delay,
    window_flank_puffer. ``device`` defaults to ``"cuda"``, the kernels
    (the constructor raises without a CUDA device); ``"cpu"`` runs their
    plain versions."""

    def __init__(
        self,
        blocklen: int,
        segments,
        thresh_db: float,
        relinvovl: int,
        minchandist: float,
        channel_deactivation_delay: int = 1,
        window_flank_puffer: float = 0.2,
        max_slots: int = 32,
        max_candidates: int = 0,
        max_extract_width: int = 0,
        verbose=0,
        extract_budget: int = 0,
        extract_width_split: int = 0,
        extract_budget_narrow: int = 0,
        *,
        device="cuda",
    ):
        super().__init__()
        if blocklen < 2 or blocklen & (blocklen - 1):
            raise ValueError("Blocklen invalid (must be a power of 2 >= 2)")
        self.blocklen = blocklen
        self.device = resolve_device(device)
        # one shared lifecycle log for all segments (reference:
        # lib/activity_detection_channelizer_vcm_impl.cc:88-100)
        self.log = (
            make_logger(verbose, "gr-FDC.ActDetChan.log")
            if VerboseMode(verbose) != VerboseMode.NOLOG else None
        )
        self.segments = nn.ModuleList()
        for i, (a, b) in enumerate(segments):
            geo = solve_segment_vcm(blocklen, float(a), float(b), minchandist)
            self.segments.append(SegmentDetector(
                i, blocklen, relinvovl, float(a), float(b), thresh_db,
                minchandist, window_flank_puffer, channel_deactivation_delay,
                max_slots, max_candidates, max_extract_width,
                extract_budget=extract_budget, geometry=geo, vcm=True,
                extract_width_split=extract_width_split,
                extract_budget_narrow=extract_budget_narrow,
            ))
            if self.log is not None:
                # per-segment banner (reference:
                # lib/activity_detection_channelizer_vcm_impl.cc:177-185)
                self.log(
                    f"# Segment {i}: \n"
                    f"# start: {geo.start} => "
                    f"f_start={geo.start / blocklen:g}\n"
                    f"# stop: {geo.stop} => f_stop={geo.stop / blocklen:g}\n"
                    f"# width: {geo.width} => "
                    f"f_bw={geo.width / blocklen:g}\n"
                    f"# chan_decimation_fact: {geo.decimation}\n"
                )
        self.to(self.device)

    def init_state(self):
        return [sd.init_state(self.device) for sd in self.segments]

    def step(self, spec_ext: torch.Tensor, states):
        """All segments over one [B+1, N] spectrum batch (row 0 = the
        previous batch's last block). Returns (new_states, outputs) as
        lists, one entry per segment, with the outputs of
        ``SegmentDetector.step`` in the JAX package."""
        sf = torch.view_as_real(spec_ext[1:])
        sq = sf[..., 0] * sf[..., 0] + sf[..., 1] * sf[..., 1]
        powers = [sd.measure(sq) for sd in self.segments]
        packs = detect.candidate_packs(
            powers, [sd.pack_spec for sd in self.segments])
        scans = scan_slots_multi(self.segments, states, packs)
        new_states, outs = [], []
        for sd, (st, flags), p in zip(self.segments, scans, powers):
            so = sd.plan_outputs(st, flags)
            so.update(sd.extract_planned(spec_ext, st, so))
            so["power"] = p
            new_states.append(st)
            outs.append(so)
        return new_states, outs

    def make_runner(self, maxblocks: int = 256, file_sink=None,
                    msg_output: bool = True, native_emission="auto"):
        return ActivityDetectionRunner(self, maxblocks, file_sink,
                                       msg_output, native_emission)


class ActivityDetectionRunner:
    """The host side of :class:`ActivityDetectionChannelizer`: batches of
    pre-FFT'd (normalized, fftshifted) spectra in, ChannelEvents out — the
    reference block's vector input and msgout port (reference:
    lib/activity_detection_channelizer_vcm_impl.cc:542-576). The carry is
    ``{"prev_spec": [N] complex64, "segs": [slot tables]}``, the JAX
    runner's (``fdc_tpu_torch.convert`` moves it between the two)."""

    def __init__(self, adc: ActivityDetectionChannelizer, maxblocks: int,
                 file_sink, msg_output: bool, native_emission="auto"):
        # the native (C++) emitters or the Python ones, as the channelizer
        # picks them ("auto": native when g++ builds the engine)
        _, emitter_cls = emitter_classes(native_emission)
        self.adc = adc
        self.emitters = [
            emitter_cls(sd, maxblocks, file_sink, msg_output, log=adc.log)
            for sd in adc.segments
        ]
        self._carry = None
        self._t0 = 0

    def _device_init(self):
        return {
            "prev_spec": torch.zeros(self.adc.blocklen, dtype=torch.complex64,
                                     device=self.adc.device),
            "segs": self.adc.init_state(),
        }

    def _device_step(self, carry, spec: torch.Tensor):
        spec_ext = torch.cat([carry["prev_spec"][None], spec])
        new_states, outs = self.adc.step(spec_ext, carry["segs"])
        return {"prev_spec": spec[-1].clone(), "segs": new_states}, outs

    def has_open_slots(self) -> bool:
        """Any detection slot still active on the device (an open burst
        the end-of-stream finalize pass should close)."""
        if self._carry is None:
            return False
        return any(bool(st["active"].any()) for st in self._carry["segs"])

    def process_spectra(self, spectra: np.ndarray):
        """[B, blocklen] complex spectra (any B, one step) -> the events
        in emission order."""
        if self._carry is None:
            self._carry = self._device_init()
        spectra = np.ascontiguousarray(spectra, np.complex64)
        nb = spectra.shape[0]
        self._carry, outs = self._device_step(
            self._carry, torch.from_numpy(spectra).to(self.adc.device))
        events = []
        for em, so in zip(self.emitters, outs):
            so = _to_host(so)
            so["extract"] = _pairs_to_complex(so["extract"])
            if "extract_narrow" in so:
                so["extract_narrow"] = _pairs_to_complex(so["extract_narrow"])
            events.extend(em.process_step(so, so["slot_meta"], self._t0))
        self._t0 += nb
        return events
