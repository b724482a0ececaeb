"""Plain reference of the channelizer's semantics, in numpy and float64.

It follows the upstream gr-FDC blocks (https://github.com/gereonsuch/gr-FDC)
block by block, as the repository's scalar golden model writes them
(``tests/golden.py``): overlap-save framing, the fftshifted forward FFT
scaled by 1/N, static channels (slice x window x phase, IFFT, overlap
trim), the burst channels' power hysteresis, and segment detection with
its channel lifecycle and partial emission. The transforms of a batch
run as a few vectorised numpy calls; the lifecycles, which are
sequential by nature, walk the blocks in Python.

It imports nothing of the program under test: a configuration reaches it
as the plain dict of keyword arguments that the benchmark's
configuration file holds, and it derives every geometry, window and
threshold from that dict itself.

The program's own limits (slot table, bounded candidates, extraction
budgets and widths) are not semantics but capacities: traffic within
them gives the same events as the upstream blocks. The reference counts
what each batch asks of them and raises :class:`CapacityError` when
traffic goes past one, since the program's result is then a different
one by design (lost samples, dropped channels).

``rnd`` rounds every operand of a product before it is used (samples
before the forward FFT, spectra and windows before extraction and power
measurement). The identity gives the reference; :func:`tf32` gives the
control, the same computation with TF32's 10-bit mantissa.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

FLT_MAX = float(np.float32(3.4028235e38))
FLT_MIN = float(np.float32(1.1754944e-38))


class CapacityError(RuntimeError):
    """Traffic asked more of a batch than the configuration holds."""


def nextpow2(k) -> int:
    return 1 << int(np.ceil(np.log2(k)))


def tf32(x):
    """``x`` with each float32 component rounded to TF32 (10 mantissa bits,
    round to nearest even), returned in float64 / complex128."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return tf32(x.real) + 1j * tf32(x.imag)
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    lsb = (b >> 13) & 1
    b = (b + 0x0FFF + lsb) & np.uint32(0xFFFFE000)
    return b.view(np.float32).astype(np.float64)


def identity(x):
    return x


def ifft_shifted(z):
    """The IFFT of the fftshifted rows of ``z`` (even length): the IFFT of
    ``z`` times (-1)^m."""
    w = z.shape[-1]
    return np.fft.ifft(z, axis=-1) * (1 - 2 * (np.arange(w) & 1))


# -- geometry (upstream: python/FrequencyDomainChannelizer.py:322-345,
# lib/PowerActivationChannel_impl.cc:314-375, lib/SegmentDetection_impl.cc:
# 551-637, lib/windows.h:41-124) --------------------------------------------


def _fdc_freq(f):
    """Normalized baseband frequency -> [0, 1) FFT-bin coordinates, DC at
    0.5 (the configurations use freqmode "normalized")."""
    return (f + 0.5) % 1.0


def base_window(wintype, length, passbw, stopbw):
    if passbw >= 1.0:
        passbw, stopbw, wintype = 1.0, 1.0, 0
    elif stopbw >= 1.0:
        stopbw = 1.0
    low = int((1.0 - stopbw) * length) // 2
    high = int(passbw * length)
    ramp = (length - 2 * low - high) // 2
    v = 1.0 / length
    w = np.full(length, v)
    if wintype in (1, 2):
        w[:low] = 0.0
        if low:
            w[-low:] = 0.0
        i = np.arange(ramp)
        if wintype == 1:
            r = v * (0.5 - np.cos((i + 1) / (ramp + 1) * np.pi) / 2)
        else:
            r = v * (i + 1) / (ramp + 1)
        w[low + i] = r
        w[length - low - 1 - i] = r
    else:
        edge = low + ramp // 2
        w[:edge] = 0.0
        w[length - edge:] = 0.0
    return w


WINDOW_TYPES = {"RECTANGULAR": 0, "rect": 0, "rectangular": 0,
                "HANN": 1, "hann": 1, "RAMP": 2, "ramp": 2}


@dataclass
class Static:
    start: int
    width: int
    out_len: int
    window: np.ndarray  # [width], 1/width scaled
    shift: int  # phase step a block, start % R


def static_channel(n, r, freq, bw, wintype):
    passsamps = n * bw
    width = nextpow2(passsamps)
    if width < 1.2 * passsamps:
        width *= 2
    passband = passsamps / width * 1.1
    stopband = 1.0
    if passband >= 1.0:
        passband = 1.0
    elif passband < 0.7:
        stopband = passband + 0.25
    start = int(round(freq * n)) % n
    start -= width // 2
    if start < 0:
        start = (start + n) % n
    if start + width > n:
        start = n - width
    return Static(start, width, width - width // r,
                  base_window(wintype, width, passband, stopband),
                  start % r)


@dataclass
class Burst:
    es: int
    ee: int
    ew: int
    ms: int
    me: int
    windows: np.ndarray  # [R, ew] sine-flank windows with phase i/R


def burst_channel(n, r, cfreq, bw):
    bw = abs(bw)
    ew = min(nextpow2(int(np.ceil(bw * n))), n)
    mid = int(round(cfreq * n))
    es = max(mid - ew // 2, 0)
    ee = es + ew
    if ee > n:
        ee = n
        es = ee - ew
    ms = max(int(round((cfreq - bw / 2) * n)), es)
    me = min(int(round((cfreq + bw / 2) * n)), ee)
    ramp = (ew - (me - ms)) // 3
    base = np.ones(ew)
    i = np.arange(ramp)
    base[i] = np.sin(0.5 * np.pi * i / (ramp + 1))
    base[ew - 1 - i] = base[i]
    wins = base[None, :] * np.exp(2j * np.pi * np.arange(r) / r)[:, None]
    return Burst(es, ee, ew, ms, me, wins)


@dataclass
class Segment:
    start: int
    n_cells: int
    dec: int


def segment(n, a, b, minchandist):
    minchandist %= 1.0
    a, b = _fdc_freq(a), _fdc_freq(b)
    if a > b:
        a, b = b, a
    decf = n * minchandist / 2.0
    dec = 1 if decf < 2.0 else int(decf)
    width = int((b - a) * n)
    if width % dec:
        width += dec - width % dec
    if width > n:
        width = n - n % dec
    mid = int(0.5 * (a + b) * n)
    start = 0 if mid < width // 2 else mid - width // 2
    if start + width > n:
        start = n - width
    return Segment(start, width // dec, dec)


def flank_window(w, puffer):
    p = int(puffer * w)
    win = np.ones(w)
    if p:
        k = np.arange(p)
        fl = 0.5 - 0.5 * np.cos(np.pi * k / p)
        win[k] *= fl
        win[w - 1 - k] *= fl
    return win


# -- the stream -----------------------------------------------------------


@dataclass
class Chan:
    """One detection channel (the upstream's dynamic channel)."""

    det_start: int
    det_stop: int
    es: int
    ew: int
    inactive: int = -1
    count: int = 0
    phase: int = 0
    part: int = 0
    data: list = field(default_factory=list)


@dataclass
class BatchOut:
    """What one batch emitted, its outputs, and the channels it opened
    and retired."""

    events: list
    throughput: list = None  # per static channel, complex128
    seg_power: list = None  # per segment, [B, n_cells] float64
    opened: list = None  # per segment: channels activated this batch
    retired: list = None  # per segment: channels emitted final this batch


class Stream:
    """The channelizer over a stream of whole batches, from silence."""

    def __init__(self, cfg: dict, rnd=identity):
        self.rnd = rnd
        n = self.n = int(cfg["blocksize"])
        r = self.r = int(cfg["relinvovl"])
        if cfg.get("freqmode", "normalized") != "normalized":
            raise ValueError("the reference takes freqmode 'normalized'")
        if int(cfg.get("pow_act_deactivation_delay", 0)) or cfg.get(
                "segment_splits"):
            raise ValueError("the reference has no burst deactivation delay "
                             "and no split segments")
        self.b = int(cfg["batch_blocks"])
        self.ovl = n // r
        self._alt = 1.0 - 2.0 * (np.arange(n) & 1)
        self.inplen = n - self.ovl
        wt = cfg.get("windowtype", "RECTANGULAR")
        wt = WINDOW_TYPES[wt] if isinstance(wt, str) else int(wt)
        self.static = [static_channel(n, r, _fdc_freq(f), bw % 1.0, wt)
                       for f, bw in cfg.get("throughput_channels", ())]
        self.bursts = [burst_channel(n, r, _fdc_freq(f), bw % 1.0)
                       for f, bw in cfg.get("activity_controlled_channels",
                                            ())]
        self.pa_thresh = 10.0 ** (float(cfg["act_contr_threshold"]) / 10.0)
        self.pa_maxblocks = int(cfg["pow_act_maxblocks"])
        self.segments = [segment(n, a, b, float(cfg["minchandist"]))
                         for a, b in cfg.get("activity_detection_segments",
                                             ())]
        self.sd_thresh = 10.0 ** (float(cfg["act_det_threshold"]) / 10.0)
        self.puffer = float(cfg["minchanflankpuffer"])
        self.delay = int(cfg["act_det_deactivation_delay"])
        self.sd_maxblocks = int(cfg["act_det_maxblocks"])
        # capacities
        self.max_slots = int(cfg["max_slots"])
        self.k_detect = int(cfg["max_candidates"])
        self.w_cap = int(cfg["max_extract_width"]) or n
        self.budget = min(int(cfg["extract_budget"]) or self.max_slots,
                          self.max_slots)
        self.w_split = int(cfg.get("extract_width_split", 0))
        self.budget_narrow = int(cfg.get("extract_budget_narrow", 0))
        self._flank = {}
        # state
        self.t0 = 0  # global index of the next block
        self.hist = np.zeros(self.ovl, np.complex128)
        self.prev_spec = np.zeros(n, np.complex128)
        self.pa = [dict(active=False, lastpower=FLT_MAX, phase=0, part=0,
                        count=0, blocks=[])
                   for _ in self.bursts]
        self.chans = [[] for _ in self.segments]

    # -- one batch --------------------------------------------------------

    def spectra(self, x):
        """[B, N] fftshifted spectra of a batch of samples, 1/N scaled;
        advances the framing history."""
        x = self.rnd(np.asarray(x, np.complex64).astype(np.complex128))
        full = np.concatenate([self.hist, x])
        blocks = np.lib.stride_tricks.sliding_window_view(
            full, self.n)[::self.inplen]
        self.hist = full[-self.ovl:]
        # (-1)^t before the FFT shifts its output by N/2: fftshift
        spec = np.fft.fft(blocks * self._alt, axis=-1)
        spec *= 1.0 / self.n
        return self.rnd(spec)

    def step(self, x, want_outputs=False) -> BatchOut:
        """One batch of samples ``x`` ([B * inplen] complex); returns the
        events emitted in it and, with ``want_outputs``, the static
        channels' streams and the segments' cell powers."""
        spec = self.spectra(x)
        ext = np.concatenate([self.prev_spec[None], spec])  # row 0: hist
        self.prev_spec = spec[-1]
        out = BatchOut(events=[])
        if want_outputs:
            out.throughput = [self._static(spec, c) for c in self.static]
        sq = np.abs(spec) ** 2
        powers = [sq[:, g.start:g.start + g.n_cells * g.dec]
                  .reshape(self.b, g.n_cells, g.dec).sum(-1)
                  for g in self.segments]
        if want_outputs:
            out.seg_power = powers
        pa_pwr = [sq[:, c.ms:c.me].sum(-1) for c in self.bursts]
        for k, c in enumerate(self.bursts):
            self._bursts(k, c, ext, pa_pwr[k], out.events)
        out.opened, out.retired = [], []
        for i, g in enumerate(self.segments):
            opened, retired = self._segment(i, g, ext, powers[i], out.events)
            out.opened.append(opened)
            out.retired.append(retired)
        self.t0 += self.b
        return out

    def _static(self, spec, c: Static):
        """One static channel's stream of the batch (upstream:
        python/FrequencyDomainChannelizer.py:218-231)."""
        blocks = self.t0 + np.arange(self.b)
        phase = np.exp(2j * np.pi * ((blocks * c.shift) % self.r) / self.r)
        z = spec[:, c.start:c.start + c.width] * self.rnd(
            c.window[None, :] * phase[:, None])
        y = ifft_shifted(z) * c.width
        return (y[:, c.width - c.out_len:] * c.width).reshape(-1)

    # -- burst channels (upstream: lib/PowerActivationChannel_impl.cc) ------

    def _bursts(self, k, c: Burst, ext, pwr, events):
        st = self.pa[k]
        th = self.pa_thresh
        mb = self.pa_maxblocks

        def proc(row):
            x = ext[row, c.es:c.ee] * self.rnd(c.windows[st["phase"]])
            y = ifft_shifted(x) * c.ew
            st["blocks"].append(y[c.ew // self.r:])
            st["count"] += 1
            st["phase"] = (st["phase"] + c.es % self.r) % self.r

        def emit(fin, blockcount):
            data = (np.concatenate(st["blocks"]) if st["blocks"]
                    else np.zeros(0, np.complex128))
            st["blocks"] = []
            events.append(dict(
                source="PowActChan", unit=k, finalized=fin,
                part=st["part"], rel_cfreq=(c.es + c.ee) / 2.0 / self.n,
                rel_bw=c.ew / self.n, blockstart=blockcount - st["count"],
                blockend=blockcount, vectorstart=None, vectorend=None,
                data=data))
            st["part"] += 1

        for b in range(self.b):
            p = float(pwr[b]) or FLT_MIN
            active = st["active"]
            changed = ((not active and p / st["lastpower"] >= th)
                       or (active and st["lastpower"] / p >= th))
            blockcount = self.t0 + b + 1
            if changed and not active:
                st.update(part=0, count=0, active=True, phase=0, blocks=[])
                proc(b)
                proc(b + 1)
            elif changed:
                proc(b + 1)
                st["active"] = False
                emit(True, blockcount)
            elif active:
                proc(b + 1)
                if mb == 0 or (mb > 0 and st["count"] % mb == 0):
                    emit(False, blockcount)
            st["lastpower"] = p

    # -- detection segments (upstream: lib/SegmentDetection_impl.cc) -------

    def _window(self, w):
        if w not in self._flank:
            self._flank[w] = flank_window(w, self.puffer)
        return self._flank[w]

    def _candidates(self, g: Segment, power):
        """Accepted (start bin, stop bin) intervals of every block, in the
        upstream's acceptance order (strongest rising edge first)."""
        th = self.sd_thresh
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = power[:, 1:] / power[:, :-1]  # 0/0 (silence): no edge
        rises = ratio > th
        falls = ratio < 1.0 / th
        n_rise = rises.sum(1)
        if self.k_detect and n_rise.max(initial=0) > self.k_detect:
            raise CapacityError(
                f"{int(n_rise.max())} rising edges in a block, over "
                f"max_candidates {self.k_detect}")
        out = [[] for _ in range(self.b)]
        rb, rc = np.nonzero(rises)
        fb, fc = np.nonzero(falls)
        rcut = np.searchsorted(rb, np.arange(self.b + 1))
        fcut = np.searchsorted(fb, np.arange(self.b + 1))
        for b in np.unique(rb):
            ri = rc[rcut[b]:rcut[b + 1]]
            fi = fc[fcut[b]:fcut[b + 1]]
            order = ri[np.argsort(-ratio[b, ri], kind="stable")]
            poss = []
            for i in order:
                s = int(i) * g.dec + g.start
                j = np.searchsorted(fi, i + 1)  # first fall cell > i ...
                # ... whose bin (cell + 1) * dec + start exceeds s
                if j >= len(fi):
                    continue
                e = (int(fi[j]) + 1) * g.dec + g.start
                if any(s < pe and e >= ps for ps, pe in poss):
                    continue
                poss.append((s, e))
            out[b] = poss
        return out

    def _segment(self, seg, g: Segment, ext, power, events):
        chans = self.chans[seg]
        n, r, delay, mb = self.n, self.r, self.delay, self.sd_maxblocks
        live_at_start = len(chans)
        opened = retired = 0
        needy = {}  # id(chan) -> chan, every channel processed this batch

        def proc(row, c):
            ph = np.exp(2j * np.pi * c.phase / r)
            x = ext[row, c.es:c.es + c.ew] * self.rnd(self._window(c.ew) * ph)
            y = ifft_shifted(x) * c.ew
            c.data.append(y[c.ew // r:])
            c.count += 1
            c.phase = (c.phase + c.es % r) % r
            needy[id(c)] = c

        def emit(c, fin, ntx, blockcount):
            chunk, c.data = c.data[:ntx], c.data[ntx:]
            data = (np.concatenate(chunk) if chunk
                    else np.zeros(0, np.complex128))
            events.append(dict(
                source="DETECTED", unit=seg, finalized=fin,
                part=c.part if (not fin or c.part > 0) else None,
                rel_cfreq=(2 * c.es + c.ew) / 2.0 / n, rel_bw=c.ew / n,
                blockstart=blockcount - c.count, blockend=blockcount,
                vectorstart=c.es, vectorend=c.es + c.ew, data=data))
            if not fin:
                c.part += 1

        cands = self._candidates(g, power)
        for b in range(self.b):
            blockcount = self.t0 + b
            poss = cands[b]
            if not poss:
                for c in chans:
                    c.inactive += 1
            else:
                poss = list(poss)
                for c in chans:
                    hit = [p for p in poss
                           if p[0] < c.det_stop and p[1] >= c.det_start]
                    poss = [p for p in poss
                            if not (p[0] < c.det_stop and p[1] >= c.det_start)]
                    c.inactive = 0 if hit else c.inactive + 1
                for ds, de in poss:
                    detw = de - ds
                    ew = nextpow2(int(np.ceil(detw * (1.0 + 2.0 * self.puffer))))
                    if ew > n:
                        continue
                    mid = ds + detw // 2
                    es = mid - ew // 2
                    if es < 0:
                        es = 0
                    if es + ew > n:
                        es = n - ew
                    if ew > self.w_cap:
                        raise CapacityError(
                            f"a detection {ew} bins wide, over "
                            f"max_extract_width {self.w_cap}")
                    chans.append(Chan(ds, de, es, ew))
                    opened += 1
            for c in chans:
                if c.inactive < 0:
                    proc(b, c)
                    proc(b + 1, c)
                    c.inactive = 0
                elif c.inactive > delay:
                    emit(c, True, len(c.data), blockcount)
                    retired += 1
                else:
                    proc(b + 1, c)
            if mb >= 0:
                for c in chans:
                    if c.inactive <= delay and len(c.data) >= mb:
                        ntx = len(c.data) if mb == 0 else mb
                        if ntx > 0:
                            emit(c, False, ntx, blockcount)
            chans[:] = [c for c in chans if c.inactive <= delay]
        self._check_capacity(seg, live_at_start + opened, needy.values())
        return opened, retired

    def _check_capacity(self, seg, slots_used, needy):
        """The slot table (slots free again only at the step's end) and the
        extraction rows a batch ships (``extract_budget`` rows of
        ``max_extract_width``, and with ``extract_width_split`` a first
        bucket of ``extract_budget_narrow`` narrow rows)."""
        if slots_used > self.max_slots:
            raise CapacityError(
                f"segment {seg}: {slots_used} slots in a batch, over "
                f"max_slots {self.max_slots}")
        needy = list(needy)
        fit = sum(c.ew <= self.w_split for c in needy) if self.w_split else 0
        in_narrow = min(fit, self.budget_narrow) if self.w_split else 0
        if len(needy) - in_narrow > self.budget:
            raise CapacityError(
                f"segment {seg}: {len(needy)} channels need rows in a "
                f"batch, over the extraction budget")


def run(cfg: dict, batch_of, n_batches: int, outputs_for=(), rnd=identity):
    """The reference over ``n_batches`` batches from silence:
    ``batch_of(j)`` gives batch j's samples. Returns the list of
    :class:`BatchOut` (with streams and cell powers for the batches in
    ``outputs_for``)."""
    st = Stream(cfg, rnd)
    return [st.step(batch_of(j), want_outputs=j in outputs_for)
            for j in range(n_batches)]
