# Copied from fdc_tpu/utils/waterfall.py; only the import lines differ.
"""Waterfall rendering with detection-message overlays.

Headless rebuild of WaterfallMsgTagging (reference:
python/WaterfallMsgTagging.py): consumes per-block power spectra and
ChannelEvents, renders a scrolling waterfall image with rectangles framing
each emitted channel burst. The reference is a PyQt4 widget updated from a
QTimer; here the renderer is a pure host-side accumulator that yields RGB
arrays (and optional PNG files via matplotlib if available) — the
observability parity without a Qt dependency.

Pipeline per the reference:
- each power-spectrum block is rescaled to a fixed pixel width by
  mean-reduction (blocklen > width) or Kronecker interpolation
  (reference: python/WaterfallMsgTagging.py:247-256),
- rows are time-decimated by ``blockdecimation`` via mean
  (reference: python/WaterfallMsgTagging.py:153-170),
- power is mapped to color through a dB-binned colorscheme
  (reference: python/WaterfallMsgTagging.py:276-312),
- events are mapped from (blockstart, blockend, rel_cfreq, rel_bw) metadata
  to pixel rectangles (reference: python/WaterfallMsgTagging.py:85-110).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from fdc_tpu_torch.utils.events import ChannelEvent

__all__ = [
    "Waterfall",
    "LiveWaterfall",
    "DecimatingPowerHistory",
    "COLOR_SCHEMES",
    "cr_colorscheme",
]

# the reference's four schemes by index (python/WaterfallMsgTagging.py:277-281)
COLOR_SCHEMES = (
    "black-blue-cyan-white",   # 0
    "black-rainbow",           # 1
    "black-red-yellow",        # 2
    "black-white",             # 3
)


def cr_colorscheme(colorscheme, minvaldb: float, maxvaldb: float,
                   loginput: bool):
    """Exact rebuild of the reference's colorscheme constructor
    (reference: python/WaterfallMsgTagging.py:276-312): N=1024 colors,
    N-1 dB bin edges from minvaldb to maxvaldb (converted to linear when
    the input is linear power), plus the scheme's frame color.

    Accepts the reference's integer index or a COLOR_SCHEMES name.
    Returns (cols [N,3] uint8, bins [N-1] float, frame [3] uint8).
    """
    if isinstance(colorscheme, str):
        if colorscheme not in COLOR_SCHEMES:
            raise ValueError(f"unknown colorscheme {colorscheme!r}")
        colorscheme = COLOR_SCHEMES.index(colorscheme)
    colorscheme = int(colorscheme)

    n = 1024
    bins = np.linspace(minvaldb, maxvaldb, n - 1)
    if not loginput:
        bins = 10.0 ** (bins / 10.0)

    def lsp(a, b, num):
        return np.linspace(a, b, num, dtype=np.uint8)

    if colorscheme == 1:  # Black-Rainbow
        np4 = n // 4
        cols = np.array([
            np.concatenate((lsp(0, 75, np4), lsp(75, 0, np4),
                            [0] * np4, lsp(0, 255, np4))),
            np.concatenate(([0] * np4, [0] * np4,
                            lsp(0, 255, np4), [255] * np4)),
            np.concatenate((lsp(0, 130, np4), lsp(130, 255, np4),
                            lsp(255, 0, np4), [0] * np4)),
        ], dtype=np.uint8).transpose().reshape(n, 3)
        frame = np.array([255, 255, 255], np.uint8)
    elif colorscheme == 2:  # Black-Red-Yellow
        np2 = n // 2
        cols = np.array([
            np.concatenate((lsp(0, 255, np2), [255] * np2)),
            np.concatenate(([0] * np2, lsp(0, 255, np2))),
            [0] * n,
        ], dtype=np.uint8).transpose().reshape(n, 3)
        frame = np.array([255, 255, 255], np.uint8)
    elif colorscheme == 3:  # Black-White
        # (the reference casts to uint8 in apply_colorscheme, :261-262)
        cols = np.kron(
            np.linspace(0, 255, n, dtype=np.uint8), [1, 1, 1]
        ).reshape(n, 3).astype(np.uint8)
        frame = np.array([0, 255, 0], np.uint8)
    else:  # 0: Black-Blue-Cyan-White
        np2 = n // 2
        cols = np.array([
            [0] * n,
            np.concatenate(([0] * np2, lsp(0, 255, np2))),
            np.concatenate((lsp(0, 255, np2), [255] * np2)),
        ], dtype=np.uint8).transpose().reshape(n, 3)
        frame = np.array([255, 255, 255], np.uint8)

    return cols, bins, frame


# 4x6 bitmap glyphs for in-image tag labels (uppercase + digits + id
# punctuation); each glyph is 6 rows of 4 bits, MSB = left column.
_FONT = {
    "0": (0x6, 0x9, 0xB, 0xD, 0x9, 0x6), "1": (0x2, 0x6, 0x2, 0x2, 0x2, 0x7),
    "2": (0x6, 0x9, 0x1, 0x6, 0x8, 0xF), "3": (0xE, 0x1, 0x6, 0x1, 0x1, 0xE),
    "4": (0x9, 0x9, 0xF, 0x1, 0x1, 0x1), "5": (0xF, 0x8, 0xE, 0x1, 0x1, 0xE),
    "6": (0x6, 0x8, 0xE, 0x9, 0x9, 0x6), "7": (0xF, 0x1, 0x2, 0x2, 0x4, 0x4),
    "8": (0x6, 0x9, 0x6, 0x9, 0x9, 0x6), "9": (0x6, 0x9, 0x9, 0x7, 0x1, 0x6),
    "A": (0x6, 0x9, 0x9, 0xF, 0x9, 0x9), "B": (0xE, 0x9, 0xE, 0x9, 0x9, 0xE),
    "C": (0x6, 0x9, 0x8, 0x8, 0x9, 0x6), "D": (0xE, 0x9, 0x9, 0x9, 0x9, 0xE),
    "E": (0xF, 0x8, 0xE, 0x8, 0x8, 0xF), "F": (0xF, 0x8, 0xE, 0x8, 0x8, 0x8),
    "G": (0x6, 0x9, 0x8, 0xB, 0x9, 0x7), "H": (0x9, 0x9, 0xF, 0x9, 0x9, 0x9),
    "I": (0x7, 0x2, 0x2, 0x2, 0x2, 0x7), "J": (0x7, 0x2, 0x2, 0x2, 0xA, 0x4),
    "K": (0x9, 0xA, 0xC, 0xC, 0xA, 0x9), "L": (0x8, 0x8, 0x8, 0x8, 0x8, 0xF),
    "M": (0x9, 0xF, 0xF, 0x9, 0x9, 0x9), "N": (0x9, 0xD, 0xD, 0xB, 0xB, 0x9),
    "O": (0x6, 0x9, 0x9, 0x9, 0x9, 0x6), "P": (0xE, 0x9, 0x9, 0xE, 0x8, 0x8),
    "Q": (0x6, 0x9, 0x9, 0x9, 0xA, 0x5), "R": (0xE, 0x9, 0x9, 0xE, 0xA, 0x9),
    "S": (0x7, 0x8, 0x6, 0x1, 0x1, 0xE), "T": (0x7, 0x2, 0x2, 0x2, 0x2, 0x2),
    "U": (0x9, 0x9, 0x9, 0x9, 0x9, 0x6), "V": (0x9, 0x9, 0x9, 0x9, 0x6, 0x6),
    "W": (0x9, 0x9, 0x9, 0xF, 0xF, 0x9), "X": (0x9, 0x9, 0x6, 0x6, 0x9, 0x9),
    "Y": (0x5, 0x5, 0x5, 0x2, 0x2, 0x2), "Z": (0xF, 0x1, 0x2, 0x4, 0x8, 0xF),
    ".": (0x0, 0x0, 0x0, 0x0, 0x0, 0x4), "-": (0x0, 0x0, 0xF, 0x0, 0x0, 0x0),
    "_": (0x0, 0x0, 0x0, 0x0, 0x0, 0xF), " ": (0x0, 0x0, 0x0, 0x0, 0x0, 0x0),
    ":": (0x0, 0x4, 0x0, 0x0, 0x4, 0x0),
}


def _draw_text(img: np.ndarray, row: int, col: int, text: str,
               color: np.ndarray):
    """Stamp 4x6 glyphs into the RGB image (unknown chars skipped)."""
    h, w = img.shape[:2]
    for ch in text.upper():
        glyph = _FONT.get(ch)
        if glyph is None:
            col += 5
            continue
        for dy, bits in enumerate(glyph):
            y = row + dy
            if not (0 <= y < h):
                continue
            for dx in range(4):
                if bits & (0x8 >> dx):
                    x = col + dx
                    if 0 <= x < w:
                        img[y, x] = color
        col += 5
        if col >= w:
            break


@dataclass
class _Rect:
    row_start: int  # global decimated-row index
    row_end: int
    col_left: int
    col_right: int
    finalized: bool
    ID: str


class Waterfall:
    """Scrolling waterfall accumulator with event overlays.

    Args:
      blocklen: FFT size of incoming power spectra.
      width: image width in pixels (reference fixed 1024).
      height: rows kept in the scrolling image.
      blockdecimation: time decimation (mean over this many blocks per row).
      db_range: (minvaldb, maxvaldb) color binning range.
      colorscheme: reference scheme index 0-3 or a COLOR_SCHEMES name.
      loginput: True if fed values are already dB (the reference's loginput
        flag — when False the dB bin edges are converted to linear and raw
        linear power is binned directly,
        reference: python/WaterfallMsgTagging.py:289-291).
    """

    TAGMODES = ("none", "id", "part")

    def __init__(
        self,
        blocklen: int,
        width: int = 1024,
        height: int = 512,
        blockdecimation: int = 1,
        db_range=(-100.0, 0.0),
        colorscheme=0,
        tagmode: str = "none",
        loginput: bool = False,
    ):
        if blockdecimation < 1:
            raise ValueError("blockdecimation must be >= 1")
        if tagmode not in self.TAGMODES:
            raise ValueError(f"tagmode must be one of {self.TAGMODES}")
        # the reference declares this enum but never renders it
        # (grc/FDC_WaterfallMsgTagging.xml:96-116); here it both feeds
        # labels() and draws the text into the rendered image
        self.tagmode = tagmode
        self.blocklen = blocklen
        self.width = width
        self.height = height
        self.blockdecimation = blockdecimation
        self.db_lo, self.db_hi = float(db_range[0]), float(db_range[1])
        self.loginput = bool(loginput)
        # exact reference colorscheme: 1024 colors, digitize bin edges,
        # scheme frame color (python/WaterfallMsgTagging.py:276-312)
        self.colorscheme = colorscheme
        self.cmap, self.bins, self.frame = cr_colorscheme(
            colorscheme, self.db_lo, self.db_hi, self.loginput
        )

        # raw value rows (linear power, or dB when loginput); empty history
        # renders black like the reference's zero-initialized pixmap
        floor = -np.inf if self.loginput else 0.0
        self._rows = np.full((height, width), floor, np.float32)
        self._pending: List[np.ndarray] = []  # undecimated px rows
        self._nrows = 0  # total decimated rows produced (global row index)
        self._rects: List[_Rect] = []
        self._block_index = 0  # global block index of next spectrum

    # -- runtime style setters -------------------------------------------------
    # The reference GUI exposes live style callbacks
    # (reference: python/WaterfallMsgTagging.py:263-274, GRC callbacks
    # grc/FDC_WaterfallMsgTagging.xml:13-15). Rows are stored RAW (linear
    # power, or dB when loginput) and binned at render time, so rebuilding
    # the LUT restyles every accumulated row without dropping any.

    def _restyle(self):
        self.cmap, self.bins, self.frame = cr_colorscheme(
            self.colorscheme, self.db_lo, self.db_hi, self.loginput
        )

    def set_minvaldb(self, minvaldb: float):
        """Live-change the lower dB bin edge; accumulated rows are kept."""
        self.db_lo = float(minvaldb)
        self._restyle()

    def set_maxvaldb(self, maxvaldb: float):
        """Live-change the upper dB bin edge; accumulated rows are kept."""
        self.db_hi = float(maxvaldb)
        self._restyle()

    def set_colorscheme(self, colorscheme):
        """Live-change the color scheme (index 0-3 or a COLOR_SCHEMES
        name); accumulated rows are kept."""
        # validate eagerly so a bad scheme fails here, not at next render
        self.cmap, self.bins, self.frame = cr_colorscheme(
            colorscheme, self.db_lo, self.db_hi, self.loginput
        )
        self.colorscheme = colorscheme

    # -- feeding ---------------------------------------------------------------

    def _rescale(self, p: np.ndarray) -> np.ndarray:
        """blocklen -> width via mean-reduction or Kron interpolation
        (reference: python/WaterfallMsgTagging.py:247-256)."""
        n, w = self.blocklen, self.width
        if n == w:
            return p.astype(np.float32)
        if n > w:
            if n % w:
                # pad to a multiple, averaging what exists
                pad = (-n) % w
                p = np.concatenate([p, np.repeat(p[-1:], pad)])
            return p.reshape(w, -1).mean(axis=1).astype(np.float32)
        reps = int(np.ceil(w / n))
        return np.kron(p, np.ones(reps, np.float32))[:w]

    def feed_power(self, power_blocks: np.ndarray):
        """Append [B, blocklen] linear power spectra (one row per block)."""
        power_blocks = np.atleast_2d(np.asarray(power_blocks))
        if power_blocks.size == 0:
            return
        px = [self._rescale(p) for p in power_blocks]
        self._block_index += len(px)
        px = self._pending + px
        d = self.blockdecimation
        n_new = len(px) // d
        self._pending = px[n_new * d:]
        if not n_new:
            return
        # raw-domain mean over each decimation window, binned as-is at
        # render (reference: python/WaterfallMsgTagging.py:163,261-262 —
        # digitize on the raw values, no log conversion). The scroll is
        # ONE concatenate for the whole batch: a per-row np.roll of the
        # [height, width] buffer is O(rows * height) and dominates large
        # feeds.
        rows = (
            np.stack(px[: n_new * d])
            .reshape(n_new, d, self.width)
            .mean(axis=1)
            .astype(np.float32)
        )
        self._append_rows(rows)

    def feed_rows(self, rows: np.ndarray, blocks_per_row: int = None):
        """Append PRE-decimated image rows (one per ``blockdecimation``
        blocks — or ``blocks_per_row`` of them, for externally decimated
        histories such as :class:`DecimatingPowerHistory`). Rows longer
        than ``width`` are rescaled like spectra; event rectangles keep
        mapping through ``blockdecimation``, so pass histories decimated
        by the same factor."""
        rows = np.atleast_2d(np.asarray(rows))
        if rows.size == 0:
            return
        bpr = self.blockdecimation if blocks_per_row is None else blocks_per_row
        if rows.shape[1] != self.width:
            rows = np.stack([self._rescale(r) for r in rows])
        self._block_index += bpr * len(rows)
        self._append_rows(rows.astype(np.float32))

    def _append_rows(self, rows: np.ndarray):
        n_new = len(rows)
        if n_new >= self.height:
            self._rows = rows[-self.height:]
        else:
            self._rows = np.concatenate([self._rows[n_new:], rows])
        self._nrows += n_new

    def feed_events(self, events: Sequence[ChannelEvent]):
        """Register detection events as overlay rectangles
        (reference: python/WaterfallMsgTagging.py:85-110)."""
        for e in events:
            left = int(round((e.rel_cfreq - e.rel_bw / 2.0) * self.width))
            right = int(round((e.rel_cfreq + e.rel_bw / 2.0) * self.width))
            label = ""
            if self.tagmode == "id":
                label = e.ID
            elif self.tagmode == "part":
                label = (
                    f"{e.ID} fin" if e.finalized else f"{e.ID} part {e.part}"
                )
            self._rects.append(
                _Rect(
                    row_start=e.blockstart // self.blockdecimation,
                    row_end=e.blockend // self.blockdecimation,
                    col_left=np.clip(left, 0, self.width - 1),
                    col_right=np.clip(right, 0, self.width - 1),
                    finalized=e.finalized,
                    ID=label or e.ID,
                )
            )
        # drop rects scrolled fully out of view
        lo = self._nrows - self.height
        self._rects = [r for r in self._rects if r.row_end >= lo]

    def labels(self):
        """Visible (row, col, text) anchors for the current tagmode — the
        hook a GUI embedder uses to draw event labels next to the overlay
        rectangles. Empty when tagmode='none'."""
        if self.tagmode == "none":
            return []
        base = self._nrows - self.height
        out = []
        for r in self._rects:
            top = r.row_start - base
            if 0 <= top < self.height:
                out.append((int(top), int(r.col_left), r.ID))
        return out

    # -- rendering -------------------------------------------------------------

    def render(self, overlay: bool = True) -> np.ndarray:
        """[height, width, 3] uint8 image, newest row at the bottom.

        Color mapping is the reference's digitize binning
        (python/WaterfallMsgTagging.py:261-262); overlay rectangles use the
        scheme's frame color (:306-311) and, when tagmode is not 'none',
        the event label is stamped next to each rectangle's top-left
        corner."""
        idx = np.digitize(self._rows, self.bins, False)
        img = self.cmap[idx]
        if overlay:
            img = img.copy()
            frame = self.frame
            base = self._nrows - self.height  # global row of img row 0
            for r in self._rects:
                top = r.row_start - base
                bot = r.row_end - base
                if bot < 0 or top >= self.height:
                    continue
                t = int(np.clip(top, 0, self.height - 1))
                b = int(np.clip(bot, 0, self.height - 1))
                img[t, r.col_left: r.col_right + 1] = frame
                img[b, r.col_left: r.col_right + 1] = frame
                img[t: b + 1, r.col_left] = frame
                img[t: b + 1, r.col_right] = frame
                if self.tagmode != "none":
                    _draw_text(img, t + 2, r.col_right + 3, r.ID, frame)
        return img

    def to_ansi(self, rows: int = 24, cols: int = 80,
                overlay: bool = True) -> str:
        """Terminal rendering: the image downsampled to a ``rows`` x
        ``cols`` character grid of 24-bit background-color cells — the
        zero-dependency stand-in for the reference's live Qt view
        (reference: python/WaterfallMsgTagging.py:69-83 timer-driven
        repaint)."""
        img = self.render(overlay)
        h, w = img.shape[:2]
        ys = (np.arange(rows) * h) // rows
        xs = (np.arange(cols) * w) // cols
        small = img[ys][:, xs]
        lines = []
        for r in range(rows):
            parts = []
            for c in range(cols):
                rr, gg, bb = (int(v) for v in small[r, c])
                parts.append(f"\x1b[48;2;{rr};{gg};{bb}m ")
            parts.append("\x1b[0m")
            lines.append("".join(parts))
        return "\n".join(lines)

    def save_png(self, path: str, overlay: bool = True) -> bool:
        """Write the current image as PNG (matplotlib backend; returns False
        if matplotlib is unavailable — rendering stays accessible via
        ``render``)."""
        img = self.render(overlay)
        try:
            import matplotlib

            matplotlib.use("Agg", force=True)
            import matplotlib.pyplot as plt

            plt.imsave(path, img)
            return True
        except Exception:
            return False


class DecimatingPowerHistory:
    """RAM-bounded full-capture power history for post-run waterfalls.

    Accumulates per-block power rows while keeping at most ``2 *
    max_rows`` rows in memory by DOUBLING the time decimation whenever the
    buffer fills (sums are kept, so every full window is the exact mean
    over its ``dec`` blocks; the tail row is the exact mean over however
    many blocks it covers). Feed the result to
    :meth:`Waterfall.feed_rows` with ``blockdecimation=history.dec`` so
    event rectangles map to the same rows.

    The CLI's ``run --waterfall`` uses this instead of holding the whole
    debug-spectrum history (a long capture at full resolution is O(blocks
    x blocklen) RAM and an O(blocks^2) scroll).
    """

    def __init__(self, max_rows: int = 2048):
        if max_rows < 1:
            raise ValueError("max_rows must be >= 1")
        self.max_rows = int(max_rows)
        self.dec = 1
        self._sums: List[np.ndarray] = []  # each: sum over dec rows
        self._carry: np.ndarray = None  # partial-window sum
        self._carry_n = 0
        self.n_blocks = 0

    def add(self, power_blocks: np.ndarray):
        """Fold [B, blocklen] linear power rows into the history."""
        p = np.atleast_2d(np.asarray(power_blocks, np.float64))
        if p.size == 0:
            return
        self.n_blocks += len(p)
        if self._carry_n:
            take = min(self.dec - self._carry_n, len(p))
            self._carry = self._carry + p[:take].sum(axis=0)
            self._carry_n += take
            p = p[take:]
            if self._carry_n == self.dec:
                self._sums.append(self._carry)
                self._carry, self._carry_n = None, 0
        n_full = len(p) // self.dec
        if n_full:
            self._sums.extend(
                p[: n_full * self.dec]
                .reshape(n_full, self.dec, -1)
                .sum(axis=1)
            )
        rem = p[n_full * self.dec:]
        if len(rem):
            self._carry = rem.sum(axis=0)
            self._carry_n = len(rem)
        while len(self._sums) > 2 * self.max_rows:
            self._double()

    def _double(self):
        s = self._sums
        pairs = [s[i] + s[i + 1] for i in range(0, len(s) - 1, 2)]
        if len(s) % 2:
            # the odd tail window (a full old-dec sum) absorbs the carry
            # and becomes the new partial window
            tail = s[-1] if self._carry is None else s[-1] + self._carry
            self._carry, self._carry_n = tail, self.dec + self._carry_n
        self._sums = pairs
        self.dec *= 2
        if self._carry_n == self.dec:
            self._sums.append(self._carry)
            self._carry, self._carry_n = None, 0

    def rows(self) -> np.ndarray:
        """[rows, blocklen] float32 mean-power rows at the final ``dec``."""
        out = [np.asarray(s, np.float64) / self.dec for s in self._sums]
        if self._carry_n:
            out.append(np.asarray(self._carry, np.float64) / self._carry_n)
        if not out:
            return np.zeros((0, 0), np.float32)
        return np.stack(out).astype(np.float32)


class LiveWaterfall:
    """Timer-paced live follower over a :class:`Waterfall`.

    The reference repaints its Qt widget from a 200 ms QTimer with a
    min_redraw_time throttle (reference: python/WaterfallMsgTagging.py:69-83,
    22-28); this headless equivalent re-emits the current frame — to a PNG
    path, an ANSI terminal stream, or a callback — at most once per
    ``interval`` seconds, driven by the host loop calling :meth:`update`
    after each processed batch.

    Args:
      waterfall: the Waterfall accumulator to follow.
      interval: minimum seconds between redraws (reference default 0.2).
      png_path: if set, each redraw overwrites this PNG (atomic via rename).
      stream: if set (e.g. sys.stdout), each redraw writes an ANSI frame.
      on_frame: optional callback(img_uint8) per redraw (GUI embedders).
    """

    def __init__(self, waterfall: Waterfall, interval: float = 0.2,
                 png_path: str = None, stream=None, on_frame=None,
                 ansi_rows: int = 24, ansi_cols: int = 80):
        self.wf = waterfall
        self.interval = float(interval)
        self.png_path = png_path
        self.stream = stream
        self.on_frame = on_frame
        self.ansi_rows = ansi_rows
        self.ansi_cols = ansi_cols
        self._last = 0.0
        self.frames = 0

    def update(self, power_blocks=None, events=None, force: bool = False,
               now: float = None) -> bool:
        """Feed new data (optional) and redraw if the interval elapsed.

        Returns True if a frame was emitted. ``now`` injects a clock for
        testing."""
        import time as _time

        if power_blocks is not None:
            self.wf.feed_power(power_blocks)
        if events:
            self.wf.feed_events(events)
        t = _time.monotonic() if now is None else now
        if not force and (t - self._last) < self.interval:
            return False
        self._last = t
        if self.png_path is not None:
            import os as _os

            tmp = str(self.png_path) + ".tmp.png"
            if self.wf.save_png(tmp):
                _os.replace(tmp, self.png_path)
        if self.stream is not None:
            self.stream.write(
                "\x1b[H" + self.wf.to_ansi(self.ansi_rows, self.ansi_cols)
                + "\n"
            )
            if hasattr(self.stream, "flush"):
                self.stream.flush()
        if self.on_frame is not None:
            self.on_frame(self.wf.render())
        self.frames += 1
        return True
