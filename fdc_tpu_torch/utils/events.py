# Copied from fdc_tpu/utils/events.py; only the import paths differ.
"""Detection-event records — the framework's PDU equivalent.

The reference emits channel data as PMT PDUs ``(meta_dict, c32vector)`` on
async message ports and/or as raw complex64 files
(reference: lib/SegmentDetection_impl.cc:437-539,
lib/PowerActivationChannel_impl.cc:212-258). Here an event is a typed host
record with the exact same metadata schema and file format, produced by the
host emission layer from device step outputs.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["ChannelEvent", "make_event_id", "current_timestamp", "FileSink"]


def current_timestamp() -> str:
    """Reference ID timestamp format (reference: lib/SegmentDetection_impl.cc:680-693)."""
    return time.strftime("%Y-%m-%d-%H-%M-%S", time.localtime())


def make_event_id(source: str, unit_id: int, counter: int, timestamp: Optional[str] = None) -> str:
    """ID convention ``timestamp.SRC.SEGMENTNUM.CONTNUM``
    (reference: lib/SegmentDetection_impl.cc:674-678,
    lib/PowerActivationChannel_impl.cc:308-312)."""
    ts = timestamp or current_timestamp()
    return f"{ts}.{source}.{unit_id}.{counter}"


@dataclass
class ChannelEvent:
    """One emitted channel burst (or part thereof).

    Field names and semantics match the reference PDU meta dict keys
    (reference: lib/SegmentDetection_impl.cc:446-458,
    lib/PowerActivationChannel_impl.cc:222-231). ``vectorstart``/``vectorend``
    are only set by the detection path, as in the reference.
    """

    ID: str
    finalized: bool
    part: Optional[int]
    rel_cfreq: float
    rel_bw: float
    blockstart: int
    blockend: int
    vectorstart: Optional[int] = None
    vectorend: Optional[int] = None
    data: np.ndarray = field(default_factory=lambda: np.zeros(0, np.complex64))

    def to_dict(self) -> dict:
        """Metadata dict with exactly the reference's PDU keys."""
        d = {
            "ID": self.ID,
            "finalized": self.finalized,
            "rel_bw": self.rel_bw,
            "rel_cfreq": self.rel_cfreq,
            "blockstart": self.blockstart,
            "blockend": self.blockend,
        }
        if self.part is not None:
            d["part"] = self.part
        if self.vectorstart is not None:
            d["vectorstart"] = self.vectorstart
            d["vectorend"] = self.vectorend
        return d

    @property
    def filename(self) -> str:
        """Reference file-name convention: ``<ID>.fin`` or ``<ID>.parted.<part>``
        (reference: lib/SegmentDetection_impl.cc:463,519)."""
        if self.finalized:
            return f"{self.ID}.fin"
        return f"{self.ID}.parted.{self.part}"


class FileSink:
    """Raw complex64 file writer matching the reference's fwrite output
    (reference: lib/PowerActivationChannel_impl.cc:235-244). Write failures
    are logged, never raised — the stream must not die at runtime."""

    def __init__(self, path: str, log=None):
        self.path = path
        self._log = log or (lambda s: None)

    def write(self, event: ChannelEvent) -> bool:
        filename = os.path.join(self.path, event.filename)
        try:
            np.asarray(event.data, dtype=np.complex64).tofile(filename)
            return True
        except OSError:
            self._log(f"Cannot write to file {filename}")
            return False


def parse_event_filename(name: str):
    """Parse the reference's burst-file naming back into metadata:
    ``<ID>.fin`` or ``<ID>.parted.<N>`` with ID = ts.SRC.UNIT.COUNTER
    (reference: lib/SegmentDetection_impl.cc:463,519). Returns a dict or
    None if the name does not match."""
    parts = name.split(".")
    if len(parts) >= 5 and parts[-1] == "fin":
        event_id, fin, part = ".".join(parts[:-1]), True, None
    elif len(parts) >= 6 and parts[-2] == "parted":
        try:
            part = int(parts[-1])
        except ValueError:
            return None
        event_id, fin = ".".join(parts[:-2]), False
    else:
        return None
    idp = event_id.split(".")
    if len(idp) < 4:
        return None
    return {
        "ID": event_id,
        "finalized": fin,
        "part": part,
        "timestamp": ".".join(idp[:-3]),
        "source": idp[-3],
        "unit": int(idp[-2]) if idp[-2].isdigit() else idp[-2],
        "counter": int(idp[-1]) if idp[-1].isdigit() else idp[-1],
    }


def read_event_file(path: str) -> np.ndarray:
    """Load one burst file (raw interleaved complex64, the reference's
    fwrite format)."""
    return np.fromfile(path, dtype=np.complex64)


def scan_output_dir(path: str):
    """Enumerate burst files in an output directory in (ID, part) order.

    Returns a list of dicts (parse_event_filename fields plus ``path``),
    finalized parts last per ID — the order a downstream consumer should
    concatenate ``.parted.N`` chunks and the ``.fin`` tail.
    """
    entries = []
    for name in os.listdir(path):
        meta = parse_event_filename(name)
        if meta is None:
            continue
        meta["path"] = os.path.join(path, name)
        entries.append(meta)
    entries.sort(
        key=lambda m: (
            m["ID"],
            1 if m["finalized"] else 0,
            m["part"] if m["part"] is not None else 1 << 60,
        )
    )
    return entries
