"""The control of a channelizer cell's comparison: the reference, computed
with TF32's 10-bit mantissa (``channelizer.tf32``), put in the program's
place. The configurations state complex64 with TF32 off (the port turns
it off), so TF32 is the nearest precision below; the comparison has to
find the control not correct.

    python3 benchmark/reference/control.py --workload flagship.mixed \\
        --seconds 20 --seeds 1 2 3

runs the harness on the control, at the cell's own sizes, once a seed,
and prints each run's compared numbers (one JSON line a seed). It needs
no card: the control runs on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.reference import channelizer as ref  # noqa: E402


@dataclass
class Event:
    """A reference event in the program's event form."""

    ID: str
    finalized: bool
    part: object
    rel_cfreq: float
    rel_bw: float
    blockstart: int
    blockend: int
    vectorstart: object = None
    vectorend: object = None
    data: np.ndarray = None


@dataclass
class Result:
    throughput: list = field(default_factory=list)
    events: list = field(default_factory=list)
    segment_power: list = field(default_factory=list)


def _event(e) -> Event:
    return Event(ID=f"control.{e['source']}.{e['unit']}.0",
                 finalized=e["finalized"], part=e["part"],
                 rel_cfreq=e["rel_cfreq"], rel_bw=e["rel_bw"],
                 blockstart=e["blockstart"], blockend=e["blockend"],
                 vectorstart=e["vectorstart"], vectorend=e["vectorend"],
                 data=e["data"].astype(np.complex64))


class ControlProgram:
    """The reference with ``rnd`` behind the program's streaming calls
    (whole batches only, as the harness hands them)."""

    def __init__(self, cfg: dict, rnd=ref.tf32):
        self.cfg = cfg
        self.stream = ref.Stream(cfg, rnd)
        self.power_emitter = None
        self.segment_emitters = []

    def process(self, samples) -> Result:
        o = self.stream.step(samples, want_outputs=True)
        return Result(
            throughput=[t.astype(np.complex64) for t in o.throughput],
            events=[_event(e) for e in o.events],
            segment_power=[p.astype(np.float32) for p in o.seg_power])

    def flush(self) -> Result:
        """The end of the stream (not compared)."""
        return Result()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from benchmark import harness

    for seed in args.seeds:
        t = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False, t,
                             device="cpu", program=ControlProgram)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"],
                          "calls": r["attempted"],
                          "compared": r["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
