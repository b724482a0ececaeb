"""The cells at sizes a CPU test run holds: B = 64 (flagship) or 96
(hunter4seg) blocks a batch, rings of 4 batches, durations cut to fit;
every width of the configuration is as it is run."""

import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def small(workload):
    """(configuration overrides, mix overrides) of a cell at test size."""
    if workload == "flagship.mixed":
        mix = json.loads((HERE / "traffic" / "mixed.json").read_text())
        lanes = [dict(l, on_blocks=[32, 96], off_blocks=[32, 64])
                 for l in mix["segments"]["lanes"]]
        return ({"batch_blocks": 64}, {
            "ring_batches": 4,
            "burst_channels": dict(mix["burst_channels"],
                                   on_blocks=[48, 96], off_blocks=[48, 96]),
            "segments": dict(mix["segments"], lanes=lanes)})
    mix = json.loads((HERE / "traffic" / "bursty.json").read_text())
    lanes = [dict(l, blocks=[4, 32]) for l in mix["segments"]["lanes"]]
    return ({"batch_blocks": 96},
            {"ring_batches": 4, "segments": dict(mix["segments"],
                                                 lanes=lanes)})
