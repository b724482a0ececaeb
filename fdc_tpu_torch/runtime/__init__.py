"""Host streaming runtime: drivers, native ring buffers, emission."""

from fdc_tpu_torch.runtime.emission import (
    PowerActivationEmitter,
    SegmentDetectionEmitter,
)
from fdc_tpu_torch.runtime.stream import StreamDriver, StreamStats

__all__ = [
    "PowerActivationEmitter",
    "SegmentDetectionEmitter",
    "StreamDriver",
    "StreamStats",
]
