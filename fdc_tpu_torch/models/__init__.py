"""Channelization modes as ``nn.Module``s over batched FFT blocks."""

from fdc_tpu_torch.models.throughput import ThroughputChannelizer
from fdc_tpu_torch.models.power_activation import PowerActivationBank
from fdc_tpu_torch.models.segment_detection import SegmentDetector
from fdc_tpu_torch.models.activity_detection import (
    ActivityDetectionChannelizer,
)

__all__ = [
    "ThroughputChannelizer",
    "PowerActivationBank",
    "SegmentDetector",
    "ActivityDetectionChannelizer",
]
