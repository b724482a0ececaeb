"""Host-side utilities: events, logging, file sinks, waterfall rendering,
rational resampling (``resample``) and step timing (``profiling``)."""

from fdc_tpu_torch.utils.events import (
    ChannelEvent,
    FileSink,
    current_timestamp,
    make_event_id,
)
from fdc_tpu_torch.utils.logging import make_logger
from fdc_tpu_torch.utils.resample import common_rate, rational_resample
from fdc_tpu_torch.utils.waterfall import LiveWaterfall, Waterfall

__all__ = [
    "ChannelEvent",
    "FileSink",
    "current_timestamp",
    "make_event_id",
    "make_logger",
    "rational_resample",
    "common_rate",
    "Waterfall",
    "LiveWaterfall",
]
