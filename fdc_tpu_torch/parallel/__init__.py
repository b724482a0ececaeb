"""Multi-device distribution: meshes, the sharded step over a (time,
chan) mesh of ranks, the MPMD batch pipeline and its cross-process leg
(``hostpipe``); ``multihost`` spreads the sharded step over processes."""

from fdc_tpu_torch.parallel.mesh import CHAN_AXIS, TIME_AXIS, make_mesh
from fdc_tpu_torch.parallel.pipeline import PipelineChannelizer
from fdc_tpu_torch.parallel.sharded import ShardedChannelizer

__all__ = [
    "make_mesh",
    "TIME_AXIS",
    "CHAN_AXIS",
    "PipelineChannelizer",
    "ShardedChannelizer",
]
