"""fdc_tpu_torch — the frequency-domain channelizer on PyTorch and CUDA.

A port of ``fdc_tpu`` (JAX / Pallas on a TPU) to PyTorch with
hand-written CUDA C++ kernels for NVIDIA Hopper (``sm_90a``). It imports
neither JAX nor ``fdc_tpu``; the JAX package is the reference the tests
hold it against.

Covered: overlap-save framing, the FFT front-end, throughput channels,
power-activated burst banks with or without detection segments, the
fused throughput + burst buckets, segment detection with compacted and
two-tier slot extraction, the host ``process`` / ``process_spectra`` /
``flush`` loop with the Python or the native (C++) emitters, the
multi-segment vcm detector (``ActivityDetectionChannelizer``), the host
streaming runtime (``StreamDriver`` over the native sample ring,
checkpoint / resume that cross-restores with ``fdc_tpu``, waterfalls) and
the command line ``python -m fdc_tpu_torch`` — the flagship, the upstream
example and every BASELINE configuration (``flagship.py``). Kernels
(``csrc/``, built with nvcc on first use on a CUDA device):

- A ``extract_shared.cu``: shared-matrix bucket extraction + power
  measures, and the quarter-turn phase fold of throughput buckets;
- B ``candidate_packs.cu``: every detection segment's candidate packs
  (edges, greedy acceptance, compaction, geometry) in one launch;
- C ``lifecycle.cu``: slot lifecycles + the burst hysteresis chain;
- D ``powact.cu``: the burst hysteresis chain of a bank without segments
  (a warp scan, shared with C through ``powact_chain.cuh``);
- E ``extract_static.cu``: bucket extraction with a matrix per channel.
"""

from fdc_tpu_torch.config import ChannelizerConfig
from fdc_tpu_torch.models.activity_detection import (
    ActivityDetectionChannelizer,
)
from fdc_tpu_torch.models.channelizer import (
    FrequencyDomainChannelizer,
    ProcessResult,
)

__version__ = "0.1.0"

__all__ = ["ActivityDetectionChannelizer", "ChannelEvent",
           "ChannelizerConfig", "FrequencyDomainChannelizer",
           "LiveWaterfall", "ProcessResult", "StreamDriver", "Waterfall"]

# imported on first use, as the JAX package does
_LAZY = {
    "StreamDriver": ("fdc_tpu_torch.runtime.stream", "StreamDriver"),
    "Waterfall": ("fdc_tpu_torch.utils.waterfall", "Waterfall"),
    "LiveWaterfall": ("fdc_tpu_torch.utils.waterfall", "LiveWaterfall"),
    "ChannelEvent": ("fdc_tpu_torch.utils.events", "ChannelEvent"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'fdc_tpu_torch' has no attribute {name!r}")
