"""fdc_tpu_torch — the frequency-domain channelizer on PyTorch and CUDA.

A port of ``fdc_tpu`` (JAX / Pallas on a TPU) to PyTorch with
hand-written CUDA C++ kernels for NVIDIA Hopper (``sm_90a``). It imports
neither JAX nor ``fdc_tpu``; the JAX package is the reference the tests
hold it against.

Covered: the flagship step — overlap-save framing, FFT front-end,
throughput channels, the power-activated burst bank beside detection
segments, exact-mode segment detection with compacted slot extraction —
and the host ``process`` / ``flush`` loop with the Python emitters.
Kernels (``csrc/``, built with nvcc on first use on a CUDA device):

- A ``extract_shared.cu``: shared-matrix bucket extraction + power measures;
- B ``greedy_accept.cu``: greedy candidate acceptance;
- C ``lifecycle.cu``: slot lifecycles + the burst hysteresis chain.
"""

from fdc_tpu_torch.config import ChannelizerConfig
from fdc_tpu_torch.models.channelizer import (
    FrequencyDomainChannelizer,
    ProcessResult,
)

__version__ = "0.1.0"

__all__ = ["ChannelizerConfig", "FrequencyDomainChannelizer",
           "ProcessResult"]
