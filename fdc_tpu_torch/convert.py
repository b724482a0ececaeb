"""Carry conversion between the JAX package and the port.

Both carries are nested dicts with the same keys (``hist``,
``prev_spec``, ``powact``, ``seg{i}``) and the same dtypes (complex64
history and spectrum, bool flags, int32 tables and counters, float32
powers), so a JAX run can hand its stream state to the port mid-stream —
live slots and open bursts included — and back. Give the JAX carry as
numpy arrays (``jax.tree.map(np.asarray, carry)``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["carry_from_numpy", "carry_to_numpy"]


def carry_from_numpy(tree, device):
    """Nested dict of numpy arrays -> the port's carry on ``device``."""
    if isinstance(tree, dict):
        return {k: carry_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def carry_to_numpy(carry):
    """The port's carry -> nested dict of numpy arrays."""
    if isinstance(carry, dict):
        return {k: carry_to_numpy(v) for k, v in carry.items()}
    return carry.detach().cpu().numpy()
