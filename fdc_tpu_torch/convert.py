"""Carry conversion between the JAX package and the port.

Both carries are nested dicts (and, for the multi-segment runner, lists)
with the same keys (``hist``, ``prev_spec``, ``powact``, ``seg{i}``; the
runner's ``prev_spec`` and ``segs``) and the same dtypes (complex64
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
    """Nested dicts / lists of numpy arrays -> the port's carry on
    ``device``."""
    if isinstance(tree, dict):
        return {k: carry_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [carry_from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def carry_to_numpy(carry):
    """The port's carry -> nested dicts / lists of numpy arrays."""
    if isinstance(carry, dict):
        return {k: carry_to_numpy(v) for k, v in carry.items()}
    if isinstance(carry, (list, tuple)):
        return [carry_to_numpy(v) for v in carry]
    return carry.detach().cpu().numpy()
