"""Kernel D: the burst channels' hysteresis automaton.

Replaces the Pallas kernel ``_powact_kernel`` of
``fdc_tpu/ops/lifecycle_pallas.py`` (``powact_flags``), which carries the
burst chain of a bank without detection segments (beside segments it
rides kernel C, ``ops.lifecycle``). The plain version is the one
definition both kernels are held to: the scan body of
``PowerActivationBank.scan_flags``
(``fdc_tpu/models/power_activation.py:184-212``). The CUDA source is
``csrc/powact.cu``.
"""

from __future__ import annotations

import numpy as np
import torch

from fdc_tpu_torch import kernels

__all__ = ["powact_flags", "powact_flags_plain"]


def powact_flags_plain(powers, state, delta, *, r: int, thresh: float):
    """Plain PyTorch version of :func:`powact_flags` (same arguments and
    results)."""
    thr = float(np.float32(thresh))
    active, lastpower, phase = (
        state["active"], state["lastpower"], state["phase"]
    )
    flags = []
    for pwr in powers:
        rise = ~active & (pwr / lastpower >= thr)
        fall = active & (lastpower / pwr >= thr)
        processed = rise | active
        phase_used = torch.where(rise, delta, phase)
        phase = torch.where(
            rise, (2 * delta) % r,
            torch.where(processed, (phase + delta) % r, phase),
        )
        active = (active | rise) & ~fall
        lastpower = pwr
        flags.append((rise, fall, processed, phase_used))
    rise, fall, processed, phase_used = (
        torch.stack(f, dim=1) for f in zip(*flags)
    )
    new_state = {"active": active, "lastpower": lastpower, "phase": phase}
    return new_state, (rise, fall, processed, phase_used)


def powact_flags(powers, state, delta, *, r: int, thresh: float):
    """Run the burst hysteresis automaton over a batch.

    Args:
      powers: [B, C] float32 floored in-band powers, B >= 1.
      state: {active [C] bool, lastpower [C] float32, phase [C] int32}.
      delta: [C] int32 per-channel phase increments.
      r: relinvovl, a power of two (as the configuration makes it).
      thresh: the linear threshold (rounded to float32).

    Returns (new_state, (rise, fall, processed, phase_used)) with flags
    [C, B]. CPU tensors take the plain version; CUDA tensors launch the
    kernel.
    """
    if powers.device.type == "cpu":
        return powact_flags_plain(powers, state, delta, r=r, thresh=thresh)
    nb, c = powers.shape
    ins = (powers, state["lastpower"], state["active"], state["phase"],
           delta)
    dtypes = (torch.float32, torch.float32, torch.bool, torch.int32,
              torch.int32)
    for t, dt in zip(ins, dtypes):
        if t.dtype != dt:
            raise TypeError("powact_flags: float32 powers / lastpower, bool "
                            "active, int32 phase / delta expected")
        if t.device != powers.device or not t.is_contiguous():
            raise ValueError("powact_flags: contiguous tensors on one device "
                             "expected")
    if nb < 1 or any(t.shape != (c,) for t in ins[1:]):
        raise ValueError("powact_flags: [B, C] powers and [C] state expected")
    if r < 1 or r & (r - 1):
        raise ValueError("powact_flags: relinvovl must be a power of two")
    dev = powers.device
    flags = torch.empty((3, c, nb), dtype=torch.bool, device=dev)
    phase_used = torch.empty((c, nb), dtype=torch.int32, device=dev)
    new_state = {
        "active": torch.empty(c, dtype=torch.bool, device=dev),
        "lastpower": torch.empty(c, dtype=torch.float32, device=dev),
        "phase": torch.empty(c, dtype=torch.int32, device=dev),
    }
    rc = kernels.library().fdc_powact(
        powers.data_ptr(), nb, c, *(t.data_ptr() for t in ins[1:]),
        float(np.float32(thresh)), int(r),
        flags[0].data_ptr(), flags[1].data_ptr(), flags[2].data_ptr(),
        phase_used.data_ptr(), new_state["active"].data_ptr(),
        new_state["phase"].data_ptr(), new_state["lastpower"].data_ptr(),
        kernels.stream_ptr(dev),
    )
    kernels.check(rc, "fdc_powact")
    powact_flags.launches += 1
    return new_state, (flags[0], flags[1], flags[2], phase_used)


powact_flags.launches = 0
