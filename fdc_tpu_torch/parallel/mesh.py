"""Device mesh construction for the sharded channelizer.

Port of ``fdc_tpu.parallel.mesh``. The sharded step distributes over a
2-D logical mesh with axes

- ``"time"``: consecutive runs of FFT blocks (the overlap-save history
  and the reach-back spectrum row are handed from each time rank to the
  next),
- ``"chan"``: channel groups: throughput / burst channel rows and the
  detection slots' extraction.

A rank is one mesh position, a torch device; entries may repeat (on CUDA
each rank then runs on a stream of its own, ``parallel.lanes``). One
process drives every rank of its rows of the mesh; with several
processes (``parallel.multihost``) each holds a contiguous run of the
time axis.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from fdc_tpu_torch.parallel.lanes import lane_devices

__all__ = ["Mesh", "make_mesh", "TIME_AXIS", "CHAN_AXIS"]

TIME_AXIS = "time"
CHAN_AXIS = "chan"


class Mesh:
    """A (time, chan) grid of torch devices.

    ``devices``: this process's rows, ``[n_time_local][n_chan]``; with
    ``process_count`` processes the mesh has ``n_time_local *
    process_count`` time ranks, this process's the run starting at
    ``time_offset``. ``shape`` maps each axis name to its global size."""

    axis_names = (TIME_AXIS, CHAN_AXIS)

    def __init__(self, devices, process_index: int = 0,
                 process_count: int = 1):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or len({len(r) for r in rows}) != 1 or not rows[0]:
            raise ValueError("mesh devices must be a non-empty 2-D grid")
        self.devices = rows
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.n_time_local = len(rows)
        self.time_offset = self.process_index * self.n_time_local
        self.shape = {TIME_AXIS: self.n_time_local * self.process_count,
                      CHAN_AXIS: len(rows[0])}

    @property
    def local_devices(self):
        """This process's ranks, time-major: rank (t, c) at t * n_chan +
        c."""
        return [d for row in self.devices for d in row]


def make_mesh(
    n_time: Optional[int] = None,
    n_chan: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (time, chan) mesh over the given (default: every CUDA)
    devices; there is no CPU fallback (``["cpu"] * n`` asks for the
    kernels' plain versions).

    With only ``n_chan`` given, the time axis takes all remaining devices.
    """
    devices = lane_devices(list(devices) if devices is not None else None)
    if n_chan < 1:
        raise ValueError(f"n_chan must be >= 1, got {n_chan}")
    if n_time is None:
        n_time = len(devices) // n_chan
    if n_time < 1:
        raise ValueError(f"n_time must be >= 1, got {n_time}")
    need = n_time * n_chan
    if need > len(devices):
        raise ValueError(
            f"mesh {n_time}x{n_chan} needs {need} devices, "
            f"have {len(devices)}"
        )
    return Mesh([devices[t * n_chan:(t + 1) * n_chan]
                 for t in range(n_time)])
