"""Multi-process bring-up: torch.distributed, the global (time, chan)
mesh, per-process feeding and the gathers across processes.

Port of ``fdc_tpu.parallel.multihost`` (the pod-scale story, BASELINE
config 5: 200+ MS/s and 512+ dynamic channels over two or more hosts).
Pattern:

1. every process calls :func:`initialize_multihost` (a
   ``torch.distributed`` process group; a no-op for one process),
2. every process builds :func:`global_mesh` over its own devices: the
   processes' rows stack along the time axis in process order, so each
   process holds one contiguous run of the time ranks,
3. a ``ShardedChannelizer`` is constructed identically on every process,
4. each process feeds its own contiguous run of each batch's samples
   (:func:`host_local_batch`), the natural layout when each host fronts
   its own digitizer or stream shard,
5. the sharded step runs on every process; at the process boundaries the
   history tail and the reach-back row, the detection statistics and the
   step outputs cross through the process group, so every process runs
   the same scans and emits the same events.

The collectives run on host-staged tensors (gloo): NCCL cannot put two
processes on one card, which is what a one-card machine has. An NCCL
process group (one GPU a process) is untried.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from fdc_tpu_torch.parallel.lanes import lane_devices
from fdc_tpu_torch.parallel.mesh import Mesh

__all__ = [
    "initialize_multihost",
    "global_mesh",
    "host_local_batch",
    "process_allgather",
    "process_count",
    "process_index",
]


def process_count() -> int:
    """Processes in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default process group (0 without
    one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def initialize_multihost(
    init_method: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "gloo",
) -> int:
    """Initialize the default ``torch.distributed`` process group (a
    no-op for one process). ``init_method``: ``"tcp://host:port"`` or
    ``"file:///path"``, default ``"env://"`` (MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK from the environment). Returns the process index."""
    if ((num_processes is not None and num_processes > 1) or init_method
            ) and not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id,
        )
    return process_index()


def global_mesh(n_chan: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """(time, chan) mesh over the devices of every process: this
    process's ``devices`` (default: every CUDA device) make its rows, and
    the processes' rows stack along the time axis in process order, so
    each process feeds one contiguous run of samples and the time
    hand-offs cross processes only at their boundaries. Every process
    must bring the same number of devices."""
    devices = lane_devices(list(devices) if devices is not None else None)
    n = len(devices)
    if n % n_chan:
        raise ValueError(f"{n} devices not divisible by n_chan={n_chan}")
    counts = process_allgather(np.array([n], np.int64)).reshape(-1)
    if (counts != n).any():
        raise ValueError(
            f"every process must bring the same number of devices, got "
            f"{counts.tolist()}"
        )
    rows = [devices[t * n_chan:(t + 1) * n_chan] for t in range(n // n_chan)]
    return Mesh(rows, process_index(), process_count())


def host_local_batch(mesh: Mesh, x_local) -> torch.Tensor:
    """This process's contiguous run of one step's samples, complex64
    [B_local * inplen] (or ``fdc_tpu``'s float32 [n, 2] pairs), on the
    mesh's first local device: the input of the sharded step
    (``ShardedChannelizer._device_step``)."""
    x = np.asarray(x_local)
    if x.dtype == np.float32 and x.ndim == 2 and x.shape[1] == 2:
        x = np.ascontiguousarray(x).view(np.complex64)[:, 0]
    x = np.ascontiguousarray(x, np.complex64)
    return torch.from_numpy(x).to(mesh.devices[0][0])


def allgather(tensors):
    """Every process's ``tensors`` (equal shapes on every process, any
    dtype), each returned as [P, ...] on its tensor's device, through one
    all_gather of their bytes staged on the host (the identity with a
    leading axis of 1 for one process)."""
    if process_count() == 1:
        return [t[None] for t in tensors]
    host = [t.detach().to("cpu").contiguous() for t in tensors]
    sizes = [h.numel() * h.element_size() for h in host]
    buf = torch.cat([h.reshape(-1).view(torch.uint8) for h in host]
                    ) if host else torch.zeros(0, dtype=torch.uint8)
    parts = [torch.empty_like(buf) for _ in range(process_count())]
    dist.all_gather(parts, buf)
    out, off = [], 0
    for t, h, n in zip(tensors, host, sizes):
        got = torch.stack([
            p[off:off + n].clone().view(h.dtype).reshape(h.shape)
            for p in parts])
        out.append(got.to(t.device))
        off += n
    return out


def process_allgather(x, tiled: bool = False):
    """``x`` (a numpy array or a tensor) from every process, stacked on
    a new leading axis (``tiled``: concatenated along axis 0), as
    ``jax.experimental.multihost_utils.process_allgather``; numpy in,
    numpy out."""
    is_np = isinstance(x, np.ndarray)
    t = torch.from_numpy(np.ascontiguousarray(x)) if is_np else x
    got = allgather([t])[0]
    if tiled:
        got = got.reshape((-1,) + tuple(got.shape[2:]))
    return got.numpy() if is_np else got
