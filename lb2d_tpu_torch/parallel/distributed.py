"""Multi-process runtime (counterpart of ``lb2d_tpu.parallel.distributed``).

Every process of a job calls :func:`init_distributed` before any
computation, with the same coordinator address (``host:port`` of process
0) and its own ``process_id``; :func:`global_mesh` then builds the mesh over
every process's devices, and the sharded models of
:mod:`lb2d_tpu_torch.parallel.sharded` run on it unchanged, each process
stepping its own shards. The process group is ``torch.distributed``'s: NCCL
on CUDA devices, gloo on the CPU. Nothing tells a program of a cluster, so
the address, the number of processes and the rank are given here. One
process without a coordinator only marks itself initialized.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..models.base import resolve_device
from .halo import Mesh

__all__ = ["init_distributed", "global_mesh", "is_initialized"]

_initialized = False
_local_devices = None  # this process's devices, from init_distributed


def is_initialized() -> bool:
    return _initialized


def _cuda_devices(ids=None):
    if ids is None:
        ids = range(torch.cuda.device_count())
    return [torch.device("cuda", int(i)) for i in ids]


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, device: str = "cuda") -> None:
    """Join the job (nothing to join for one process without a
    coordinator).

    ``local_device_ids`` are the CUDA ordinals this process's shards use
    (default: all its cards for one process, card ``process_id`` modulo the
    card count for several). ``device="cpu"`` puts the shards on the CPU
    and joins over gloo; CUDA devices join over NCCL, with
    ``init_method="tcp://<coordinator_address>"``.
    """
    global _initialized, _local_devices
    on_cpu = resolve_device(device).type == "cpu"
    single = num_processes in (None, 1) and coordinator_address is None
    if on_cpu:
        _local_devices = [torch.device("cpu")]
    elif local_device_ids is not None or single:
        _local_devices = _cuda_devices(local_device_ids)
    else:
        _local_devices = _cuda_devices(
            [int(process_id) % torch.cuda.device_count()])
    if not single:
        if not on_cpu:
            torch.cuda.set_device(_local_devices[0])
        dist.init_process_group(
            "gloo" if on_cpu else "nccl",
            init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id))
    _initialized = True


def global_mesh(shape: tuple[int, int] | None = None,
                contiguous_y: bool = True, devices=None) -> Mesh:
    """A mesh over the devices of every process in the job: ``devices``
    (default: those of :func:`init_distributed`, else every local card) on
    each rank, in rank order.

    With ``contiguous_y`` (default) the default shape keeps each process's
    shards on contiguous grid rows, so the y-halos cross processes only at
    their seams; the taller factoring is preferred (``lb2d_tpu/parallel/
    distributed.py:79-90``).
    """
    if devices is None:
        devices = _local_devices if _local_devices is not None else (
            _cuda_devices())
    devices = [torch.device(d) for d in devices]
    world = dist.get_world_size() if dist.is_initialized() else 1
    entries = [(rank, dev) for rank in range(world) for dev in devices]
    n = len(entries)
    if n == 0:
        raise ValueError("no devices for a global mesh")
    if shape is None:
        my = int(np.floor(np.sqrt(n)))
        while n % my:
            my -= 1
        shape = (n // my, my) if contiguous_y else (my, n // my)
        if shape[0] < shape[1]:
            shape = (shape[1], shape[0])
    if shape[0] * shape[1] != n:
        raise ValueError(f"a {shape[0]}x{shape[1]} mesh does not hold {n} "
                         "devices")
    return Mesh(entries, shape)
