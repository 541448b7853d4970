"""Process-group and device-list helpers of the multi-device tier.

Counterpart of ``archi_tpu/engine/distributed.py``.  The JAX package is
single-controller: one process drives every device of its host through a
``Mesh``, and ``jax.distributed`` joins the hosts of a pod slice.  The port
keeps that shape:

- one process drives a LIST of devices, and a shard is a logical partition
  placed on one of them.  A device may repeat: ``["cuda:0"] * 4`` puts four
  shards on one card and ``["cpu"] * 8`` eight on the host, the counterpart
  of the JAX tests' virtual CPU devices;
- across hosts, one process a host joins a ``torch.distributed`` group
  (``initialize_distributed``), and the sharded indexes merge their
  per-process top-k through ``all_gather`` over it.
  ``torch.distributed.device_mesh`` does not fit: it wants one process per
  device.

``fetch`` is the counterpart of one ``jax.device_get`` over many arrays:
every copy to the host is queued before any is waited on.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from archi_tpu_torch.utils.hardware import default_device


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
) -> None:
    """Join this process to the default ``torch.distributed`` group.

    No-op on a single host.  Arguments default from the same environment
    variables as the JAX package (COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID); a group of one process is made when only the address is
    given.  ``device`` picks the backend: ``nccl`` for cuda, ``gloo`` for
    cpu."""
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("NUM_PROCESSES"):
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and os.environ.get("PROCESS_ID"):
        process_id = int(os.environ["PROCESS_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        return  # single host
    if coordinator_address is None:
        raise ValueError("initialize_distributed: NUM_PROCESSES > 1 needs "
                         "a COORDINATOR_ADDRESS (host:port)")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=1 if num_processes is None else num_processes,
        rank=0 if process_id is None else process_id)


def process_group():
    """(default group, world size, rank), or (None, 1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    return None, 1, 0


def data_mesh(devices=None) -> list[torch.device]:
    """This process's shard devices as a flat list (a device may repeat).
    Default: every visible CUDA device; raises without CUDA."""
    if devices is None:
        default_device()
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("data_mesh: no devices")
    return devices


def dp_tp_mesh(tp: int = 1, *, devices=None) -> list[list[torch.device]]:
    """A (data, model) grid of devices: ``n / tp`` rows of ``tp``; tp must
    divide n."""
    devices = data_mesh(devices)
    n = len(devices)
    assert n % tp == 0, (n, tp)
    return [devices[r * tp:(r + 1) * tp] for r in range(n // tp)]


def comm_device(group) -> torch.device:
    """Where a tensor must lie for a collective over ``group``: the current
    CUDA device for nccl, the host for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape and type on all ranks), rank order,
    on ``t``'s device (the list form, which every torch version takes
    without a deprecation warning)."""
    dev = comm_device(group)
    src = t.to(dev).contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


def fetch(tensors) -> list[np.ndarray]:
    """Tensors → host arrays with one wait per device: every copy is queued
    (non-blocking, into pinned memory) before any is waited on."""
    host, waits = [], set()
    for t in tensors:
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            waits.add(t.device)
            host.append(h)
        else:
            host.append(t.detach())
    for d in waits:
        torch.cuda.synchronize(d)
    return [h.numpy() for h in host]
