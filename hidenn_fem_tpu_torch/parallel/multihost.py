"""Joining a ``torch.distributed`` process group (port of
``hidenn_fem_tpu/parallel/multihost.py``).

JAX joins its multi-process runtime with ``jax.distributed.initialize``
and then sees every process's devices.  Here each process is one rank
with one device, and the sharded energies (``parallel/sharding.py``,
``sharded_slab.py``, ``sharded_lattice.py``) exchange their partial
energies and node gradients with ``all_reduce`` and ``broadcast`` over the
default process group.  Nothing in a machine tells a rank of its
cluster, so the address, the world size and the rank are given, or read
from the environment variables ``torch.distributed`` knows
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_multihost", "is_multihost", "process_summary"]

# how long a collective may wait for the other ranks before it raises
TIMEOUT = datetime.timedelta(seconds=300)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, through the rendezvous at ``coordinator_address``
    (``host:port``; None reads ``MASTER_ADDR``/``MASTER_PORT``).

    ``backend``: None takes NCCL when this process sees a CUDA card and
    gloo otherwise; "gloo" on CUDA tensors lets several ranks share one
    card (gloo supports ``all_reduce`` and ``broadcast`` there, which is
    all the sharded energies use).  Call once, on every rank, before any
    sharded energy."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def is_multihost() -> bool:
    """True when this process is one rank of a group of several."""
    return dist.is_initialized() and dist.get_world_size() > 1


def process_summary() -> dict:
    """The process topology, with the JAX package's keys: this rank, the
    rank count, the CUDA devices this process sees (1 on a machine with
    none: the CPU), and the devices of the group (one a rank)."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": size,
        "local_devices": torch.cuda.device_count() or 1,
        "global_devices": size,
    }
