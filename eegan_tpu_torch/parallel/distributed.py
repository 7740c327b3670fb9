"""Process-group initialisation (counterpart of
``eegan_tpu/parallel/distributed.py``).

The port runs one process per GPU. One call per process, before any
collective, joins it to the group: ``torch.distributed.init_process_group``
with NCCL for a CUDA device and gloo for the CPU (or the backend the caller
names; the choice is never swapped behind the caller's back). The
coordinator address and the process counts come from the arguments or
from the JAX package's env names:

    EEGAN_COORDINATOR=host:port  EEGAN_NUM_PROCESSES=N  EEGAN_PROCESS_ID=i

With neither, torch's own ``env://`` variables (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them) take
the place of the JAX package's TPU-pod auto-discovery.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda", backend: Optional[str] = None) -> None:
    """Idempotent ``init_process_group`` with env-var fallbacks: a second
    call in a process that has joined a group is a no-op."""
    coordinator = coordinator or os.environ.get("EEGAN_COORDINATOR")
    if num_processes is None and "EEGAN_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["EEGAN_NUM_PROCESSES"])
    if process_id is None and "EEGAN_PROCESS_ID" in os.environ:
        process_id = int(os.environ["EEGAN_PROCESS_ID"])

    if dist.is_initialized():
        return
    backend = backend or default_backend(device)
    if coordinator is None and num_processes is None:
        dist.init_process_group(backend, init_method="env://")
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a coordinator address, the number of processes and this "
            "process's id are all needed (EEGAN_COORDINATOR, "
            "EEGAN_NUM_PROCESSES, EEGAN_PROCESS_ID)")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
