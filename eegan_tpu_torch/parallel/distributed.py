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

:func:`spawn` starts the ranks of a one-host mesh for a CLI (``train``,
``test``, ``finetune_inception``): one process per GPU, or CPU processes
joined by gloo, through a local coordinator. Ranks beyond the visible GPUs
(the evaluation CLIs allow them) share the cards in turn and join through
gloo, since NCCL refuses two ranks on one device.
"""

from __future__ import annotations

import os
import socket
from typing import Callable, Optional, Sequence

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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(entry: Callable, argv: Sequence[str], ranks: int, device,
          fsdp: int = 1) -> None:
    """Run ``entry(argv, device, mesh)`` in ``ranks`` spawned processes on
    this host, joined through a local coordinator: rank r on ``cuda:r``
    (NCCL; with more ranks than GPUs, on ``cuda:(r mod GPUs)`` through
    gloo), or on the CPU (gloo, the host's cores shared out) when
    ``device`` is the CPU; ``mesh`` is the group's
    (``parallel/mesh.Mesh.current``, fsdp groups of ``fsdp`` ranks).
    ``entry`` is a module-level function (it is pickled); a failure in any
    rank raises here."""
    cards = torch.cuda.device_count()
    if torch.device(device).type == "cuda" and ranks > cards:
        # JAX's make_mesh refuses more devices than it has; the evaluation
        # CLIs let ranks share the cards instead, and say so.
        print(f"{ranks} ranks share {cards} GPU(s) through gloo", flush=True)
    torch.multiprocessing.start_processes(
        _rank_main, args=(entry, list(argv), ranks, torch.device(device).type,
                          fsdp, _free_port()),
        nprocs=ranks, join=True, start_method="spawn")


def _rank_main(rank: int, entry: Callable, argv, ranks: int,
               device_type: str, fsdp: int, port: int) -> None:
    from eegan_tpu_torch.parallel.mesh import Mesh

    backend = None
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        device = torch.device("cuda", rank % cards)
        torch.cuda.set_device(device)
        if ranks > cards:
            backend = "gloo"
    else:
        device = torch.device(device_type)
        # The host's cores shared out, never more than the process would
        # take on its own (OMP_NUM_THREADS).
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // ranks)))
    initialize(f"127.0.0.1:{port}", ranks, rank, device=device,
               backend=backend)
    try:
        entry(argv, device, Mesh.current(device, fsdp=fsdp))
    finally:
        shutdown()
