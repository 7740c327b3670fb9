"""Traffic of kind ``train_mesh``: the program's K-step training call on a
data mesh of :data:`CARDS` cards of one host, one process a card, each
holding its rows of every global batch.

The traffic file gives ``batch_per_card`` (B), ``steps_per_call`` (K) and
``pool_batches`` (P) as for kind ``train``; a global batch is R·B rows
(R = :data:`CARDS`), and the cell's RUNTIME.MESH is ``data:R``.

The benchmark's process is rank 0, on card 0. It starts ranks 1 .. R-1
(``python -m benchmark.drivers.train_mesh <task>``, rank r on card r)
and joins them through a coordinator on 127.0.0.1: NCCL on the cards
(gloo on the CPU), and a gloo group besides for what the hosts decide
together. Every rank draws the seed's weights and the pool of P global
batches on its card and keeps its rows (rank r: rows r·B .. r·B+B-1),
draws each call's global noise on its card and keeps its rows, and
builds the program on the mesh (the cell's architecture,
``build_train(..., mesh=True)``).

Each rank runs ``drivers/train.py``'s program and window
(``train.run(..., group=...)``). Set-up runs from the benchmark
process's start: the ranks' start, one call, whose first three steps
the check compares, and one more call. Every rank synchronises its
card, then rank 0 starts the clock; the calls go on in lockstep, rank 0
telling the others after each call whether ``--seconds`` have passed on
its clock; a value is read after the last call on every rank.
``train_images_per_s`` is per card: R·B x steps / window / R. Rank 0 alone
runs the profiler in the traced call, which trains pool batches
0 .. K-1 on every rank. Peak memory is the fullest card's.

The check: rank 0's first call against the reference's step over the
global batch, which the same R processes compute once the program's
state is freed (the architecture's ``numbers(..., mesh=True)``). Every
rank reports the forbidden modules it holds once the window has closed.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch
import torch.distributed as dist

from benchmark import harness
from benchmark.drivers import train

CARDS = 4
# How long a rank waits in a collective before the run fails; above the
# kernels' first build, which the ranks may reach at different times.
RANK_TIMEOUT_S = 600
THREADS = 2  # each rank's host threads
# The command that starts ranks 1 .. R-1, a task's JSON appended.
LAUNCH = [sys.executable, "-m", "benchmark.drivers.train_mesh"]


# --- the ranks ---------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(rank: int, ranks: int, port: int, device):
    """Join the group as ``rank``; returns the hosts' gloo group."""
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{port}", world_size=ranks, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    return dist.new_group(backend="gloo")


def _watch(gone, log, stop: threading.Event) -> None:
    """A daemon thread that ends this process once ``gone()`` names a
    rank that has gone (a rank waiting in a collective on it would wait
    until the group's timeout), until ``stop`` is set."""
    def watch():
        while not stop.wait(0.5):
            what = gone()
            if what:
                log(f"{what}: ending this rank")
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


class Ranks:
    """Ranks 1 .. R-1 of ``task``, started as processes, and this process
    joined as rank 0; on exit the group is left and every rank has
    ended (one that outlives the grace is killed)."""

    GRACE_S = 120

    def __init__(self, task: Dict, device, log):
        self.task, self.device, self.log = dict(task), device, log
        self.procs: List[subprocess.Popen] = []

    def __enter__(self):
        port = _free_port()
        self.task.update(port=port, ranks=CARDS, device=self.device.type)
        for r in range(1, CARDS):
            self.procs.append(subprocess.Popen(
                [*LAUNCH, json.dumps(dict(self.task, rank=r))],
                cwd=str(harness.ROOT), stdout=subprocess.DEVNULL))
        self.stop = threading.Event()

        def gone():
            for r, p in enumerate(self.procs, 1):
                if p.poll() not in (None, 0) and not self.stop.is_set():
                    self._kill()
                    return f"rank {r} exited with {p.returncode}"
            return None

        _watch(gone, self.log, self.stop)
        return _join(0, CARDS, port, self.device)

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def __exit__(self, *exc):
        self.stop.set()
        if exc[0] is not None:
            self._kill()
        dist.destroy_process_group()
        deadline = time.monotonic() + self.GRACE_S
        for p in self.procs:
            try:
                p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self.log("a rank outlived the run: killed")
        self._kill()
        return False


def run(cell, args, device, t_start: float, log) -> harness.Outcome:
    """The cell's run, this process rank 0."""
    task = dict(mode="run", workload=cell.name, root=str(cell.root),
                seed=args.seed, seconds=args.seconds, trace=args.trace)
    with Ranks(task, device, log) as hosts:
        return train.run(cell, args, device, t_start, log, group=hosts)


def readings(cell, runs, device, log):
    """For each (kind, seed) of ``runs``, rank 0's ``train.readings_of``,
    this process rank 0 (``calibrate.py``)."""
    with Ranks(dict(mode="readings", workload=cell.name,
                    root=str(cell.root), runs=list(runs)), device, log):
        for kind, seed in runs:
            yield kind, seed, train.readings_of(cell, seed, device, kind, 0,
                                                CARDS)


def rank_main(argv=None) -> int:
    """Rank r > 0 of a task (``run`` or ``readings``) that rank 0 started."""
    task = json.loads((sys.argv[1:] if argv is None else argv)[0])
    rank = task["rank"]

    def log(msg):
        print(f"[rank {rank}] {msg}", file=sys.stderr, flush=True)

    torch.set_num_threads(THREADS)
    if task["device"] == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    parent = os.getppid()
    _watch(lambda: None if os.getppid() == parent else "rank 0 is gone", log,
           threading.Event())
    cell = harness.find_cell(task["workload"], Path(task["root"]))
    hosts = _join(rank, task["ranks"], task["port"], device)
    try:
        if task["mode"] == "run":
            args = argparse.Namespace(
                workload=task["workload"], seed=task["seed"],
                seconds=task["seconds"], trace=task["trace"],
                trace_file=None)
            train.run(cell, args, device, time.perf_counter(), log,
                      group=hosts)
        else:
            for kind, seed in task["runs"]:
                train.readings_of(cell, seed, device, kind, rank,
                                  task["ranks"])
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
