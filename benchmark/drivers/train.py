"""Traffic of kind ``train``: the program's K-step training call over a
pool of batches drawn from the seed.

The traffic file gives ``batch_per_card``, ``steps_per_call`` (K) and
``pool_batches`` (P, a multiple of K): P batches are drawn once at
set-up, on the device, and call i trains on batches (i·K mod P) .. +K,
with noise drawn on the device for every call. Set-up builds the
program with the benchmark's weights (the cell's architecture,
``architectures/<name>.py``, builds it and draws the pool), runs one
call, whose first three steps the check compares, and one more call.
The window then calls until ``--seconds`` have passed on the host's
clock and closes on a value read after the last call; the traced call
after it trains pool batches 0 .. K-1. What the check holds and how,
and what the traced call adds to the observations, are the
architecture's.

The same program and window run on a data mesh (``drivers/train_mesh.py``
starts the ranks): each process is a rank of ``ranks`` with its rows of
every global batch of ``ranks`` x ``batch_per_card`` and of each call's
noise, ``group`` its ranks' host group. There every rank synchronises
before rank 0 starts the clock, rank 0 tells the others after each call
whether the window has closed, rank 0 alone runs the profiler, and peak
memory is the fullest card's.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from benchmark import check, harness, inputs

CARDS = 1  # a run's cards
CHECKED_STEPS = 3


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pool_rows(cell, batches: int, rows: int, ranks: int, seed: int, device,
              mine: slice):
    """The pool of global batches of ``rows`` x ``ranks`` drawn from
    ``seed``: (this rank's rows ``mine`` of each, the global pool, on the
    ``meta`` device but its lengths where there are several ranks)."""
    pool = cell.arch.train_pool(cell, batches, rows * ranks, seed, device)
    if ranks == 1:
        return pool, pool
    local = {k: v[:, mine].clone() for k, v in pool.items()}
    shapes = {k: v if k.endswith("_lens") else v.to("meta")
              for k, v in pool.items()}
    return local, shapes


class Program:
    """The program under test, built and driven from the seed; rank
    ``rank`` of ``ranks`` on a data mesh, with its rows of each global
    batch and noise."""

    def __init__(self, cell, seed: int, device, rank: int = 0,
                 ranks: int = 1):
        t = cell.traffic
        self.cell, self.arch, self.device = cell, cell.arch, device
        self.B, self.K, self.P = (t["batch_per_card"], t["steps_per_call"],
                                  t["pool_batches"])
        if self.P % self.K or self.K <= CHECKED_STEPS:
            raise ValueError("pool_batches must be a multiple of "
                             "steps_per_call, which must be more than "
                             f"{CHECKED_STEPS}")
        self.seed_w, self.seed_in, self.seed_z = harness.seeds(seed, 3)
        self.config = harness.port_config(cell, self.B * ranks)
        self.state, self.frozen, self.multi, self.start = \
            self.arch.build_train(cell, self.config, self.seed_w, device,
                                  mesh=ranks > 1)
        self.ranks, self.rows = ranks, slice(rank * self.B,
                                             (rank + 1) * self.B)
        self.pool, self.shapes = pool_rows(cell, self.P, self.B, ranks,
                                           self.seed_in, device, self.rows)
        self.gen = torch.Generator(device=device).manual_seed(self.seed_z)
        self.calls = 0
        self.noise_shape = (self.K, *self.arch.noise_shape(cell,
                                                           self.B * ranks))

    def call(self, first=None):
        """One call of K steps on the next K batches of the pool (from
        batch ``first``, if given); returns (metrics, this rank's rows of
        the noise it used)."""
        a = (self.calls * self.K) % self.P if first is None else first
        batch = {k: v[a:a + self.K] for k, v in self.pool.items()}
        noise = torch.randn(self.noise_shape, generator=self.gen,
                            device=self.device)
        if self.ranks > 1:
            noise = noise[:, self.rows].contiguous()
        self.state, metrics = self.multi(self.state, self.frozen, batch,
                                         noise)
        self.calls += 1
        return metrics, noise

    def value(self, metrics) -> float:
        """The last step's value of the architecture's ``VALUE`` as a
        float: waits for the device."""
        return float(metrics[self.arch.VALUE][-1])

    def first_call(self):
        """The first call, under the architecture's ``Capture``; returns
        the program's readings (losses per checked step, first gradients,
        changes), what the reference is held to beside them (``seen``),
        the checked steps' batches and noise."""
        cap = self.arch.Capture(self.cell, self.state, self.start,
                                CHECKED_STEPS)
        try:
            metrics, noise = self.call()
            losses = [{k: float(v[j]) for k, v in metrics.items()}
                      for j in range(min(CHECKED_STEPS, self.K))]
        finally:
            cap.remove()
        self.start = None
        batches = [inputs.step_batch(self.pool, j, self.device)
                   for j in range(CHECKED_STEPS)]
        return (*cap.readings(losses), batches,
                noise[:CHECKED_STEPS].clone())

    def free(self) -> None:
        for name in ("state", "frozen", "multi", "pool", "shapes"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def checked_inputs(cell, seed: int, device, rank: int = 0, ranks: int = 1):
    """This rank's rows of what the program's first call draws from the
    seed for its checked steps: (weights' seed, batches, noise), as
    :class:`Program` draws them."""
    t = cell.traffic
    B = t["batch_per_card"]
    mine = slice(rank * B, (rank + 1) * B)
    seed_w, seed_in, seed_z = harness.seeds(seed, 3)
    pool, _ = pool_rows(cell, t["pool_batches"], B, ranks, seed_in, device,
                        mine)
    gen = torch.Generator(device=device).manual_seed(seed_z)
    noise = torch.randn((t["steps_per_call"], *cell.arch.noise_shape(
        cell, B * ranks)), generator=gen, device=device)
    if ranks > 1:
        noise = noise[:, mine]
    return (seed_w, [inputs.step_batch(pool, j, device)
                     for j in range(CHECKED_STEPS)],
            noise[:CHECKED_STEPS].clone())


def readings_of(cell, seed: int, device, kind: str = "program",
                rank: int = 0, ranks: int = 1):
    """(numbers, the run's readings and ``seen``, the reference's) of a
    sound run (``kind="program"``: the program's first call, without a
    window) or of a reading of the architecture's ``KINDS`` (on a mesh
    ``MESH_KINDS``) put in the program's place. On a mesh every rank
    calls it; rank 0's are the ones that count."""
    mesh = ranks > 1
    if kind == "program":
        prog = Program(cell, seed, device, rank, ranks)
        readings, seen, batches, noises = prog.first_call()
        seed_w = prog.seed_w
        prog.free()
    else:
        seed_w, batches, noises = checked_inputs(cell, seed, device, rank,
                                                 ranks)
        *readings, seen = cell.arch.reference_readings(
            cell, seed_w, batches, noises, device, kind, mesh=mesh)
    out, ref = cell.arch.numbers(cell, seed_w, readings, seen, batches,
                                 noises, device, mesh=mesh)
    return out, (*readings, seen), ref


def numbers_of(cell, seed: int, device, kind: str = "program"
               ) -> Dict[str, float]:
    """The check's numbers of :func:`readings_of`."""
    return readings_of(cell, seed, device, kind)[0]


def _gather(value, group) -> list:
    """``value`` of every rank of ``group`` (None: this process alone)."""
    if group is None:
        return [value]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value, group=group)
    return out


def _closed(flag: bool, group) -> bool:
    """Rank 0's ``flag`` on every rank of ``group``."""
    if group is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.broadcast(t, 0, group=group)
    return bool(t[0])


def run(cell, args, device, t_start: float, log,
        group=None) -> harness.Outcome:
    """The cell's run; on a data mesh every rank of ``group`` runs it,
    and rank 0's :class:`harness.Outcome` is the run's."""
    rank, ranks = ((0, 1) if group is None
                   else (dist.get_rank(), dist.get_world_size()))
    say = log if rank == 0 else (lambda msg: None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    prog = Program(cell, args.seed, device, rank, ranks)
    readings, seen, batches, noises = prog.first_call()
    m, _ = prog.call()  # the second call: nothing is new in the window
    prog.value(m)

    kept: List[Dict[str, torch.Tensor]] = []
    returns = []  # host clock as each call returns (the host runs ahead)
    _sync(device)
    if group is not None:
        dist.barrier(group=group)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    say(f"set-up {setup_s:.3f} s ({ranks} rank(s), B={prog.B} a card, "
        f"K={prog.K})")
    while True:
        m, _ = prog.call()
        kept.append(m)
        returns.append(time.perf_counter())
        if _closed(returns[-1] - t0 >= args.seconds, group):
            break
    prog.value(m)
    window_s = time.perf_counter() - t0
    gaps = np.diff([t0] + returns)
    say("host seconds per call: min %.4f median %.4f max %.4f" % (
        gaps.min(), np.median(gaps), gaps.max()))
    steps = len(kept) * prog.K
    bad = sum(int((~torch.isfinite(torch.stack(list(m.values())))).any(0)
                  .sum()) for m in kept)
    say(f"window {window_s:.3f} s, {len(kept)} calls, {steps} steps")
    e2e = {"train_images_per_s": steps * prog.B / window_s,
           "setup_s": setup_s}
    obs = {"kind": "train", "cell": cell, "steps_per_s": steps / window_s}

    summary = None
    if args.trace:
        from benchmark import trace

        if rank == 0:
            summary = trace.profile(lambda: prog.call(first=0),
                                    lambda: _sync(device), args.trace_file)
        else:
            _sync(device)
            prog.call(first=0)
            _sync(device)
        obs.update(trace=summary, traced_steps=prog.K,
                   peak_flops=harness.H100_BF16_FLOPS,
                   **cell.arch.traced_train(cell, prog.shapes, 0, prog.K,
                                            prog.B, ranks))
    peaks = _gather(torch.cuda.max_memory_allocated()
                    if device.type == "cuda" else 0, group)
    e2e["peak_mem_gib"] = max(peaks) / 2 ** 30
    seed_w = prog.seed_w
    prog.free()
    if group is not None:
        dist.barrier(group=group)

    found, _ = cell.arch.numbers(cell, seed_w, readings, seen, batches,
                                 noises, device, mesh=ranks > 1)
    held = _gather(harness.forbidden_modules(), group)
    return harness.Outcome(
        attempted=steps, failed=bad, end_to_end=e2e, observations=obs,
        peak_bytes=max(peaks),
        checks=check.checks(found, cell.settings["limits"]), trace=summary,
        modules=sorted({m for h in held[1:] for m in h}))
