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
clock and closes on a value read after the last call. What the check
holds and how, and what the traced call adds to the observations, are
the architecture's.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import check, harness, inputs

CHECKED_STEPS = 3


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The program under test, built and driven from the seed."""

    def __init__(self, cell, seed: int, device):
        t = cell.traffic
        self.cell, self.arch, self.device = cell, cell.arch, device
        self.B, self.K, self.P = (t["batch_per_card"], t["steps_per_call"],
                                  t["pool_batches"])
        if self.P % self.K or self.K <= CHECKED_STEPS:
            raise ValueError("pool_batches must be a multiple of "
                             "steps_per_call, which must be more than "
                             f"{CHECKED_STEPS}")
        self.seed_w, self.seed_in, self.seed_z = harness.seeds(seed, 3)
        self.config = harness.port_config(cell, self.B)
        self.state, self.frozen, self.multi, self.start = \
            self.arch.build_train(cell, self.config, self.seed_w, device)
        self.pool = self.arch.train_pool(cell, self.P, self.B, self.seed_in,
                                         device)
        self.gen = torch.Generator(device=device).manual_seed(self.seed_z)
        self.calls = 0
        self.noise_shape = (self.K, *self.arch.noise_shape(cell, self.B))

    def call(self):
        """One call of K steps on the next K batches of the pool; returns
        (metrics, the noise it used)."""
        a = (self.calls * self.K) % self.P
        batch = {k: v[a:a + self.K] for k, v in self.pool.items()}
        noise = torch.randn(self.noise_shape, generator=self.gen,
                            device=self.device)
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
        for name in ("state", "frozen", "multi", "pool"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def checked_inputs(cell, seed: int, device):
    """What the program's first call draws from the seed for its checked
    steps: (weights' seed, batches, noise), as :class:`Program` draws
    them."""
    t = cell.traffic
    seed_w, seed_in, seed_z = harness.seeds(seed, 3)
    pool = cell.arch.train_pool(cell, t["pool_batches"], t["batch_per_card"],
                                seed_in, device)
    gen = torch.Generator(device=device).manual_seed(seed_z)
    noise = torch.randn((t["steps_per_call"], *cell.arch.noise_shape(
        cell, t["batch_per_card"])), generator=gen, device=device)
    return (seed_w, [inputs.step_batch(pool, j, device)
                     for j in range(CHECKED_STEPS)],
            noise[:CHECKED_STEPS].clone())


def readings_of(cell, seed: int, device, kind: str = "program"):
    """(numbers, the run's readings, the reference's) of a sound run
    (``kind="program"``: the program's first call, without a window) or
    of a reading of the architecture's ``KINDS`` put in the program's
    place."""
    if kind == "program":
        prog = Program(cell, seed, device)
        readings, seen, batches, noises = prog.first_call()
        seed_w = prog.seed_w
        prog.free()
    else:
        seed_w, batches, noises = checked_inputs(cell, seed, device)
        *readings, seen = cell.arch.reference_readings(
            cell, seed_w, batches, noises, device, kind)
    out, ref = cell.arch.numbers(cell, seed_w, readings, seen, batches,
                                 noises, device)
    return out, readings, ref[:3]


def numbers_of(cell, seed: int, device, kind: str = "program"
               ) -> Dict[str, float]:
    """The check's numbers of :func:`readings_of`."""
    return readings_of(cell, seed, device, kind)[0]


def run(cell, args, device, t_start: float, log) -> harness.Outcome:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    prog = Program(cell, args.seed, device)
    readings, seen, batches, noises = prog.first_call()
    m, _ = prog.call()  # the second call: nothing is new in the window
    prog.value(m)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (B={prog.B}, K={prog.K})")

    kept: List[Dict[str, torch.Tensor]] = []
    returns = []  # host clock as each call returns (the host runs ahead)
    _sync(device)
    t0 = time.perf_counter()
    while True:
        m, _ = prog.call()
        kept.append(m)
        returns.append(time.perf_counter())
        if returns[-1] - t0 >= args.seconds:
            break
    prog.value(m)
    window_s = time.perf_counter() - t0
    gaps = np.diff([t0] + returns)
    log("host seconds per call: min %.4f median %.4f max %.4f" % (
        gaps.min(), np.median(gaps), gaps.max()))
    steps = len(kept) * prog.K
    bad = sum(int((~torch.isfinite(torch.stack(list(m.values())))).any(0)
                  .sum()) for m in kept)
    log(f"window {window_s:.3f} s, {len(kept)} calls, {steps} steps")
    e2e = {"train_images_per_s": steps * prog.B / window_s,
           "setup_s": setup_s}
    obs = {"kind": "train", "cell": cell, "steps_per_s": steps / window_s}

    summary = None
    if args.trace:
        from benchmark import trace

        a = (prog.calls * prog.K) % prog.P
        summary = trace.profile(lambda: prog.call(), lambda: _sync(device),
                                args.trace_file)
        obs.update(trace=summary, traced_steps=prog.K,
                   peak_flops=harness.H100_BF16_FLOPS,
                   **cell.arch.traced_train(cell, prog.pool, a, prog.K,
                                            prog.B))
    peak = (torch.cuda.max_memory_allocated()
            if device.type == "cuda" else 0)
    e2e["peak_mem_gib"] = peak / 2 ** 30
    seed_w = prog.seed_w
    prog.free()

    found, _ = cell.arch.numbers(cell, seed_w, readings, seen, batches,
                                 noises, device)
    return harness.Outcome(
        attempted=steps, failed=bad, end_to_end=e2e, observations=obs,
        peak_bytes=peak, checks=check.checks(found, cell.settings["limits"]),
        trace=summary)
