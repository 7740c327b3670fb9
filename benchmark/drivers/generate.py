"""Traffic of kind ``generate``: a closed loop of one client asking the
program's sampling step (``training/steps.py::make_sample_step``) for
the images of batches of captions.

The traffic file gives ``batch`` (captions per request), ``pool``
(captions and attributes drawn once at set-up from the seed), ``warmup``
(requests before the window) and ``kept`` (requests whose images the
check keeps, a uniform sample of those the window completes, drawn from
the seed). A request draws its rows of the pool and its noise from the
seed; it starts when the host starts it and ends when its images are on
the host as uint8 (a copy into pinned memory). The window's rate is over
the host's clock; each request's latency over CUDA events. The cell's
architecture (``architectures/<name>.py``) builds the sampling call,
draws the pool, turns a request's rows into its images and holds the
check.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import check, harness
from benchmark.drivers.train import _sync

CARDS = 1  # a run's cards


class Program:
    def __init__(self, cell, seed: int, device):
        t = cell.traffic
        self.cell, self.arch, self.device = cell, cell.arch, device
        self.B, self.pool_rows = t["batch"], t["pool"]
        (self.seed_w, seed_pool, seed_req, seed_z,
         seed_keep) = harness.seeds(seed, 5)
        config = harness.port_config(cell, self.B)
        self.sample = self.arch.build_sampler(cell, config, self.seed_w,
                                              device)
        self.pool = self.arch.caption_pool(cell, self.pool_rows, seed_pool,
                                           device)
        self.rng = np.random.default_rng(seed_req)
        self.keep_rng = np.random.default_rng(seed_keep)
        self.gen = torch.Generator(device=device).manual_seed(seed_z)
        self.noise_shape = self.arch.noise_shape(cell, self.B)
        self.out = torch.empty(self.arch.image_shape(cell, self.B),
                               dtype=torch.uint8,
                               pin_memory=device.type == "cuda")

    def request(self):
        """One request, start to images on the host. Returns (its inputs:
        rows of the pool and noise, the uint8 images in the pinned
        buffer, its latency in seconds). The latency is read from CUDA
        events: the first is recorded as the host starts the request, on
        an idle device (the loop is closed), the last after the copy to
        the host; the host's clock is too coarse for one request."""
        start = end = None
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        rows = self.rng.choice(self.pool_rows, self.B, replace=False)
        idx = torch.from_numpy(rows)
        dev_idx = idx.to(self.device)
        noise = torch.randn(self.noise_shape, generator=self.gen,
                            device=self.device)
        self.out.copy_(self.arch.sample_images(self.sample, self.pool, idx,
                                               dev_idx, noise))
        if end is None:
            return (idx, noise), self.out, time.perf_counter() - t0
        end.record()
        end.synchronize()
        return (idx, noise), self.out, 1e-3 * start.elapsed_time(end)

    def free(self) -> None:
        self.sample = self.pool = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _program_images(cell, seed: int, device):
    """The first ``kept`` requests of a sound run, without a window:
    (weights' seed, pool, the requests' inputs, their images)."""
    prog = Program(cell, seed, device)
    kept = []
    for _ in range(cell.traffic["kept"]):
        (idx, noise), imgs, _ = prog.request()
        kept.append(((idx, noise.cpu()), imgs.numpy().copy()))
    pool, seed_w = prog.pool, prog.seed_w
    prog.free()
    return seed_w, pool, [r for r, _ in kept], [im for _, im in kept]


def _drawn_requests(cell, seed: int, device):
    """The weights' seed, pool and first ``kept`` requests' inputs that
    :class:`Program` draws from ``seed``."""
    t = cell.traffic
    seed_w, seed_pool, seed_req, seed_z, _ = harness.seeds(seed, 5)
    pool = cell.arch.caption_pool(cell, t["pool"], seed_pool, device)
    rng = np.random.default_rng(seed_req)
    gen = torch.Generator(device=device).manual_seed(seed_z)
    requests = []
    for _ in range(t["kept"]):
        idx = torch.from_numpy(rng.choice(t["pool"], t["batch"],
                                          replace=False))
        requests.append((idx, torch.randn(
            cell.arch.noise_shape(cell, t["batch"]), generator=gen,
            device=device)))
    return seed_w, pool, requests


def numbers_of(cell, seed: int, device, kind: str = "program"
               ) -> Dict[str, float]:
    """The check's numbers over the first ``kept`` requests of a sound run
    (``kind="program"``), or of one of the architecture's
    ``IMAGE_KINDS`` put in the program's place."""
    if kind == "program":
        seed_w, pool, requests, images = _program_images(cell, seed, device)
    else:
        seed_w, pool, requests = _drawn_requests(cell, seed, device)
        images = cell.arch.reference_images(cell, seed_w, pool, requests,
                                            device, kind)
    return cell.arch.image_numbers(cell, seed_w, pool, requests, images,
                                   device)


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values), q))


def run(cell, args, device, t_start: float, log) -> harness.Outcome:
    t = cell.traffic
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    prog = Program(cell, args.seed, device)
    for _ in range(t["warmup"]):
        prog.request()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (B={prog.B})")

    # Reservoir sample of ``kept`` requests of the window, from the seed.
    kept: List = []
    latencies: List[float] = []
    t0 = time.perf_counter()
    while True:
        (idx, noise), imgs, latency = prog.request()
        latencies.append(latency)
        n = len(latencies)
        slot = (n - 1 if n <= t["kept"]
                else int(prog.keep_rng.integers(0, n)))
        if slot < t["kept"]:
            entry = ((idx, noise.cpu()), imgs.numpy().copy())
            if slot < len(kept):
                kept[slot] = entry
            else:
                kept.append(entry)
        if time.perf_counter() - t0 >= args.seconds:
            break
    window_s = time.perf_counter() - t0
    n = len(latencies)
    log(f"window {window_s:.3f} s, {n} requests, latency ms: min "
        f"{1e3 * min(latencies):.3f} median "
        f"{1e3 * percentile(latencies, 50):.3f} max "
        f"{1e3 * max(latencies):.3f}")
    e2e = {"generate_images_per_s": n * prog.B / window_s,
           "generate_batch_ms_p95": 1e3 * percentile(latencies, 95),
           "setup_s": setup_s}
    obs = {"kind": "generate", "cell": cell, "requests_per_s": n / window_s}

    summary = None
    if args.trace:
        from benchmark import trace

        traced = t["traced_requests"]
        idxs = []

        def stretch():
            for _ in range(traced):
                (idx, _), _, _ = prog.request()
                idxs.append(idx)

        summary = trace.profile(stretch, lambda: _sync(device),
                                args.trace_file)
        obs.update(trace=summary, traced_requests=traced,
                   peak_flops=harness.H100_BF16_FLOPS,
                   **cell.arch.traced_generate(cell, prog.pool, idxs, prog.B))
    peak = (torch.cuda.max_memory_allocated()
            if device.type == "cuda" else 0)
    e2e["peak_mem_gib"] = peak / 2 ** 30
    pool, seed_w = prog.pool, prog.seed_w
    prog.free()

    numbers = cell.arch.image_numbers(cell, seed_w, pool,
                                      [r for r, _ in kept],
                                      [im for _, im in kept], device)
    return harness.Outcome(
        attempted=n, failed=0, end_to_end=e2e, observations=obs,
        peak_bytes=peak, checks=check.checks(numbers,
                                             cell.settings["limits"]),
        trace=summary)
