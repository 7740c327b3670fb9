"""Traffic of kind ``generate``: a closed loop of one client asking the
program's sampling step (``training/steps.py::make_sample_step``) for
the 256² images of batches of captions.

The traffic file gives ``batch`` (captions per request), ``pool``
(captions and attributes drawn once at set-up from the seed), ``warmup``
(requests before the window) and ``kept`` (requests whose images the
check keeps, a uniform sample of those the window completes, drawn from
the seed). A request draws its rows of the pool and its noise from the
seed; it starts when the host starts it and ends when its images are on
the host as uint8 (a copy into pinned memory). The window's rate is over
the host's clock; each request's latency over CUDA events.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import check, harness, inputs, weights
from benchmark.drivers.train import _sync, reference_nets
from benchmark.reference import eegan, steps as ref_steps

PARTS = ("generator", "attr_enhance", "text_encoder")


def draw_weights(cell, seed: int, device):
    return weights.make(reference_nets(cell, "meta", parts=PARTS), seed,
                        device)


class Program:
    def __init__(self, cell, seed: int, device):
        from eegan_tpu_torch.models.factory import build_models
        from eegan_tpu_torch.training.steps import make_sample_step

        t = cell.traffic
        self.cell, self.device, self.B = cell, device, t["batch"]
        (self.seed_w, seed_pool, seed_req, seed_z,
         seed_keep) = harness.seeds(seed, 5)
        config = harness.port_config(cell, self.B)
        self.models = build_models(config, cell.config["n_words"],
                                   device=device)
        w = draw_weights(cell, self.seed_w, device)
        weights.load(self.models.generator, w["generator"])
        weights.load(self.models.attr_enhance, w["attr_enhance"])
        weights.load(self.models.text_encoder, w["text_encoder"])
        del w
        self.sample = make_sample_step(config, self.models)
        host = inputs.captions(cell.model, cell.config["n_words"],
                               (t["pool"],),
                               np.random.default_rng(seed_pool))
        self.pool = {k: torch.from_numpy(v) if k.endswith("_lens")
                     else torch.from_numpy(v).to(device)
                     for k, v in host.items()}
        self.rng = np.random.default_rng(seed_req)
        self.keep_rng = np.random.default_rng(seed_keep)
        self.gen = torch.Generator(device=device).manual_seed(seed_z)
        self.z_dim = cell.model["GAN"]["Z_DIM"]
        size = cell.model["TREE"]["BASE_SIZE"] * 2 ** (
            cell.model["TREE"]["BRANCH_NUM"] - 1)
        self.out = torch.empty((self.B, size, size, 3), dtype=torch.uint8,
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
        rows = self.rng.choice(len(self.pool["caps"]), self.B, replace=False)
        idx = torch.from_numpy(rows)
        dev_idx = idx.to(self.device)
        noise = torch.randn((self.B, self.z_dim), generator=self.gen,
                            device=self.device)
        imgs = self.sample(self.pool["caps"][dev_idx],
                           self.pool["cap_lens"][idx],
                           self.pool["attrs"][dev_idx],
                           self.pool["attr_lens"][idx], noise)
        self.out.copy_(ref_steps.to_uint8(imgs[-1]))
        if end is None:
            return (idx, noise), self.out, time.perf_counter() - t0
        end.record()
        end.synchronize()
        return (idx, noise), self.out, 1e-3 * start.elapsed_time(end)

    def free(self) -> None:
        self.models = self.sample = self.pool = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_images(cell, seed_w: int, pool, requests, device, quant=None):
    """The reference's uint8 images of each kept request."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nets = reference_nets(cell, device, quant, parts=PARTS)
    w = draw_weights(cell, seed_w, device)
    for key, net in nets.items():
        weights.load(net, w[key])
    del w
    out = []
    for idx, noise in requests:
        dev_idx = idx.to(device)
        img = ref_steps.sample(nets, cell.model, pool["caps"][dev_idx],
                               pool["cap_lens"][idx], pool["attrs"][dev_idx],
                               pool["attr_lens"][idx], noise.to(device))
        out.append(ref_steps.to_uint8(img).cpu().numpy())
    return out


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
    host = inputs.captions(cell.model, cell.config["n_words"], (t["pool"],),
                           np.random.default_rng(seed_pool))
    pool = {k: torch.from_numpy(v) if k.endswith("_lens")
            else torch.from_numpy(v).to(device) for k, v in host.items()}
    rng = np.random.default_rng(seed_req)
    gen = torch.Generator(device=device).manual_seed(seed_z)
    requests = []
    for _ in range(t["kept"]):
        idx = torch.from_numpy(rng.choice(t["pool"], t["batch"],
                                          replace=False))
        requests.append((idx, torch.randn(
            (t["batch"], cell.model["GAN"]["Z_DIM"]), generator=gen,
            device=device)))
    return seed_w, pool, requests


def numbers_of(cell, seed: int, device, kind: str = "program"
               ) -> Dict[str, float]:
    """The check's number over the first ``kept`` requests of a sound run
    (``kind="program"``), of the reference in float8 put in the
    program's place (``"control"``), or of the float32 reference whose
    first image of each answer takes the second row's noise
    (``"altered"``)."""
    if kind == "program":
        seed_w, pool, requests, images = _program_images(cell, seed, device)
        ref = reference_images(cell, seed_w, pool, requests, device)
        return {"image_gap": check.image_gap(images, ref)}
    seed_w, pool, requests = _drawn_requests(cell, seed, device)
    ref = reference_images(cell, seed_w, pool, requests, device)
    if kind == "altered":
        moved = []
        for idx, noise in requests:
            noise = noise.clone()
            noise[0] = noise[1]
            moved.append((idx, noise))
        other = reference_images(cell, seed_w, pool, moved, device)
    elif kind == "control":
        other = reference_images(cell, seed_w, pool, requests, device,
                                 quant=eegan.fp8_round)
    else:
        raise ValueError(f"no reading {kind!r} of a generate cell")
    return {"image_gap": check.image_gap(other, ref)}


def sample_ops(cell, batch: int) -> int:
    """Operations of the reference's sampling of one request, counted on
    the ``meta`` device."""
    from benchmark.opcount import OpCounter

    meta = torch.device("meta")
    nets = reference_nets(cell, meta, parts=PARTS)
    t = cell.model["TEXT"]
    caps = torch.ones((batch, t["WORDS_NUM"]), dtype=torch.int64,
                      device=meta)
    lens = torch.full((batch,), t["WORDS_NUM"], dtype=torch.int64)
    attrs = torch.ones((batch, t["MAX_ATTR_NUM"], t["MAX_ATTR_LEN"]),
                       dtype=torch.int64, device=meta)
    attr_lens = torch.full((batch, t["MAX_ATTR_NUM"]), t["MAX_ATTR_LEN"])
    noise = torch.empty((batch, cell.model["GAN"]["Z_DIM"]), device=meta)
    with OpCounter() as counter:
        ref_steps.sample(nets, cell.model, caps, lens, attrs, attr_lens,
                         noise)
    return counter.total


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
        traced_batches = []

        def stretch():
            for _ in range(traced):
                (idx, _), _, _ = prog.request()
                traced_batches.append(
                    dict(rows=prog.B,
                         cap_lens=prog.pool["cap_lens"][idx].tolist()))

        summary = trace.profile(stretch, lambda: _sync(device),
                                args.trace_file)
        elem = torch.empty((), dtype=getattr(
            torch, cell.settings["runtime"]["COMPUTE_DTYPE"])).element_size()
        obs.update(trace=summary, traced_requests=traced,
                   traced_batches=traced_batches,
                   affine=dict(B=prog.B, ngf=cell.model["GAN"]["GF_DIM"],
                               elem=elem),
                   ops_per_request=sample_ops(cell, prog.B),
                   peak_flops=harness.H100_BF16_FLOPS)
    peak = (torch.cuda.max_memory_allocated()
            if device.type == "cuda" else 0)
    e2e["peak_mem_gib"] = peak / 2 ** 30
    pool, seed_w = prog.pool, prog.seed_w
    prog.free()

    ref = reference_images(cell, seed_w, pool, [r for r, _ in kept], device)
    numbers = {"image_gap": check.image_gap([im for _, im in kept], ref)}
    return harness.Outcome(
        attempted=n, failed=0, end_to_end=e2e, observations=obs,
        peak_bytes=peak, checks=check.checks(numbers,
                                             cell.settings["limits"]),
        trace=summary)
