#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``eegan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits non-zero and prints no ``ok`` line):

1. environment: torch/CUDA versions and the card's name and power limit;
2. build every CUDA source of the port with nvcc (all started together),
   in a thread beside phase 15's DAMSM step parity, which launches no
   kernel;
3. the affine forward against its plain PyTorch version on the card, at
   the shapes the sampling path (B=8, cfg/sample_bird.yml widths) and the
   train step (B=32, cfg/bird.yml) give it, at ragged shapes with every
   input/output dtype pair and with misaligned operands: float32 out within
   1e-5, bfloat16 out within one bf16 ulp (rtol = atol = 8e-3), bitwise the
   same in two launches; the ReLU zeros at float32 out that differ from the
   plain version's are counted;
4. the sampling step (text encoder -> AttrEnhance -> Generator) at full
   width (cfg/sample_bird.yml, GF_DIM=48, B=8, RUNTIME.PALLAS_AFFINE=true)
   with random weights and BN running stats from a seed: float32 on cuda
   (TF32 off) launches the affine kernel 14 times and matches the same step
   on the CPU (plain version) within 1e-3; bfloat16 on cuda gives finite
   images in [-1, 1];
5. the sampling CLI (``python -m eegan_tpu_torch.sample --from_code``) on a
   caption corpus written here with the port's own builder; the PNGs exist;
6. times (CUDA events, warm-up, median of 25; L2 flushed before each kernel
   launch): each kernel launch of one generator forward beside its bound,
   its plain version and the library call (none here); the sampling step
   at B=8 in bfloat16 with the kernel on and off;
7. where that step's time goes: each module's span on the device, the
   device's busy time per step and its kernels by time (torch.profiler),
   and the peak device memory.

The training slice (cfg/bird.yml: GF_DIM=DF_DIM=32, 200 classes,
RUNTIME.PALLAS_AFFINE=true, RUNTIME.PALLAS_DAMSM=true), run before the
sampling phases:

8. the affine backward kernel, through the autograd Function, against
   autograd of the plain version at the 14 sites of one generator forward
   (B=32, float32 and bf16) and at C = 8, 16, 24, 37, 40 and 512 with every
   dtype pair: all six gradients, and bitwise the same in two launches;
9. the DAMSM forward, dR and dW kernels against the plain version and its
   autograd at (Bi, Bt, S, L, D) = (32, 32, 289, 20, 256), (5, 3, 37, 7, 64),
   (4, 4, 289, 20, 256) with a class mask, and (16, 32, 289, 20, 256) (a
   rank's rows under a two-rank mesh); dW exactly 0 at padded words;
   all three also at shapes that stress their per-pair split (an odd Bi,
   Bt = 1, L = 1, every text at full length, one-word texts beside full
   ones, L = 32, a text with no valid word), and bitwise the same in two
   launches; the sims within 1e-3 + 1e-4 relative, the gradients within
   1e-4 of each case's largest |gradient| plus 2e-3 relative;
10. the float32 train step on cuda (TF32 off) against the same step on the
   CPU, full width, B=4, same weights, batch and noise: metrics, updated
   parameters and the kernel launches per step (14 / 14 / 1 / 1 / 0); then
   from the same start under deterministic algorithms, the step with
   kernels 1-2 on, off and on again: every tensor's Adam moments of each
   optimizer, (b) on against off within 10 times (c) the rerun's distance
   plus 1e-4 (PERF.md §2), (a) against the CPU step reported, the ten
   tensors nearest their bar printed;
11. the bf16 train step at B=32: a few steps with finite metrics and the
   same launches per step;
12. times of the affine forward and backward and the DAMSM kernels at the
   step's shapes (L2 flushed) beside their bounds and plain versions; the
   bf16 step at B=32 in three rounds;
13. that step's device busy time, idle share, top device operations and
   peak memory (torch.profiler).

The trainer slice, run after phase 13 (cfg/bird.yml, B=32, bf16, both
kernel families on):

14. ``Trainer`` in-process on a demo corpus written by the port's
   ``data/demo_corpus.py`` (576 images, 384 for training: one epoch of 12
   iterations, 8 spawned data workers): images/s (``StepTimer``, its
   window opened after a synchronise, iterations 3-12), the
   host's wait on the pipeline per step, kernel launches per iteration
   (14 / 14 / 1 / 1 / 0) and per ``save_images`` (14 of kernel 1),
   checkpoint save time and size; then a second ``Trainer`` on the same
   directory resumes at epoch 2 with the same step and bitwise-equal Adam
   moments and takes 5 finite steps, the last 3 traced by the trainer's
   own profiler (``profile_steps``): the device's busy time per iteration
   and its idle share;
15. the CLIs as subprocesses: ``pretrain_damsm --synthetic`` (full width,
   2 iterations), then ``train --synthetic`` with TEXT.DAMSM_NAME at its
   output (the directory branch); and a float32 DAMSM pretraining step
   on cuda (TF32 off) against the CPU step: metrics within 1e-3
   relative; the gradients Adam took (from its moments) within 1e-3
   relative L2 (5e-2 at the worst tensor) and the parameters within
   PERF.md §2's bar for an Adam step, for the text encoder, the image
   encoder's heads and its Inception trunk with cuDNN, and for the whole
   image encoder in a second cuda step with cuDNN off; then the trunk's
   gradients against the same step in float64 on the CPU, within twice
   the CPU float32 step's distance with cuDNN, without it, and with the
   convs and batch norms in an explicit autograd Function (cuDNN on for
   every kind, then off for one kind at a time); reported: the trunk with
   its padded average pools in channels_last memory (PyTorch's CUDA
   backward of that pool is wrong), and four convs' float32 passes; the
   Inception's pool's input gradient within 1e-6 of float64.

The evaluation slice, run after phase 15's CLIs in phase 14's directory
(the demo corpus and the trainer's ``Model/netG_1.pth``):

16. ``Tester.generate`` in float32 on cuda against the CPU (cfg/bird.yml
   at full width, 16 images): the images within 1e-3, the image codes and
   similarities within 1e-3 relative, the R-precision hits equal where
   the top two similarities differ by more than 1e-3, kernel 1 launched
   14 times per batch, and ``FIDExtractor.features`` within 1e-3 of the
   largest feature; the sweep at B=32 in bf16 (images/s without and with
   PNG writes, launches per batch, one batch's device busy time and idle
   share), FID feature and IS probability images/s and the IS fine-tune
   step's ms; the CLIs as subprocesses (``test`` with 1024 images and
   R-precision, and with 64 over ``--set RUNTIME.MESH=data:2``,
   ``fid_score --dataset_npz`` then its ``Epoch_1_0`` sweep,
   ``finetune_inception`` then ``inception_score --is_classifier``,
   ``sample --from_dataset --model_dir``); and a Trainer of two epochs
   whose epoch-1 snapshot an ``AsyncEvaluator`` scores (FID,
   R-precision) while epoch 2 trains.

Training at scale, run last (cfg/bird.yml, both kernel families on):

17. REMAT: the float32 step (TF32 off, B=4) with RUNTIME.REMAT, REMAT_D
   and REMAT_IMAGE_ENCODER on against the same step with them off, from
   the same weights, batch and noise: metrics within 1e-6 + 1e-3
   relative, each optimizer's Adam moments within 1e-3 relative L2, the
   BN running stats within 1e-6 and moved once (num_batches_tracked 1),
   and kernel 1 launched 14 + 2 x 7 times (again in the backward for each
   recomputed SAGB block); bf16 step ms and peak memory at B=32 with REMAT
   off and on (3 timed steps each), with REMAT and
   REMAT_BLOCKS=4,5,6,cum and with REMAT_IMAGE_ENCODER alone (one timed
   step each), and at B=192 with REMAT on;
18. the data-parallel path: two gloo ranks on the one card (float32, TF32
   off, global B=8, 4 per rank) take one mesh step, held against the
   single-process step at B=8 on the card (metrics, Adam moments within
   1e-3, parameters and BN running stats at phase 10's bars) with the
   same kernel launches per rank; then ``python -m eegan_tpu_torch.train
   --distributed`` as one NCCL rank (EEGAN_NUM_PROCESSES=1) for a few
   iterations on phase 14's corpus, started after phase 14 and run beside
   the CLIs and the parity check of phases 15-16 (its images/s is
   printed, but is not a rate);
19. FSDP: the same two gloo ranks at ``data:1,fsdp:2`` (the large
   parameters, their Adam moments and EMA sharded over the ranks) take
   one step from phase 18's weights, batch and noise, held against the
   single-process step at phase 18's bars and against phase 18's data:2
   ranks (metrics within 1e-6 relative, Adam moments within 1e-5 relative
   L2, parameters and BN stats within 1e-6 but for at most 0.01% of each
   module's entries), with the same kernel launches per rank, beside a
   second run of the data:2 ranks (the card's own spread); each rank's
   state at rest (``torch.cuda.memory_allocated`` and the state's own
   bytes, sharded and replicated leaves) against a data:2 rank's.

The learning probes, run last (GF_DIM = DF_DIM = 16, B = 32, float32,
kernels 1-4 on through EEGAN_PROBE_PAFFINE=1 EEGAN_PROBE_UPFUSE=1 and
RUNTIME.PALLAS_DAMSM):

20. each probe's own ``main`` at a few steps: the colour probe
   (``eegan_tpu_torch.validate_learning``: 20 DAMSM steps, 40 GAN steps,
   one probe), the words probe's two arms (``validate_words --pallas 1``,
   20 steps each), the R-precision gate (``validate_rprecision``: 6 GAN
   steps, then the ``test`` CLI's sweep of 64 images per epoch as a
   subprocess on cuda) and the IS fine-tune check
   (``validate_is_finetune``, 10 steps); per GAN step ms (host clock,
   synchronised), device busy (torch.profiler over 3 more steps) and
   kernel launches (14 / 14 / 1 / 1 / 0; the off arm 14 / 14 / 0 / 0 / 0),
   every loss finite, each probe's result dict; under PyTorch's default
   TF32 settings, as the probes' CLIs run; then phase 10's moment check
   at the colour probe's configuration (B=32, float32) from its state
   before the first GAN step and after the last, with its own batch and
   noise, RUNTIME.FUSED_UPSAMPLE on and off.

Evaluation over the mesh, run last:

21. two gloo ranks on the one card (``Tester(mesh=...)``) against one
   process, on phase 14's corpus and epoch-1 snapshot, float32, TF32 off:
   a sweep of 256 images at B=32 with PNGs and R-precision (images, codes
   and similarities within 1e-3 of their largest, hits equal but at near
   ties, 14 launches of kernel 1 per rank per batch, the PNG folders the
   same files within one level), the sweep's images/s on the two ranks
   without and with PNGs (both ranks share the card: not a scaling
   figure); one IS fine-tune step at global B=32
   (``make_finetune_step(mesh=...)``) at PERF.md §2's bars, beside the
   card's rerun spread and the step's float64 distance, and the same step
   in float64 on the ranks against one process (gradients within 1e-5
   relative L2 over the network and in each tensor); and the ``test``
   CLI with ``--set RUNTIME.MESH=data:2`` as a subprocess on cuda (run
   with phase 16's CLIs).

The benchmark entry point, run last and alone on the card:

22. the benchmark's count of one step at GF_DIM=4, B=4 the same on the
   card and on the CPU; ``python -m eegan_tpu_torch.bench`` as a
   subprocess with short windows (EEGAN_BENCH_WINDOWS=1, ITERS=1, SCAN=2, BEST=0; the matmul
   calibration on): its last line has the root bench.py's keys and
   ``gpu``, ``power_limit_w``, ``n_cards``, ``peak_memory_mib``, a finite
   ``value`` > 0 and ``mfu`` in (0, 1.05), and kernels 3 and 4 launched
   once in the step it counted; the line is printed.

Each phase's seconds are printed as it ends, and all of them with the
run's total on a JSON line before the last three. The last lines are one
JSON ``kernels`` line, the card's name and power limit as nvidia-smi
prints them, and ``{"ok": true, "device": {...}}``;
the JSON lines before them hold the steps' times and the breakdowns'
summaries. Every launch's times, the profiles' operation lists and the
checks' errors go to the JSON file that ``--out`` names
(``build/chip_smoke.json`` by default). Imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
BATCH = 8
N_WORDS = 5450  # the CUB caption vocabulary size (AttnGAN captions.pickle)
SEED = 1234
REPS = 25
WARMUP = 5
SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's clock


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


_BACKGROUND = []


def background(proc):
    """Register a subprocess that runs while this script goes on: it is
    killed at exit if it is still running (a failed phase exits early)."""
    if not _BACKGROUND:
        import atexit

        atexit.register(_stop_background)
    _BACKGROUND.append(proc)
    return proc


def _stop_background() -> None:
    for proc in _BACKGROUND:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


class Stopwatch:
    """Each phase's seconds, logged as it ends, and the run's total."""

    def __init__(self):
        self.start = time.perf_counter()
        self.seconds = {}

    def __call__(self, name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.seconds[name] = time.perf_counter() - t0
        log(f"{name}: {self.seconds[name]:.1f} s (at "
            f"{self.total():.1f} s)")
        return out

    def total(self) -> float:
        return time.perf_counter() - self.start


def start_build():
    """Phase 2 in a thread: every CUDA source through nvcc, all started
    together (``_build.build``), while the main thread runs a phase that
    launches no kernel. :func:`finish_build` waits for it."""
    import threading

    from eegan_tpu_torch.ops import _build

    job = {}

    def run():
        t0 = time.perf_counter()
        try:
            job["built"] = _build.build(_build.sources())
        except Exception as e:  # raised again by finish_build
            job["error"] = e
        job["seconds"] = time.perf_counter() - t0

    job["thread"] = threading.Thread(target=run, daemon=True)
    job["thread"].start()
    return job


def finish_build(job):
    job["thread"].join()
    if "error" in job:
        fail(f"phase 2: the build failed: {job['error']}")
    for lib_name, path in job["built"].items():
        ptxas = [ln.strip() for ln in path.with_suffix(".log").read_text()
                 .splitlines() if "registers" in ln]
        log(f"phase 2 ok: built {lib_name} -> {path.name} in "
            f"{job['seconds']:.1f} s; ptxas: {ptxas[:6]}")
    return job["seconds"]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def kernel_counters():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from eegan_tpu_torch.ops import affine, damsm

    return {"affine_mask_relu": affine.affine_mask_relu,
            "affine_mask_relu_backward": affine.affine_mask_relu_backward,
            "words_similarity_forward": damsm.words_similarity_forward,
            "words_similarity_backward_dr": damsm.words_similarity_backward_dr,
            "words_similarity_backward_dw":
                damsm.words_similarity_backward_dw}


def read_counts():
    return {k: fn.launches for k, fn in kernel_counters().items()}


def set_counts(counts):
    for k, fn in kernel_counters().items():
        fn.launches = counts[k]


def launches_of(**nonzero):
    """The counts of a run that launched only the named kernels, so often."""
    return {k: nonzero.get(k, 0) for k in kernel_counters()}


def zero_counts():
    set_counts(launches_of())


def affine_launch_shapes(ngf: int):
    """(site, C, h, w, up) of every affine_mask_relu launch in one generator
    forward with FUSED_UPSAMPLE on: affine1 of an up block normalises the
    PRE-upsample input and writes 2x the resolution."""
    chans = [ngf * 8] * 4 + [ngf * 4, ngf * 2, ngf]
    shapes, in_ch, res = [], ngf * 8, 4
    for i, out_ch in enumerate(chans):
        up = i > 0
        shapes.append((f"block{i}.affine1", in_ch, res, res, up))
        res = 2 * res if up else res
        shapes.append((f"block{i}.affine2", out_ch, res, res, False))
        in_ch = out_ch
    return shapes


def affine_operands(B, C, h, w, up, dtype, gen):
    import torch

    H, W = (2 * h, 2 * w) if up else (h, w)
    dev = "cuda"
    x = torch.randn((B, C, h, w), generator=gen, device=dev).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    mean = 0.1 * torch.randn((C,), generator=gen, device=dev)
    var = 0.5 + torch.rand((C,), generator=gen, device=dev)
    gamma = (0.3 * torch.randn((B, C), generator=gen, device=dev)).to(dtype)
    beta = (0.3 * torch.randn((B, C), generator=gen, device=dev)).to(dtype)
    mask = torch.rand((B, 1, H, W), generator=gen, device=dev).to(dtype)
    return x, mean, var, gamma, beta, mask


def affine_bytes(ops, out_dtype, up) -> int:
    import torch

    x = ops[0]
    B, C, h, w = x.shape
    n_out = B * C * h * w * (4 if up else 1)
    return (sum(t.numel() * t.element_size() for t in ops)
            + n_out * torch.empty((), dtype=out_dtype).element_size())


def time_cuda(fn, flush) -> float:
    """Median ms of ``fn()`` over REPS launches, each timed by CUDA events
    with the L2 cache flushed before it. A spin kernel of about 1 ms runs
    between the flush and the start event: the host enqueues ``fn`` while
    the device spins, so the time is the device's and not the host's
    launch latency."""
    import torch

    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_host(fn, reps: int = REPS) -> float:
    """Median ms of ``fn()`` by the host clock, synchronised, after
    warm-up (for whole steps)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def misaligned_copy(t):
    """A copy of ``t`` in the same memory format whose data starts one
    element past a 16-byte boundary (a view into a larger buffer)."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    if t.dim() == 4 and t.shape[1] > 1:  # NCHW in channels_last memory
        B, C, H, W = t.shape
        v = buf[1:].view(B, H, W, C).permute(0, 3, 1, 2)
    else:
        v = buf[1:].view(t.shape)
    return v.copy_(t)


def phase_kernel_vs_plain(ngf: int, train_ngf: int, probe):
    import torch

    from eegan_tpu_torch.ops.affine import (
        affine_mask_relu,
        affine_mask_relu_reference,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    saved = read_counts()
    # The paths' shapes (sampling B=8, train step B=32, the probes'
    # (GF_DIM, B) = ``probe``) with the path's dtype pairs (in = out); the
    # ragged shapes (C not a multiple of the vector width, C / vec above
    # 256 lanes) with every pair; x and mask one element off a 16-byte
    # boundary (the vector width 1 path, a mask copy).
    cases = [(site, BATCH, C, h, w, up, dt, dt, False)
             for site, C, h, w, up in affine_launch_shapes(ngf)
             for dt in (f32, bf16)]
    cases += [(f"train {site}", TRAIN_BATCH, C, h, w, up, dt, dt, False)
              for site, C, h, w, up in affine_launch_shapes(train_ngf)
              for dt in (f32, bf16)]
    cases += [(f"probe {site}", probe[1], C, h, w, up, dt, dt, False)
              for site, C, h, w, up in affine_launch_shapes(probe[0])
              for dt in (f32, bf16)]
    cases += [("ragged", B, C, h, w, up, dt_in, dt_out, False)
              for B, C, h, w, up in ((3, 40, 5, 7, False), (3, 40, 5, 7, True),
                                     (2, 37, 3, 5, True), (3, 8, 5, 7, False),
                                     (2, 511, 3, 5, False),
                                     (2, 511, 3, 5, True))
              for dt_in in (f32, bf16) for dt_out in (f32, bf16)]
    cases += [("misaligned", 3, 64, 6, 5, up, dt, dt, True)
              for up in (False, True) for dt in (f32, bf16)]
    worst = {f32: 0.0, bf16: 0.0}
    zeros_differ = 0  # ReLU zeros of the kernel not the plain version's
    for site, B, C, h, w, up, dt_in, dt_out, off in cases:
        ops = affine_operands(B, C, h, w, up, dt_in, gen)
        if off:
            ops = (misaligned_copy(ops[0]), *ops[1:5],
                   misaligned_copy(ops[5]))
        got = affine_mask_relu(*ops, up, 1e-5, dt_out)
        again = affine_mask_relu(*ops, up, 1e-5, dt_out)
        want = affine_mask_relu_reference(*ops, up, 1e-5, dt_out)
        torch.cuda.synchronize()
        what = f"affine {site} {tuple(ops[0].shape)} up={up} {dt_in}->{dt_out}"
        if got.shape != want.shape or got.dtype != dt_out:
            fail(f"{what}: got {tuple(got.shape)} {got.dtype}")
        if not got.is_contiguous(memory_format=torch.channels_last):
            fail(f"{what}: output not channels_last")
        if not torch.equal(got, again):
            fail(f"{what}: differs between two launches on the same inputs")
        err = (got.float() - want.float()).abs()
        tol = 1e-5 if dt_out == f32 else 8e-3 + 8e-3 * want.float().abs()
        if not bool((err <= tol).all()):
            fail(f"{what}: max abs err {float(err.max())}")
        worst[dt_out] = max(worst[dt_out], float(err.max()))
        if dt_out == f32:
            zeros_differ += int(((got == 0) != (want == 0)).sum())
        del ops, got, again, want, err
    set_counts(saved)  # comparison launches are not the path's
    log(f"phase 3 ok: affine_mask_relu matches its plain version in "
        f"{len(cases)} cases (sampling B={BATCH}, train B={TRAIN_BATCH}, "
        f"probe GF_DIM={probe[0]} B={probe[1]}, ragged, misaligned), bitwise the same in two launches; max abs "
        f"err f32 out {worst[f32]}, bf16 out {worst[bf16]}; ReLU zeros that "
        f"differ from the plain version's at float32 out: {zeros_differ}")
    return worst[f32], worst[bf16], zeros_differ


def slice_config(dtype: str, pallas: bool = True):
    from eegan_tpu_torch.config import apply_overrides, fresh_config

    config = fresh_config(os.path.join(ROOT, "cfg", "sample_bird.yml"))
    apply_overrides(config, [f"RUNTIME.PALLAS_AFFINE={str(pallas).lower()}",
                             f"RUNTIME.COMPUTE_DTYPE={dtype}"])
    return config


def slice_models(config, device):
    from eegan_tpu_torch.models.factory import build_models, randomize_

    models = build_models(config, N_WORDS, device)
    for i, m in enumerate((models.generator, models.attr_enhance,
                           models.text_encoder)):
        randomize_(m, SEED + i)
    return models


def slice_inputs(config):
    import torch

    t = config.TEXT
    gen = torch.Generator().manual_seed(SEED)
    caps = torch.randint(1, N_WORDS, (BATCH, t.WORDS_NUM), generator=gen)
    cap_lens = torch.randint(1, t.WORDS_NUM + 1, (BATCH,), generator=gen)
    caps = caps * (torch.arange(t.WORDS_NUM)[None] < cap_lens[:, None])
    attrs = torch.randint(1, N_WORDS, (BATCH, t.MAX_ATTR_NUM, t.MAX_ATTR_LEN),
                          generator=gen)
    attr_lens = torch.randint(0, t.MAX_ATTR_LEN + 1,
                              (BATCH, t.MAX_ATTR_NUM), generator=gen)
    attrs = attrs * (torch.arange(t.MAX_ATTR_LEN) < attr_lens[..., None])
    noise = torch.randn((BATCH, config.GAN.Z_DIM), generator=gen)
    return caps, cap_lens, attrs, attr_lens, noise


def phase_slice(ngf_expected: int):
    import torch

    from eegan_tpu_torch.models.generator import AffineSSA
    from eegan_tpu_torch.training.steps import make_sample_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = slice_config("float32")
    if config.GAN.GF_DIM != ngf_expected:
        fail(f"cfg/sample_bird.yml GF_DIM={config.GAN.GF_DIM}")
    inputs = slice_inputs(config)
    gpu = slice_models(config, "cuda")
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append(
            (tuple(args[0].shape[1:]), mod.up)))
        for m in gpu.generator.modules() if isinstance(m, AffineSSA)]
    step = make_sample_step(config, gpu)

    zero_counts()
    imgs = step(*inputs)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["affine_mask_relu"]
    for h in hooks:
        h.remove()
    if counts != launches_of(affine_mask_relu=14):
        fail(f"the float32 sampling step launched {counts}, expected "
             f"affine_mask_relu 14 times and nothing else")
    want_shapes = [((C, h, w), up) for _, C, h, w, up
                   in affine_launch_shapes(config.GAN.GF_DIM)]
    if sorted(seen) != sorted(want_shapes):
        fail(f"affine shapes on the path {seen} != {want_shapes}")

    cpu = slice_models(config, "cpu")
    zero_counts()
    imgs_cpu = make_sample_step(config, cpu)(*inputs)
    if read_counts() != launches_of():
        fail("the CPU run launched a CUDA kernel")
    errs = []
    for scale, a, b in zip((64, 128, 256), imgs, imgs_cpu):
        if tuple(a.shape) != (BATCH, scale, scale, 3) or a.shape != b.shape:
            fail(f"img{scale} shape {tuple(a.shape)} vs {tuple(b.shape)}")
        err = float((a.cpu() - b).abs().max())
        if not err <= 1e-3:
            fail(f"img{scale}: cuda vs cpu max abs err {err} > 1e-3")
        errs.append(err)
    spread = float(imgs[-1].std())

    config_bf16 = slice_config("bfloat16")
    gpu_bf16 = slice_models(config_bf16, "cuda")
    step_bf16 = make_sample_step(config_bf16, gpu_bf16)
    zero_counts()
    imgs_bf16 = step_bf16(*inputs)
    torch.cuda.synchronize()
    counts = read_counts()
    launches_bf16 = counts["affine_mask_relu"]
    if counts != launches_of(affine_mask_relu=14):
        fail(f"the bfloat16 sampling step launched {counts}, expected "
             f"affine_mask_relu 14 times and nothing else")
    for scale, img in zip((64, 128, 256), imgs_bf16):
        if tuple(img.shape) != (BATCH, scale, scale, 3):
            fail(f"bf16 img{scale} shape {tuple(img.shape)}")
        if not bool(torch.isfinite(img).all()) or float(img.abs().max()) > 1:
            fail(f"bf16 img{scale} not finite or outside [-1, 1]")
    bf16_vs_f32 = float((imgs_bf16[-1] - imgs[-1]).abs().max())
    log(f"phase 4 ok: sampling step GF_DIM={config.GAN.GF_DIM} B={BATCH}: "
        f"{launches} kernel launches (f32), {launches_bf16} (bf16); cuda vs "
        f"cpu max abs err {errs} (img256 std {spread}); bf16 finite, "
        f"max |bf16 - f32| img256 {bf16_vs_f32}")
    return dict(launches=launches, launches_bf16=launches_bf16,
                cuda_vs_cpu_max_abs_err=errs, img256_std=spread,
                bf16_vs_f32_img256=bf16_vs_f32), (step_bf16, gpu_bf16, inputs)


def phase_cli():
    import pickle

    from eegan_tpu_torch.data.prep import build_captions_pickle
    from eegan_tpu_torch.sample import EXAMPLE_CAPTIONS

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(os.path.join(data, "text"))
        names = [f"img_{i}" for i in range(len(EXAMPLE_CAPTIONS))]
        for name, cap in zip(names, EXAMPLE_CAPTIONS):
            with open(os.path.join(data, "text", f"{name}.txt"), "w") as f:
                f.write(cap + "\n")
        for split, split_names in (("train", names[:-1]), ("test", names[-1:])):
            os.makedirs(os.path.join(data, split))
            with open(os.path.join(data, split, "filenames.pickle"), "wb") as f:
                pickle.dump(split_names, f, protocol=2)
        build_captions_pickle(data, 1)
        out = os.path.join(tmp, "out")
        cmd = [sys.executable, "-m", "eegan_tpu_torch.sample", "--from_code",
               "--device", "cuda", "--noise_times", "2",
               "--set", "RUNTIME.PALLAS_AFFINE=true",
               "--set", "RUNTIME.ALLOW_RANDOM_ENCODERS=true",
               "--set", f"DATA_DIR={data}", "--set", f"SAVE_DIR={out}"]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            fail(f"sampling CLI exit {proc.returncode}:\n{proc.stdout}\n"
                 f"{proc.stderr}")
        vis = os.path.join(out, "example_bird")
        for i in range(len(EXAMPLE_CAPTIONS)):
            for png in ("samples.png", "sample_0.png", "sample_1.png"):
                path = os.path.join(vis, f"cap_{i}", png)
                if not os.path.isfile(path) or os.path.getsize(path) == 0:
                    fail(f"sampling CLI did not write {path}")
    log("phase 5 ok: sampling CLI wrote cap_{0,1,2}/samples.png + singles")


def phase_times(ngf: int, step_bf16, models_bf16, inputs):
    import torch

    from eegan_tpu_torch.models.generator import AffineSSA
    from eegan_tpu_torch.ops.affine import (
        affine_mask_relu,
        affine_mask_relu_reference,
    )

    dt = torch.bfloat16
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = []
    counted = read_counts()
    for site, C, h, w, up in affine_launch_shapes(ngf):
        ops = affine_operands(BATCH, C, h, w, up, dt, gen)
        ms = time_cuda(lambda: affine_mask_relu(*ops, up, 1e-5, dt), flush)
        plain_ms = time_cuda(
            lambda: affine_mask_relu_reference(*ops, up, 1e-5, dt), flush)
        bound_ms = affine_bytes(ops, dt, up) / HBM_BYTES_PER_S * 1e3
        rows.append(dict(site=site, shape=[BATCH, C, h, w], up=up,
                         dtype="bfloat16", ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms))
    set_counts(counted)  # timing launches are not the path's

    pallas_mods = [m for m in models_bf16.generator.modules()
                   if isinstance(m, AffineSSA)]

    def set_pallas(on):
        for m in pallas_mods:
            m.pallas = on

    step_ms = {"kernel": [], "plain": []}
    for arm in ("kernel", "plain", "plain", "kernel"):
        set_pallas(arm == "kernel")
        step_ms[arm].append(time_host(lambda: step_bf16(*inputs)))
    set_pallas(True)
    set_counts(counted)
    step = {arm: statistics.mean(v) for arm, v in step_ms.items()}
    log(f"phase 6 ok: kernel {sum(r['ms'] for r in rows)} ms per forward "
        f"(bound {sum(r['bound_ms'] for r in rows)} ms); sampling step bf16 "
        f"B={BATCH}: {step}")
    return rows, step, step_ms


def phase_breakdown(step_bf16, models_bf16, inputs, step_ms: float):
    """Where one bf16 sampling step's time goes: each module's span on the
    device (CUDA events recorded by forward hooks), the peak device memory,
    and from a torch.profiler trace of a few steps the device's busy time
    per step and its kernels by time."""
    import torch

    spans = {}
    hooks = []
    for name in ("text_encoder", "attr_enhance", "generator"):
        def pre(mod, args, name=name):
            spans.setdefault(name, []).append(
                [torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True)])
            spans[name][-1][0].record()

        def post(mod, args, out, name=name):
            spans[name][-1][1].record()

        mod = getattr(models_bf16, name)
        hooks += [mod.register_forward_pre_hook(pre),
                  mod.register_forward_hook(post)]
    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARMUP + REPS):
        step_bf16(*inputs)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    module_ms = {name: statistics.median(a.elapsed_time(b)
                                         for a, b in evs[WARMUP:])
                 for name, evs in spans.items()}
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    result = dict(module_device_span_ms=module_ms, peak_memory_mib=peak_mib,
                  **profile_steps(lambda: step_bf16(*inputs), 5, step_ms))
    busy_ms = result["device_busy_ms_per_step"]
    n_ops = result["device_ops_per_step"]
    log(f"phase 7 ok: bf16 step module spans {module_ms} ms; device busy "
        f"{busy_ms} ms of a {step_ms} ms step "
        f"({n_ops} device ops per step); peak {peak_mib} MiB")
    return result


def profile_steps(run_step, steps: int, step_ms: float):
    """torch.profiler over ``steps`` calls of ``run_step``: the device's
    busy time per step (union of its operations' intervals), its idle
    share against the untraced ``step_ms``, its operations by time, and
    the host operations (with their input shapes) whose launches took the
    most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / steps
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for e in sorted(device, key=lambda e: e.time_range.start):
        start = max(e.time_range.start, end)
        if e.time_range.end > start:
            busy_us += e.time_range.end - start
        end = max(end, e.time_range.end)
    by_name = {}
    for e in device:
        n_us = by_name.setdefault(e.name, [0, 0.0])
        n_us[0] += 1
        n_us[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    busy_ms = busy_us / 1e3 / steps if device else None
    by_shape = sorted(prof.key_averages(group_by_input_shape=True),
                      key=lambda e: -e.self_device_time_total)[:12]
    return dict(
        profiled_steps=steps, traced_step_ms=traced_ms,
        device_busy_ms_per_step=busy_ms,
        device_ops_per_step=len(device) / steps,
        idle_share_vs_untraced_step=(None if busy_ms is None
                                     else 1.0 - busy_ms / step_ms),
        top_device_ops=[dict(name=n[:96], per_step=c / steps,
                             ms_per_step=us / 1e3 / steps)
                        for n, (c, us) in top],
        top_host_ops_by_device_time=[
            dict(name=e.key, input_shapes=str(e.input_shapes)[:160],
                 per_step=e.count / steps,
                 device_ms_per_step=e.self_device_time_total / 1e3 / steps)
            for e in by_shape])

# ---------------------------------------------------------------------------
# The training slice: kernels 2-5 and the train step (cfg/bird.yml)
# ---------------------------------------------------------------------------

FP32_FLOP_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
TRAIN_BATCH = 32  # cfg/bird.yml TRAIN.BATCH_SIZE
PARITY_BATCH = 4  # the float32 cuda-vs-CPU step
BF16_STEPS = 3
# (Bi, Bt, S, L, D); the last is a rank's rows of the words loss under a
# two-rank mesh at B=32 (phase 18's path at cfg/bird.yml's batch).
DAMSM_SHAPES = ((32, 32, 289, 20, 256), (5, 3, 37, 7, 64),
                (4, 4, 289, 20, 256), (16, 32, 289, 20, 256))
# The forward, dR and dW at shapes that stress their per-pair split (an odd
# Bi, one text, one word, every text at full length, one-word texts beside
# full ones, L = 32, a text with no valid word), with the lengths ("full",
# "mixed", "empty" or random).
DR_STRESS = (((7, 5, 289, 20, 256), None), ((5, 1, 289, 20, 256), None),
             ((3, 4, 37, 1, 64), None), ((4, 6, 289, 20, 256), "full"),
             ((6, 6, 289, 20, 256), "mixed"), ((3, 3, 289, 32, 256), None),
             ((5, 4, 289, 20, 256), "empty"))


def bird_config(dtype: str):
    from eegan_tpu_torch.config import apply_overrides, fresh_config

    config = fresh_config(os.path.join(ROOT, "cfg", "bird.yml"))
    apply_overrides(config, ["RUNTIME.PALLAS_AFFINE=true",
                             "RUNTIME.PALLAS_DAMSM=true",
                             f"RUNTIME.COMPUTE_DTYPE={dtype}"])
    return config


def affine_grads(fn, ops, up, out_dtype, dy):
    """(dx, dmean, dvar, dgamma, dbeta, dmask) of sum(fn(ops) * dy)."""
    import torch

    leaves = [t.detach().requires_grad_(True) for t in ops]
    return torch.autograd.grad(fn(*leaves, up, 1e-5, out_dtype), leaves, dy)


def phase_affine_backward(ngf: int, probe):
    """(a) kernel 2, through the autograd Function, against autograd of
    the plain version: the 14 sites of one generator forward at B=32 and
    at the probes' (GF_DIM, B) = ``probe`` (their widest reduction: C=16
    over 32·256² elements) in float32 and bf16, and ragged shapes; a
    second launch on the same inputs gives the same bits."""
    import torch

    from eegan_tpu_torch.ops.affine import (
        affine_mask_relu,
        affine_mask_relu_backward,
        affine_mask_relu_reference,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    cases = [(site, TRAIN_BATCH, C, h, w, up, dt, dt)
             for site, C, h, w, up in affine_launch_shapes(ngf)
             for dt in (f32, bf16)]
    cases += [(f"probe {site}", probe[1], C, h, w, up, dt, dt)
              for site, C, h, w, up in affine_launch_shapes(probe[0])
              for dt in (f32, bf16)]
    # Ragged C (37) and C not a multiple of the 32 lanes (40, 8, 16, 24),
    # and the largest C the kernel takes (512), with every dtype pair.
    cases += [("ragged", B, C, h, w, up, dt_in, dt_out)
              for B, C, h, w, up in ((3, 40, 5, 7, False), (3, 40, 5, 7, True),
                                     (2, 37, 3, 5, True), (3, 8, 5, 7, False),
                                     (3, 16, 5, 7, True), (3, 24, 5, 7, False),
                                     (2, 512, 4, 4, True),
                                     (2, 512, 6, 5, False))
              for dt_in in (f32, bf16) for dt_out in (f32, bf16)]
    names = ("dx", "dmean", "dvar", "dgamma", "dbeta", "dmask")
    worst = {}
    saved = read_counts()
    for site, B, C, h, w, up, dt_in, dt_out in cases:
        ops = affine_operands(B, C, h, w, up, dt_in, gen)
        H, W = (2 * h, 2 * w) if up else (h, w)
        dy = torch.randn((B, C, H, W), generator=gen, device="cuda").to(
            dt_out).contiguous(memory_format=torch.channels_last)
        got = affine_grads(affine_mask_relu, ops, up, dt_out, dy)
        want = affine_grads(affine_mask_relu_reference, ops, up, dt_out, dy)
        again = affine_mask_relu_backward(*ops, dy, up, 1e-5)
        torch.cuda.synchronize()
        what = f"affine bwd {site} {(B, C, h, w)} up={up} {dt_in}->{dt_out}"
        for name, g, a in zip(names, got, again):
            if not torch.equal(g, a):
                fail(f"{what}: {name} differs between two launches on the "
                     f"same inputs")
        for name, g, wv, t in zip(names, got, want, ops):
            if g.shape != t.shape or g.dtype != t.dtype:
                fail(f"{what}: {name} {tuple(g.shape)} {g.dtype}, input "
                     f"{tuple(t.shape)} {t.dtype}")
            err = (g.float() - wv.float()).abs()
            scale = float(wv.float().abs().max())
            if g.dtype == bf16:
                tol = 8e-3 * wv.float().abs() + 1e-4 * scale + 1e-6
            elif name == "dx":
                tol = 1e-5 + 1e-5 * wv.float().abs()
            else:  # sums over channels or over up to B*H*W elements
                tol = 1e-4 * scale + 1e-6
            if not bool((err <= tol).all()):
                fail(f"{what}: {name} max abs err {float(err.max())} "
                     f"(scale {scale})")
            key = f"{name}_{str(g.dtype).split('.')[-1]}"
            worst[key] = max(worst.get(key, 0.0), float(err.max()))
    set_counts(saved)  # comparison launches are not the path's
    log(f"phase 8 ok: affine backward matches autograd of its plain version "
        f"in {len(cases)} cases, bitwise the same in two launches; max abs "
        f"err {worst}")
    return worst


def damsm_operands(Bi, Bt, S, L, D, gen, lens=None):
    import torch

    regions = torch.randn((Bi, S, D), generator=gen, device="cuda")
    words = torch.randn((Bt, L, D), generator=gen, device="cuda")
    if lens is None:
        lens = torch.randint(min(3, L), L + 1, (Bt,), generator=gen,
                             device="cuda")
    words = words * (torch.arange(L, device="cuda")[None, :, None]
                     < lens[:, None, None])
    cls = torch.randint(0, 2, (Bt,), generator=gen, device="cuda")
    return regions, words, lens, cls


def phase_damsm_kernels():
    """(b) kernels 3-5 against the plain version and its autograd: each
    kernel directly (a random upstream dsim) at every shape, and the words
    loss through the autograd Function (with a class mask on the last);
    then all three at the shapes of DR_STRESS, twice, bitwise the same."""
    import torch

    from eegan_tpu_torch.losses.damsm import words_loss
    from eegan_tpu_torch.ops.damsm import (
        words_loss_fused,
        words_similarity_backward_dr,
        words_similarity_backward_dw,
        words_similarity_forward,
        words_similarity_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    saved = read_counts()
    worst = {"sims": 0.0, "d_regions": 0.0, "d_words": 0.0}
    # The largest error over the largest |gradient| of its case.
    worst_rel = {"d_regions": 0.0, "d_words": 0.0}

    def check_grad(what, name, g, wv):
        """g within 1e-4 of the case's largest |gradient| (at most 2e-4)
        plus 2e-3 relative: a gradient of the train shape peaks near 2e-3,
        so a fixed 2e-4 would pass a wrong sum. The kernels' errors reach
        about a fifth of the 1e-4 (NVIDIA H100 80GB HBM3, 700 W)."""
        err = (g - wv).abs()
        scale = float(wv.abs().max())
        if g.shape != wv.shape or not bool(
                (err <= min(2e-4, 1e-4 * scale) + 2e-3 * wv.abs()).all()):
            fail(f"{what}: {name} max abs err {float(err.max())} (scale "
                 f"{scale})")
        worst[name] = max(worst[name], float(err.max()))
        worst_rel[name] = max(worst_rel[name], float(err.max()) / scale)

    def check_grads(what, got, want, lens, L):
        for name, g, wv in zip(("d_regions", "d_words"), got, want):
            check_grad(what, name, g, wv)
        pad = torch.arange(L, device="cuda")[None, :] >= lens[:, None]
        if not bool((got[1][pad] == 0).all()):
            fail(f"{what}: dW not exactly zero at padded words")

    def check_sims(what, got, want):
        err = (got - want).abs()
        if got.shape != want.shape or not bool(
                (err <= 1e-3 + 1e-4 * want.abs()).all()):
            fail(f"{what}: sims max abs err {float(err.max())}")
        worst["sims"] = max(worst["sims"], float(err.max()))

    for (Bi, Bt, S, L, D), use_cls in zip(DAMSM_SHAPES,
                                          (False, False, True, False)):
        regions, words, lens, cls = damsm_operands(Bi, Bt, S, L, D, gen)
        what = f"damsm {(Bi, Bt, S, L, D)}"
        got = words_similarity_forward(regions, words, lens)
        r = regions.detach().requires_grad_(True)
        w = words.detach().requires_grad_(True)
        want = words_similarity_reference(r, w, lens)
        torch.cuda.synchronize()
        check_sims(what, got, want.detach())

        dsim = torch.randn((Bi, Bt), generator=gen, device="cuda") / Bi
        got = (words_similarity_backward_dr(regions, words, lens, dsim),
               words_similarity_backward_dw(regions, words, lens, dsim))
        check_grads(what, got, torch.autograd.grad(want, (r, w), dsim),
                    lens, L)
        if Bi != Bt:
            continue  # the losses contrast a square grid
        class_ids = cls if use_cls else None
        grads = []
        for loss_fn in (words_loss_fused, words_loss):
            r = regions.detach().requires_grad_(True)
            w = words.detach().requires_grad_(True)
            l0, l1 = loss_fn(r, w, lens, class_ids, 5.0, 5.0, 10.0)
            grads.append(torch.autograd.grad(l0 + 0.7 * l1, (r, w)))
        torch.cuda.synchronize()
        check_grads(f"{what} words loss class_mask={use_cls}", *grads, lens,
                    L)
    for (Bi, Bt, S, L, D), kind in DR_STRESS:
        lens = None
        if kind == "full":
            lens = torch.full((Bt,), L, device="cuda")
        elif kind == "mixed":
            lens = torch.tensor([1, L] * (Bt // 2) + [1] * (Bt % 2),
                                device="cuda")
        elif kind == "empty":
            lens = torch.tensor([0, L] + [max(1, L // 3)] * (Bt - 2),
                                device="cuda")
        regions, words, lens, _ = damsm_operands(Bi, Bt, S, L, D, gen, lens)
        dsim = torch.randn((Bi, Bt), generator=gen, device="cuda") / Bi
        sims = words_similarity_forward(regions, words, lens)
        sims_again = words_similarity_forward(regions, words, lens)
        got = (words_similarity_backward_dr(regions, words, lens, dsim),
               words_similarity_backward_dw(regions, words, lens, dsim))
        again = (words_similarity_backward_dr(regions, words, lens, dsim),
                 words_similarity_backward_dw(regions, words, lens, dsim))
        r = regions.detach().requires_grad_(True)
        w = words.detach().requires_grad_(True)
        want_sims = words_similarity_reference(r, w, lens)
        want = torch.autograd.grad(want_sims, (r, w), dsim)
        torch.cuda.synchronize()
        what = f"damsm {(Bi, Bt, S, L, D)} lengths {kind or 'random'}"
        check_sims(what, sims, want_sims.detach())
        if not torch.equal(sims, sims_again):
            fail(f"{what}: sims differ between two launches on the same "
                 f"inputs")
        check_grads(what, got, want, lens, L)
        for name, g, a in zip(("dR", "dW"), got, again):
            if not torch.equal(g, a):
                fail(f"{what}: {name} differs between two launches on the "
                     f"same inputs")
    set_counts(saved)
    log(f"phase 9 ok: DAMSM kernels match the plain version at "
        f"{DAMSM_SHAPES} and at "
        f"{[(s, k or 'random') for s, k in DR_STRESS]}, bitwise the same "
        f"in two launches there; max abs err {worst}, over the case's "
        f"largest |gradient| {worst_rel}; padded words get dW == 0")
    return dict(worst, **{f"{k}_over_scale": v for k, v in worst_rel.items()})


def train_models(config, device, state_dicts=None):
    """The bird.yml bundle on ``device``: random weights from the seed, or
    the given state dicts (module name -> state dict)."""
    from eegan_tpu_torch.models.factory import build_models, randomize_

    models = build_models(config, N_WORDS, device)
    mods = {"generator": models.generator,
            "attr_enhance": models.attr_enhance,
            "text_encoder": models.text_encoder,
            "image_encoder": models.image_encoder,
            **{f"disc_{i}": d for i, d in enumerate(models.discriminators)}}
    for i, (name, m) in enumerate(mods.items()):
        if state_dicts is None:
            randomize_(m, SEED + 100 + i)
        else:
            m.load_state_dict(state_dicts[name])
    return models, mods


def train_inputs(config, batch_size, seed):
    import numpy as np

    from eegan_tpu_torch.data.synthetic import synthetic_batch

    batch = synthetic_batch(config, batch_size, seed=seed, n_words=N_WORDS)
    noise = np.random.RandomState(seed).randn(
        batch_size, config.GAN.Z_DIM).astype(np.float32)
    return batch, noise


def metric_errors(got, want, what: str):
    """|got - want| of each metric; fails beyond 1e-6 + 1e-3 relative."""
    if set(got) != set(want):
        fail(f"{what}: metrics {sorted(got)} vs {sorted(want)}")
    err = {}
    for k in want:
        g, w = float(got[k]), float(want[k])
        err[k] = abs(g - w)
        if not err[k] <= 1e-6 + 1e-3 * abs(w):
            fail(f"{what}: metric {k} {g} vs {w}; all "
                 f"{ {m: (float(got[m]), float(v)) for m, v in want.items()} }")
    return err


def adam_param_errors(config, got, want):
    """Parameters after one train step (module name -> state dict) against
    another run's. Adam's first update moves an entry by about lr *
    sign(g), so an entry whose gradient is near 0 may land up to 2 lr
    away. A discriminator takes a second Adam update (MAGP), whose size is
    at most lr * sqrt(1 + B2) (v-hat holds at least g2^2 / (1 + B2)), so
    its entries may land up to 2 lr (1 + sqrt(1 + B2)) away. Besides, at
    most 1% of the entries may differ by more than lr / 100. Running stats
    (a forward only) within 1e-4. Returns (errors by module, modules out
    of bounds)."""
    param_err, bad = {}, []
    tr = config.TRAIN
    for name in ("generator", "attr_enhance", "disc_0", "disc_1", "disc_2"):
        if name.startswith("disc"):
            lr = tr.DISCRIMINATOR_LR
            bar = 2 * lr * (1 + math.sqrt(1 + tr.B2)) + 1e-6
        else:
            lr = tr.GENERATOR_LR
            bar = 2 * lr + 1e-6
        got_sd, want_sd = got[name], want[name]
        n = n_off = 0
        worst = worst_stat = 0.0
        worst_key = None
        for k, want_v in want_sd.items():
            if k.endswith("num_batches_tracked"):
                if int(got_sd[k]) != int(want_v):
                    bad.append(f"{name}.{k}")
                continue
            err = (got_sd[k].cpu().float() - want_v.cpu().float()).abs()
            if "running_" in k:
                worst_stat = max(worst_stat, float(err.max()))
                continue
            n += err.numel()
            n_off += int((err > lr / 100).sum())
            if float(err.max()) > worst:
                worst, worst_key = float(err.max()), k
        param_err[name] = dict(max_abs_err=worst, worst=worst_key,
                               bar=bar, off_lr100=n_off, n=n,
                               running_stats_max_abs_err=worst_stat)
        if worst > bar or n_off > 0.01 * n or worst_stat > 1e-4:
            bad.append(name)
    return param_err, bad


def phase_train_parity():
    """(c) the float32 train step on cuda against the same step on the CPU
    (TF32 off), full width, B=4, same weights, batch and noise; kernel
    launches per step."""
    import torch

    from eegan_tpu_torch.training.state import create_train_state
    from eegan_tpu_torch.training.steps import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = bird_config("float32")
    cpu, cpu_mods = train_models(config, "cpu")
    sds = {k: {n: v.clone() for n, v in m.state_dict().items()}
           for k, m in cpu_mods.items()}
    gpu, gpu_mods = train_models(config, "cuda", sds)
    batch, noise = train_inputs(config, PARITY_BATCH, SEED)

    state, frozen = create_train_state(config, gpu)
    start = state_snapshot(state, "cuda")
    step = make_train_step(config, gpu)
    zero_counts()
    state, metrics = step(state, frozen, batch, noise)
    torch.cuda.synchronize()
    launches = read_counts()
    want_launches = launches_of(affine_mask_relu=14,
                                affine_mask_relu_backward=14,
                                words_similarity_forward=1,
                                words_similarity_backward_dr=1)
    if launches != want_launches:
        fail(f"float32 train step launches {launches}, expected "
             f"{want_launches}")

    t0 = time.perf_counter()
    cstate, cfrozen = create_train_state(config, cpu)
    cstate, cmetrics = make_train_step(config, cpu)(cstate, cfrozen, batch,
                                                    noise)
    cpu_s = time.perf_counter() - t0
    if read_counts() != launches:
        fail("the CPU train step launched a CUDA kernel")

    metric_err = metric_errors(metrics, cmetrics, "train step, cuda vs cpu")
    param_err, bad = adam_param_errors(
        config, {k: m.state_dict() for k, m in gpu_mods.items()},
        {k: m.state_dict() for k, m in cpu_mods.items()})
    if bad:
        fail(f"train step params cuda vs cpu out of bounds in {bad}: "
             f"{param_err}")
    state_restore(state, start)
    moments = affine_switch_check("phase 10", step, state, frozen, batch,
                                  noise, reference=named_moments(cstate))
    log(f"phase 10 ok: float32 train step (bird.yml, B={PARITY_BATCH}) on "
        f"cuda matches the CPU step: max metric err "
        f"{max(metric_err.values())}, params {param_err}; launches "
        f"{launches}; CPU step {cpu_s:.1f} s; kernels 1-2 on against off "
        f"within the bar in every tensor's moments")
    return dict(launches=launches, metric_max_abs_err=metric_err,
                params=param_err, cpu_step_s=cpu_s,
                errG_total=float(metrics["errG/total"]), moments=moments)


def phase_train_bf16():
    """(d) the bf16 train step at B=32, full width: a few steps with finite
    metrics and the path's launches per step."""
    import torch

    from eegan_tpu_torch.training.state import create_train_state
    from eegan_tpu_torch.training.steps import make_train_step

    config = bird_config("bfloat16")
    models, _ = train_models(config, "cuda")
    state, frozen = create_train_state(config, models)
    step = make_train_step(config, models)
    batch, noise = train_inputs(config, TRAIN_BATCH, SEED + 1)
    dev_batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    for k in ("cap_lens", "unpair_cap_lens", "attr_lens"):
        dev_batch[k] = torch.from_numpy(batch[k])  # host: the packed RNN
    noise = torch.from_numpy(noise).cuda()
    per_step, history = [], []
    for _ in range(BF16_STEPS):
        zero_counts()
        state, metrics = step(state, frozen, dev_batch, noise)
        torch.cuda.synchronize()
        per_step.append(read_counts())
        values = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in values.items() if not math.isfinite(v)]
        if bad:
            fail(f"bf16 train step: non-finite metrics {bad}")
        history.append(values)
    want = launches_of(affine_mask_relu=14, affine_mask_relu_backward=14,
                       words_similarity_forward=1,
                       words_similarity_backward_dr=1)
    if any(c != want for c in per_step):
        fail(f"bf16 train step launches per step {per_step}, expected "
             f"{want}")
    log(f"phase 11 ok: bf16 train step bird.yml B={TRAIN_BATCH}: "
        f"{BF16_STEPS} steps, finite metrics (errG/total "
        f"{[h['errG/total'] for h in history]}), launches per step {want}")
    return dict(launches_per_step=want, metrics=history), \
        (step, state, frozen, dev_batch, noise)


def affine_bwd_bytes(ops, dy) -> int:
    """The backward reads the six inputs and dy once and writes one
    gradient of each input's size and dtype."""
    return (2 * sum(t.numel() * t.element_size() for t in ops)
            + dy.numel() * dy.element_size())


def phase_train_times(ngf: int, train):
    """(e) kernels 1-5 at the train step's shapes (L2 flushed) beside their
    bounds and plain versions, and the bf16 train step at B=32."""
    import torch

    from eegan_tpu_torch.ops import damsm
    from eegan_tpu_torch.ops.affine import (
        affine_mask_relu,
        affine_mask_relu_backward,
        affine_mask_relu_reference,
    )

    dt = torch.bfloat16
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    saved = read_counts()
    rows, fwd_rows = [], []
    for site, C, h, w, up in affine_launch_shapes(ngf):
        ops = affine_operands(TRAIN_BATCH, C, h, w, up, dt, gen)
        H, W = (2 * h, 2 * w) if up else (h, w)
        # Kernel 1 at the train step's shapes, beside the backward.
        fwd_rows.append(dict(
            site=site, shape=[TRAIN_BATCH, C, h, w], up=up, dtype="bfloat16",
            ms=time_cuda(lambda: affine_mask_relu(*ops, up, 1e-5, dt), flush),
            plain_ms=time_cuda(lambda: affine_mask_relu_reference(
                *ops, up, 1e-5, dt), flush),
            bound_ms=affine_bytes(ops, dt, up) / HBM_BYTES_PER_S * 1e3))
        dy = torch.randn((TRAIN_BATCH, C, H, W), generator=gen,
                         device="cuda").to(dt).contiguous(
                             memory_format=torch.channels_last)
        ms = time_cuda(lambda: affine_mask_relu_backward(*ops, dy, up, 1e-5),
                       flush)
        leaves = [t.detach().requires_grad_(True) for t in ops]
        out = affine_mask_relu_reference(*leaves, up, 1e-5, dt)
        plain_ms = time_cuda(lambda: torch.autograd.grad(
            out, leaves, dy, retain_graph=True), flush)
        rows.append(dict(site=site, shape=[TRAIN_BATCH, C, h, w], up=up,
                         dtype="bfloat16", ms=ms, plain_ms=plain_ms,
                         bound_ms=affine_bwd_bytes(ops, dy)
                         / HBM_BYTES_PER_S * 1e3))
        del out, leaves

    Bi, Bt, S, L, D = DAMSM_SHAPES[0]
    regions, words, lens, _ = damsm_operands(Bi, Bt, S, L, D, gen)
    dsim = torch.randn((Bi, Bt), generator=gen, device="cuda")
    r = regions.detach().requires_grad_(True)
    w = words.detach().requires_grad_(True)
    plain = damsm.words_similarity_reference(r, words, lens)
    plain_w = damsm.words_similarity_reference(regions, w, lens)
    # The kernels' own products, over the valid words only (a padded word's
    # attention is 0 and its cosine is masked out; ops/damsm.py).
    ops = {kind: damsm.words_similarity_ops(kind, Bi, Bt, S, L, D, lens)
           for kind in ("forward", "dr", "dw")}
    damsm_rows = {
        "words_similarity_forward": dict(
            ms=time_cuda(lambda: damsm.words_similarity_forward(
                regions, words, lens), flush),
            plain_ms=time_cuda(lambda: damsm.words_similarity_reference(
                regions, words, lens), flush),
            flop=ops["forward"]),
        "words_similarity_backward_dr": dict(
            ms=time_cuda(lambda: damsm.words_similarity_backward_dr(
                regions, words, lens, dsim), flush),
            plain_ms=time_cuda(lambda: torch.autograd.grad(
                plain, r, dsim, retain_graph=True), flush),
            flop=ops["dr"]),
        "words_similarity_backward_dw": dict(
            ms=time_cuda(lambda: damsm.words_similarity_backward_dw(
                regions, words, lens, dsim), flush),
            plain_ms=time_cuda(lambda: torch.autograd.grad(
                plain_w, w, dsim, retain_graph=True), flush),
            flop=ops["dw"]),
    }
    for row in damsm_rows.values():
        row["bound_ms"] = row["flop"] / FP32_FLOP_PER_S * 1e3
        row["shape"] = [Bi, Bt, S, L, D]
        row["valid_words"] = int(lens.sum())
    del plain, plain_w
    set_counts(saved)

    step, state, frozen, batch, noise = train
    # Three rounds of 10 steps: their spread says how far a change of the
    # step time is noise.
    step_runs = [time_host(lambda: step(state, frozen, batch, noise), reps=10)
                 for _ in range(3)]
    step_ms = statistics.median(step_runs)
    set_counts(saved)
    log(f"phase 12 ok: affine forward {sum(x['ms'] for x in fwd_rows)} ms "
        f"per step (bound {sum(x['bound_ms'] for x in fwd_rows)}); affine "
        f"backward {sum(x['ms'] for x in rows)} ms per step (bound "
        f"{sum(x['bound_ms'] for x in rows)}); DAMSM "
        f"{ {k: round(v['ms'], 4) for k, v in damsm_rows.items()} } ms; bf16 "
        f"train step B={TRAIN_BATCH}: {step_ms} ms (rounds {step_runs})")
    return fwd_rows, rows, damsm_rows, step_ms, step_runs


def phase_train_breakdown(train, step_ms: float):
    """Where one bf16 train step's time goes: the device's busy time per
    step, its operations by time (torch.profiler) and the peak memory."""
    import torch

    step, state, frozen, batch, noise = train
    saved = read_counts()
    torch.cuda.reset_peak_memory_stats()
    step(state, frozen, batch, noise)
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    result = profile_steps(lambda: step(state, frozen, batch, noise), 3,
                           step_ms)
    result["peak_memory_mib"] = peak_mib
    set_counts(saved)
    log(f"phase 13 ok: bf16 train step device busy "
        f"{result['device_busy_ms_per_step']} ms of {step_ms} ms; peak "
        f"{peak_mib} MiB")
    return result

# ---------------------------------------------------------------------------
# The trainer slice: Trainer, data pipeline, checkpoints, the two CLIs
# ---------------------------------------------------------------------------

CORPUS_FILES = 576  # the demo corpus: 384 train images = 12 batches of 32
RESUMED_ITERS = 5  # the resumed trainer's iterations, the last 3 traced
TRACED_STEPS = 3
# Device activity in a torch.profiler Chrome trace.
DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
DAMSM_PARITY_BATCH = 8
TRAIN_LAUNCHES = dict(affine_mask_relu=14, affine_mask_relu_backward=14,
                      words_similarity_forward=1,
                      words_similarity_backward_dr=1)


def trainer_config(data_dir: str, dtype: str = "bfloat16"):
    """cfg/bird.yml (bf16 by default) with both kernel families on, reading
    the demo corpus (two captions per image) with random frozen
    encoders."""
    from eegan_tpu_torch.config import apply_overrides

    return apply_overrides(bird_config(dtype), [
        f"DATA_DIR={data_dir}", "TEXT.CAPTIONS_PER_IMAGE=2",
        "TEXT.DAMSM_NAME=''", "RUNTIME.ALLOW_RANDOM_ENCODERS=true"])


def counted(fn, rows):
    """``fn``, appending each call's kernel launches to ``rows``."""
    def call(*args):
        before = read_counts()
        out = fn(*args)
        after = read_counts()
        rows.append({k: after[k] - before[k] for k in after})
        return out
    return call


def optimizer_moments(state):
    """Every Adam moment and step count of the state, by (optimizer,
    parameter index, key)."""
    out = {}
    for name, opt in (("g", state.g_opt),
                      *((f"d{i}", o) for i, o in enumerate(state.d_opts))):
        params = [p for g in opt.param_groups for p in g["params"]]
        for j, p in enumerate(params):
            for key, value in opt.state[p].items():
                out[(name, j, key)] = value
    return out


# The kernels-on train step held by its Adam moments (PERF.md §2): per
# tensor, (b) kernels 1-2 on against off from the same state within
# SWITCH_SPREAD times (c), a second kernels-on run from that state, plus
# SWITCH_FLOOR; both under deterministic algorithms. The reruns read 0 in
# every tensor, so the floor is the bar: 1e-4, about 18 times the largest
# (b) of the 3000-step trajectory's 12 states (5.68e-6, PERF.md §2).
MOMENT_KEYS = ("exp_avg", "exp_avg_sq")
SWITCH_SPREAD = 10
SWITCH_FLOOR = 1e-4
NOISE_SCALE = 1e-3
WORST_ROWS = 10


def named_moments(state):
    """Each optimizer's Adam moments by (optimizer, parameter name, key),
    cloned (with TRAIN.B1 = 0 the first moment is the step's gradient)."""
    names = {"g": [f"generator.{n}" for n, _ in
                   state.generator.named_parameters()]
             + [f"attr_enhance.{n}" for n, _ in
                state.attr_enhance.named_parameters()]}
    for i, d in enumerate(state.discriminators):
        names[f"d{i}"] = [n for n, _ in d.named_parameters()]
    return {(opt, names[opt][j], key): value.detach().clone()
            for (opt, j, key), value in optimizer_moments(state).items()
            if key in MOMENT_KEYS}


def moment_distances(got, want):
    """(per tensor, per optimizer and moment) relative L2 distances of two
    ``named_moments`` dicts. A tensor's distance is over the larger of its
    own norm and NOISE_SCALE times its share of its optimizer's norm
    (sqrt(n / N) of it): a gradient the math makes about 0 (a bias before
    a batch norm) is rounding noise, measured against a typical entry."""
    per_tensor, per_opt = {}, {}
    for opt in sorted({k[0] for k in want}):
        for key in MOMENT_KEYS:
            ks = [k for k in want if k[0] == opt and k[2] == key]
            w = {k: want[k].detach().double().cpu() for k in ks}
            g = {k: got[k].detach().double().cpu() for k in ks}
            total = math.sqrt(sum(float(w[k].square().sum()) for k in ks))
            n_opt = sum(w[k].numel() for k in ks)
            diff = math.sqrt(sum(float((g[k] - w[k]).square().sum())
                                 for k in ks))
            for k in ks:
                scale = max(float(w[k].norm()), NOISE_SCALE * total
                            * math.sqrt(w[k].numel() / n_opt), 1e-30)
                per_tensor[k] = float((g[k] - w[k]).norm()) / scale
            per_opt[f"{opt}.{key}"] = diff / max(total, 1e-30)
    return per_tensor, per_opt


def state_snapshot(state, device="cpu"):
    """A copy of the train state (``full_state_dict``) on ``device``, for
    :func:`state_restore`."""
    import torch

    from eegan_tpu_torch.training.state import full_state_dict

    def copy_to(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().to(device, copy=True)
        if isinstance(tree, dict):
            return {k: copy_to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [copy_to(v) for v in tree]
        return tree

    return copy_to(full_state_dict(state))


def state_restore(state, snap) -> None:
    """Put a :func:`state_snapshot` back into ``state`` (its modules and
    optimizers keep their identity; the snapshot stays untouched, as an
    optimizer's ``load_state_dict`` keeps the tensors it is given)."""
    import copy

    from eegan_tpu_torch.training.state import load_full_state_dict

    load_full_state_dict(state, copy.deepcopy(snap))


class deterministic_card:
    """``torch.use_deterministic_algorithms(True, warn_only=True)``,
    cuDNN's deterministic algorithms and TF32 off while entered; ``ops``
    collects the
    first line of each warning an operation without a deterministic
    implementation gave."""

    def __enter__(self):
        import warnings

        import torch

        self.prev = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled(),
                     torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark,
                     torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.caught = warnings.catch_warnings(record=True)
        self.records = self.caught.__enter__()
        warnings.simplefilter("always")
        return self

    @property
    def ops(self):
        return sorted({str(w.message).splitlines()[0][:160]
                       for w in self.records})

    def __exit__(self, *exc):
        import torch

        self.caught.__exit__(*exc)
        torch.use_deterministic_algorithms(self.prev[0],
                                           warn_only=self.prev[1])
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.prev[2:]


def affine_switch_check(what: str, step_fn, state, frozen, batch, noise,
                        reference=None, strict: bool = True):
    """One train step from ``state``'s contents with kernels 1-2 on
    (RUNTIME.PALLAS_AFFINE), one with them off, and a second one on, each
    from the same state, batch and noise, under deterministic algorithms;
    the Adam moments per tensor: (b) off against on, (c) on again against
    on, and (a) on against ``reference`` (another step's ``named_moments``
    from the same state: the CPU's) when given. Prints the WORST_ROWS
    tensors nearest their bar and fails where (b) exceeds SWITCH_SPREAD x
    (c) + SWITCH_FLOOR (with ``strict``), or where the switch did not
    switch. Leaves the state, the switches and the launch counters as
    they were."""
    import torch

    from eegan_tpu_torch.models.generator import AffineSSA

    mods = [m for m in state.generator.modules() if isinstance(m, AffineSSA)]
    was = [m.pallas for m in mods]
    saved = read_counts()
    snap = state_snapshot(state, "cuda")
    runs, launches = {}, {}
    with deterministic_card() as det:
        for arm in ("on", "off", "on_again"):
            state_restore(state, snap)
            for m in mods:
                m.pallas = arm != "off"
            zero_counts()
            step_fn(state, frozen, batch, noise)
            torch.cuda.synchronize()
            launches[arm] = read_counts()
            runs[arm] = named_moments(state)
    state_restore(state, snap)
    for m, p in zip(mods, was):
        m.pallas = p
    set_counts(saved)
    for arm, got in launches.items():
        want = 0 if arm == "off" else len(mods)
        if any(got[k] != want for k in ("affine_mask_relu",
                                        "affine_mask_relu_backward")):
            fail(f"{what}: the {arm} arm launched {got}, want {want} of "
                 f"kernels 1 and 2")
    b, b_opt = moment_distances(runs["off"], runs["on"])
    c, c_opt = moment_distances(runs["on_again"], runs["on"])
    a, a_opt = (moment_distances(runs["on"], reference)
                if reference is not None else ({}, {}))
    rows = []
    for k in runs["on"]:
        bar = SWITCH_SPREAD * c[k] + SWITCH_FLOOR
        rows.append(dict(opt=k[0], tensor=k[1], moment=k[2], b=b[k],
                         c=c[k], a=a.get(k), bar=bar,
                         b_over_bar=b[k] / bar))
    rows.sort(key=lambda r: -r["b_over_bar"]
              if math.isfinite(r["b_over_bar"]) else -math.inf)
    for r in rows[:WORST_ROWS]:
        log(f"{what}: {r['opt']} {r['tensor']} {r['moment']}: (b) on vs off "
            f"{r['b']:.3e}, (c) rerun {r['c']:.3e}, bar {r['bar']:.3e}"
            + (f", (a) vs CPU {r['a']:.3e}" if r["a"] is not None else ""))
    bad = [r for r in rows if not r["b"] <= r["bar"]]
    out = dict(within_bar=not bad, beyond_bar=len(bad),
               per_optimizer={"b_on_vs_off": b_opt, "c_rerun": c_opt,
                              "a_vs_reference": a_opt},
               max_b=max(b.values()), max_c=max(c.values()),
               max_a=max(a.values()) if a else None,
               tensors=len(rows), worst=rows[:WORST_ROWS],
               nondeterministic_ops=det.ops)
    if bad and strict:
        fail(f"{what}: kernels 1-2 on against off beyond {SWITCH_SPREAD} x "
             f"the rerun spread + {SWITCH_FLOOR} in {len(bad)} tensors: "
             f"{bad[:WORST_ROWS]}")
    log(f"{what}: moments of {len(rows)} tensors: (b) on vs off max "
        f"{out['max_b']:.3e}, (c) rerun max {out['max_c']:.3e}"
        + (f", (a) vs CPU max {out['max_a']:.3e}" if a else "")
        + f"; per optimizer (b) {b_opt}, (c) {c_opt}"
        + (f", (a) {a_opt}" if a else "")
        + f"; ops without a deterministic algorithm: {det.ops}")
    return out


def trace_device_busy(path: str, steps: int):
    """(ms per step, operations per step) of the device in a torch.profiler
    Chrome trace of ``steps`` steps: the union of its kernels', copies' and
    fills' intervals."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    if not spans:
        fail(f"the trace {path} holds no device activity; categories "
             f"{sorted({str(e.get('cat')) for e in events})[:20]}")
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in spans:
        start = max(t0, end)
        if t1 > start:
            busy_us += t1 - start
        end = max(end, t1)
    return busy_us / 1e3 / steps, len(spans) / steps


def phase_trainer(tmp: str):
    """(14) Trainer on an on-disk demo corpus (cfg/bird.yml, B=32, bf16,
    8 spawned data workers) for one epoch of 12 iterations; launches per
    iteration and per save_images, images/s over iterations 3-12, the
    host's wait on the pipeline, checkpoint save time and size; then a
    second Trainer resumes from the checkpoint (same step, bitwise-equal
    Adam moments) and takes 5 finite steps, the last 3 traced by the
    trainer's own profiler (the device's busy time per iteration)."""
    import torch

    from eegan_tpu_torch.data.demo_corpus import build_corpus
    from eegan_tpu_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    root = build_corpus(os.path.join(tmp, "data"), n_files=CORPUS_FILES)
    corpus_s = time.perf_counter() - t0
    config = trainer_config(root)
    out = os.path.join(tmp, "run")
    t0 = time.perf_counter()
    trainer = Trainer(config, out, seed=SEED)
    init_s = time.perf_counter() - t0
    iters = len(trainer.pipeline)
    if iters < 4:
        fail(f"trainer epoch of {iters} iterations, expected at least 4")

    per_iter, per_save, saves, ips = [], [], [], []
    trainer.train_step = counted(trainer.train_step, per_iter)
    save_images = counted(trainer.save_images, per_save)

    def save_images_at_epoch_end(epoch):
        torch.cuda.synchronize()  # the epoch's steps are done: read the timer
        ips.append(trainer.timer.images_per_sec)
        save_images(epoch)

    trainer.save_images = save_images_at_epoch_end
    save_state = trainer.ckpt.save_state

    def timed_save_state(epoch, state, full=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        path = save_state(epoch, state, full)
        saves.append(dict(s=time.perf_counter() - t,
                          bytes=os.path.getsize(path)))
        return path

    trainer.ckpt.save_state = timed_save_state

    zero_counts()
    t0 = time.perf_counter()
    trainer.train(max_epochs=1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    total = read_counts()

    want_iter = launches_of(**TRAIN_LAUNCHES)
    want_save = launches_of(affine_mask_relu=14)
    if trainer.state.step != iters or len(per_iter) != iters:
        fail(f"trainer took {trainer.state.step} steps, expected {iters}")
    if any(c != want_iter for c in per_iter):
        fail(f"trainer launches per iteration {per_iter}, expected "
             f"{want_iter}")
    if per_save != [want_save]:
        fail(f"save_images launches {per_save}, expected [{want_save}]")
    if total != {k: iters * want_iter[k] + want_save[k] for k in total}:
        fail(f"trainer launches {total} over the epoch")
    metrics = {k: float(v) for k, v in trainer.last_metrics.items()}
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    if bad:
        fail(f"trainer: non-finite metrics {bad}")
    for rel in ("Image/sampling_text.txt", "Image/epoch_1_256.png",
                "Model/netG_1.pth", "Model/attr_enhance_1.pth",
                "Model/state/1.pt", "writer/metrics.jsonl"):
        if not os.path.isfile(os.path.join(out, rel)):
            fail(f"trainer did not write {rel}")
    if len(saves) != 1:
        fail(f"trainer saved {len(saves)} full states, expected 1")
    wait_ms = trainer.data_wait_s / trainer.data_waits * 1e3
    moments = optimizer_moments(trainer.state)
    step, workers = trainer.state.step, trainer.pipeline.num_workers
    trainer.close()
    iter_ms = trainer.batch_size / ips[0] * 1e3

    resumed = Trainer(config, out, seed=SEED)
    if resumed.start_epoch != 2 or resumed.state.step != step:
        fail(f"resume: epoch {resumed.start_epoch}, step "
             f"{resumed.state.step}; expected 2, {step}")
    got = optimizer_moments(resumed.state)
    if set(got) != set(moments) or not all(
            torch.equal(got[k].cpu(), moments[k].cpu()) for k in moments):
        fail("resume: the optimizer moments differ from the saved run's")
    zero_counts()
    resumed.train(max_epochs=1, max_iters_per_epoch=RESUMED_ITERS,
                  profile_steps=TRACED_STEPS)
    torch.cuda.synchronize()
    resumed_counts = read_counts()
    resumed_metrics = {k: float(v)
                       for k, v in resumed.last_metrics.items()}
    resumed.close()
    if resumed.state.step != step + RESUMED_ITERS or not all(
            math.isfinite(v) for v in resumed_metrics.values()):
        fail(f"resumed step {resumed.state.step}, metrics {resumed_metrics}")
    if resumed_counts != {k: RESUMED_ITERS * want_iter[k] + want_save[k]
                          for k in resumed_counts}:
        fail(f"resumed epoch launches {resumed_counts}")
    busy_ms, ops = trace_device_busy(
        os.path.join(out, "profile", "trace.json"), TRACED_STEPS)

    result = dict(
        config="cfg/bird.yml + RUNTIME.PALLAS_AFFINE=true "
               "+ RUNTIME.PALLAS_DAMSM=true, demo corpus",
        train_images=len(trainer.dataset), batch=trainer.batch_size,
        dtype="bfloat16", data_workers=workers, iterations=iters,
        images_per_s=ips[0], timed_iterations=iters - trainer.timer.warmup,
        ms_per_iteration=iter_ms, data_wait_ms_per_step=wait_ms,
        device_busy_ms_per_iteration=busy_ms,
        device_ops_per_iteration=ops, traced_iterations=TRACED_STEPS,
        idle_share_vs_untraced_iteration=1.0 - busy_ms / iter_ms,
        epoch_s=epoch_s, init_s=init_s, corpus_s=corpus_s,
        checkpoint_save_s=saves[0]["s"], checkpoint_bytes=saves[0]["bytes"],
        launches_per_iteration=per_iter[0],
        launches_save_images=per_save[0], launches_epoch=total,
        errG_total=metrics["errG/total"],
        resumed_errG_total=resumed_metrics["errG/total"])
    log(f"phase 14 ok: Trainer {iters} iterations B={trainer.batch_size} "
        f"bf16, {workers} workers: {ips[0]} images/s ({iter_ms} ms per "
        f"iteration, device busy {busy_ms} ms of it in {TRACED_STEPS} traced "
        f"iterations), host waits {wait_ms} ms per step on the pipeline; "
        f"launches per iteration {want_iter}, per save_images {want_save}; "
        f"checkpoint {saves[0]['bytes']} bytes in {saves[0]['s']} s; resumed "
        f"at epoch 2, step {step}, moments bitwise equal, "
        f"{RESUMED_ITERS} finite steps")
    return result


def run_cli(args, env=None):
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=env)
    if proc.returncode != 0:
        fail(f"{' '.join(args[:1])} exit {proc.returncode}:\n"
             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout


def phase_clis(tmp: str):
    """(15) pretrain_damsm --synthetic at full width, then train
    --synthetic loading its encoders through the directory branch."""
    common = ["--set", f"SAVE_DIR={tmp}",
              "--set", "RUNTIME.PALLAS_AFFINE=true",
              "--set", "RUNTIME.PALLAS_DAMSM=true"]
    t0 = time.perf_counter()
    run_cli(["eegan_tpu_torch.pretrain_damsm", "--synthetic", "--epochs",
             "1", "--max_iters", "2", "--output_dir", "damsm", *common])
    pretrain_s = time.perf_counter() - t0
    frozen = os.path.join(tmp, "damsm", "Model", "frozen_encoders")
    for name in ("text_encoder.pth", "image_encoder.pth"):
        if not os.path.isfile(os.path.join(frozen, name)):
            fail(f"pretrain_damsm did not write {name}")
    t0 = time.perf_counter()
    stdout = run_cli(
        ["eegan_tpu_torch.train", "--synthetic", "--max_epochs", "1",
         "--max_iters", "2", "--output_dir", "run",
         "--set", f"TEXT.DAMSM_NAME={os.path.join(tmp, 'damsm', 'Model')}",
         *common])
    train_s = time.perf_counter() - t0
    if f"loading DAMSM encoders from directory {frozen}" not in stdout:
        fail("train did not load the pretrained encoders from their "
             "directory")
    for rel in ("Model/state/1.pt", "Model/netG_1.pth",
                "Image/epoch_1_256.png"):
        if not os.path.isfile(os.path.join(tmp, "run", rel)):
            fail(f"train CLI did not write {rel}")
    log(f"phase 15 ok: pretrain_damsm ({pretrain_s:.1f} s) wrote the "
        f"encoders, train loaded them from {frozen} and trained 2 "
        f"iterations ({train_s:.1f} s)")
    return dict(pretrain_s=pretrain_s, train_s=train_s)


# ---------------------------------------------------------------------------
# The evaluation slice: Tester, FID, IS and its fine-tune, the eval CLIs,
# evaluation overlapped with training (phase 16)
# ---------------------------------------------------------------------------

EVAL_PARITY_IMAGES = 16  # Tester.generate, float32, cuda against the CPU
EVAL_PARITY_BATCH = 8
EVAL_CLI_IMAGES = 1024  # the test CLI's --sampling_nums
EVAL_MESH_CLI_IMAGES = 64  # the same over --set RUNTIME.MESH=data:2
EVAL_TIMED_IMAGES = 256  # in-process sweep timing, B=32, bf16
EVAL_OVERLAP_IMAGES = 256  # the AsyncEvaluator's eval_nums
FID_DATASET_IMAGES = 512  # fid_score --dataset_npz over the test split
FINETUNE_ITERS = 4
R_VAL = 100


def eval_tester(config, device, model_dir, batch_size, mesh=None):
    """A Tester (over ``mesh``, if given) over the trainer's epoch-1
    generator snapshot and frozen encoders with random weights from the
    seed (the same on every device)."""
    import torch

    from eegan_tpu_torch.data.datasets import TextOnlyDataset
    from eegan_tpu_torch.evaluation.tester import Tester
    from eegan_tpu_torch.models.factory import build_models, randomize_
    from eegan_tpu_torch.training.checkpoint import CheckpointManager
    from eegan_tpu_torch.training.state import create_train_state

    dataset = TextOnlyDataset(config, split="test")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        models = build_models(config, dataset.n_words, device)
    for i, m in enumerate((models.text_encoder, models.image_encoder)):
        randomize_(m, SEED + 400 + i)
    _, frozen = create_train_state(config, models)
    CheckpointManager(model_dir).load_generator(1, models.generator,
                                                models.attr_enhance)
    return Tester(config, models, frozen, dataset, batch_size=batch_size,
                  mesh=mesh)


def recorded(fn, rows):
    """``fn``, appending each call's result to ``rows``."""
    def call(*args):
        out = fn(*args)
        rows.append(out)
        return out
    return call


def phase_eval_parity(data_dir, model_dir):
    """(16a) ``Tester.generate`` in float32 (TF32 off) on cuda against the
    same call on the CPU: cfg/bird.yml at full width with the trainer's
    epoch-1 weights, EVAL_PARITY_IMAGES images in batches of
    EVAL_PARITY_BATCH, the same noise. The images within 1e-3, the image
    codes and the similarities within 1e-3 of their largest magnitude, the
    R-precision hits equal wherever the top two similarities differ by
    more than 1e-3 (the rest counted), 14 launches of kernel 1 per batch;
    and ``FIDExtractor.features`` on the CPU's images within 1e-3 of the
    largest feature."""
    import numpy as np
    import torch

    from eegan_tpu_torch.evaluation.fid import FIDExtractor

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = trainer_config(data_dir, "float32")
    z_dim = config.GAN.Z_DIM

    def noise(batch_idx, b):
        gen = torch.Generator().manual_seed(SEED + 500 + batch_idx)
        return torch.randn((b, z_dim), generator=gen)

    runs = {}
    for device in ("cuda", "cpu"):
        tester = eval_tester(config, device, model_dir, EVAL_PARITY_BATCH)
        imgs, sims, launches = [], [], []
        tester.sample_step = recorded(counted(tester.sample_step, launches),
                                      imgs)
        tester._similarities = recorded(tester._similarities, sims)
        result = tester.generate(
            "", sampling_nums=EVAL_PARITY_IMAGES, seed=SEED,
            compute_r_precision=True, r_val=R_VAL, saving_images=False,
            noise_fn=noise)
        runs[device] = dict(
            imgs=[[im.float().cpu() for im in out] for out in imgs],
            codes=[c for c, _ in sims], sims=[s for _, s in sims],
            launches=launches, result=result)
    cuda, cpu = runs["cuda"], runs["cpu"]
    batches = EVAL_PARITY_IMAGES // EVAL_PARITY_BATCH
    if cuda["launches"] != [launches_of(affine_mask_relu=14)] * batches:
        fail(f"Tester.generate launches per batch {cuda['launches']}")
    img_err = max(float((a - b).abs().max())
                  for got, want in zip(cuda["imgs"], cpu["imgs"])
                  for a, b in zip(got, want))
    rel = lambda got, want: max(
        float(np.abs(g - w).max() / np.abs(w).max())
        for g, w in zip(got, want))
    code_err, sim_err = (rel(cuda[k], cpu[k]) for k in ("codes", "sims"))
    ties = 0
    for got, want in zip(cuda["sims"], cpu["sims"]):
        top2 = np.sort(want, axis=1)[:, -2:]
        close = top2[:, 1] - top2[:, 0] <= 1e-3
        ties += int(close.sum())
        differ = (np.argmax(got, 1) == 0) != (np.argmax(want, 1) == 0)
        if (differ & ~close).any():
            fail(f"R-precision hits differ on cuda: {got} vs {want}")
    if img_err > 1e-3 or code_err > 1e-3 or sim_err > 1e-3:
        fail(f"Tester.generate cuda vs cpu: images {img_err}, codes "
             f"{code_err}, similarities {sim_err}")
    images = np.concatenate([out[-1].numpy() for out in cpu["imgs"]])
    feats = {dev: FIDExtractor(batch_size=EVAL_PARITY_BATCH,
                               device=dev).features(images)
             for dev in ("cuda", "cpu")}
    feat_err = float(np.abs(feats["cuda"] - feats["cpu"]).max()
                     / np.abs(feats["cpu"]).max())
    if feat_err > 1e-3:
        fail(f"FIDExtractor.features cuda vs cpu: {feat_err}")
    result = dict(images=EVAL_PARITY_IMAGES, batch=EVAL_PARITY_BATCH,
                  image_max_abs_err=img_err, code_rel_err=code_err,
                  similarity_rel_err=sim_err, near_ties=ties,
                  fid_feature_rel_err=feat_err,
                  r_precision={d: runs[d]["result"] for d in runs},
                  launches_per_batch=cuda["launches"][0])
    log(f"phase 16 parity ok: Tester.generate float32 (bird.yml, "
        f"{EVAL_PARITY_IMAGES} images) on cuda against the CPU: images "
        f"{img_err}, codes {code_err}, similarities {sim_err} (relative), "
        f"hits equal ({ties} near ties); FID features {feat_err}; kernel 1 "
        f"launched 14 times per batch")
    return result


def informative_inception(data_dir, path):
    """Save to ``path`` a torchvision-layout Inception-v3 with random
    weights from the seed whose batch norms hold the statistics of a batch
    of the corpus's test images (one train-mode pass, momentum 1). At a
    random init the features barely vary with the image, and every FID is
    about 0; normalised over real images they do vary."""
    import numpy as np
    import torch

    from eegan_tpu_torch.data.datasets import TextImageDataset
    from eegan_tpu_torch.models.inception import InceptionV3
    from eegan_tpu_torch.models.layers import resize_bilinear_half_pixel

    dataset = TextImageDataset(trainer_config(data_dir), split="test")
    rng = np.random.default_rng([SEED])
    images = np.stack([dataset.sample(i, rng)["img256"]
                       for i in range(TRAIN_BATCH)])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED + 600)
        model = InceptionV3(num_classes=1000)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    model = model.cuda().to(memory_format=torch.channels_last).train()
    with torch.no_grad():
        model(resize_bilinear_half_pixel(
            torch.from_numpy(images).cuda().permute(0, 3, 1, 2), (299, 299)))
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)


def run_clis_together(jobs, logdir):
    """Start every ``python -m`` command of ``jobs`` (name -> arguments)
    at once, wait for all, fail on any non-zero exit; name -> standard
    output."""
    procs = {}
    for name, args in jobs.items():
        out = open(os.path.join(logdir, f"{name}.out"), "w+")
        procs[name] = (background(subprocess.Popen(
            [sys.executable, "-m", *args], cwd=ROOT, stdout=out,
            stderr=subprocess.STDOUT, text=True)), out)
    outputs = {}
    for name, (proc, out) in procs.items():
        try:
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        out.seek(0)
        outputs[name] = out.read()
        out.close()
        if proc.returncode != 0:
            fail(f"{name} exit {proc.returncode}:\n{outputs[name][-4000:]}")
    return outputs


def phase_eval_clis(tmp, data_dir, model_dir):
    """(16b) the evaluation CLIs as subprocesses on the card: ``test``
    (EVAL_CLI_IMAGES PNGs and an R-precision in [0, 1]), the same with
    ``--set RUNTIME.MESH=data:2`` (phase 21's; EVAL_MESH_CLI_IMAGES),
    ``fid_score --dataset_npz`` over the test split (``--inception_ckpt``:
    ``informative_inception``'s), ``finetune_inception`` for
    FINETUNE_ITERS iterations and ``sample --from_dataset --model_dir``
    together; then the ``fid_score`` sweep of Epoch_1_0 against the npz (a
    finite FID >= 0) and ``inception_score --is_classifier`` on it (a
    finite IS in [1, CLASS_NUM])."""
    import re

    cfg = os.path.join(ROOT, "cfg", "bird.yml")
    inception = os.path.join(tmp, "inception_random.pth")
    informative_inception(data_dir, inception)
    sets = ["--set", f"DATA_DIR={data_dir}",
            "--set", "TEXT.CAPTIONS_PER_IMAGE=2",
            "--set", "RUNTIME.ALLOW_RANDOM_ENCODERS=true",
            "--set", "RUNTIME.PALLAS_AFFINE=true", "--set", f"SAVE_DIR={tmp}"]
    npz = os.path.join(tmp, "test_stats.npz")
    gen_root = os.path.join(tmp, "eval", "GenImage")
    classifier = os.path.join(tmp, "is", "is_inception.pt")
    classes = bird_config("float32").TRAIN.CLASS_NUM
    t0 = time.perf_counter()
    first = run_clis_together({
        "test": ["eegan_tpu_torch.test", "--cfg", cfg, "--model_dir",
                 model_dir, "--select_epochs", "1", "--sampling_nums",
                 str(EVAL_CLI_IMAGES), "--saving_image", "--compare_sim",
                 "--output_dir", "eval", *sets],
        "fid_dataset": ["eegan_tpu_torch.fid_score", "--dataset_npz", npz,
                        "--cfg", cfg, "--max_images",
                        str(FID_DATASET_IMAGES), "--inception_ckpt",
                        inception, *sets],
        "finetune": ["eegan_tpu_torch.finetune_inception", "--cfg", cfg,
                     "--output_dir", "is", "--epochs", "1", "--max_iters",
                     str(FINETUNE_ITERS), "--set", "RUNTIME.DATA_WORKERS=2",
                     *sets],
        "sample": ["eegan_tpu_torch.sample", "--cfg", cfg, "--from_dataset",
                   "--model_dir", model_dir, "--epoch", "1",
                   "--output_dir", "samples", *sets],
        # Phase 21's CLI over the mesh: its two ranks share the card (gloo).
        "test_mesh": ["eegan_tpu_torch.test", "--cfg", cfg, "--model_dir",
                      model_dir, "--select_epochs", "1", "--sampling_nums",
                      str(EVAL_MESH_CLI_IMAGES), "--saving_image",
                      "--compare_sim", "--output_dir", "eval_mesh",
                      "--set", "RUNTIME.MESH=data:2", *sets]}, tmp)
    first_s = time.perf_counter() - t0
    folder = os.path.join(gen_root, "Epoch_1_0")
    pngs = len([f for f in os.listdir(folder) if f.endswith(".png")])
    found = re.search(r"'r_precision_mean': ([0-9.e-]+)", first["test"])
    if pngs != EVAL_CLI_IMAGES or not found \
            or not 0.0 <= float(found.group(1)) <= 1.0:
        fail(f"test CLI: {pngs} PNGs, output {first['test'][-2000:]}")
    r_precision = float(found.group(1))
    folder = os.path.join(tmp, "eval_mesh", "GenImage", "Epoch_1_0")
    mesh_pngs = len([f for f in os.listdir(folder) if f.endswith(".png")])
    mesh_found = re.search(r"'r_precision_mean': ([0-9.e-]+)",
                           first["test_mesh"])
    if mesh_pngs != EVAL_MESH_CLI_IMAGES or not mesh_found \
            or not 0.0 <= float(mesh_found.group(1)) <= 1.0:
        fail(f"test CLI over data:2: {mesh_pngs} PNGs, output "
             f"{first['test_mesh'][-2000:]}")
    for path in (npz, classifier, os.path.join(
            tmp, "samples", "cap_0", "samples.png"), os.path.join(
            tmp, "samples", "real_images", "real_images.png")):
        if not os.path.isfile(path):
            fail(f"the eval CLIs did not write {path}")
    t0 = time.perf_counter()
    second = run_clis_together({
        "fid_sweep": ["eegan_tpu_torch.fid_score", "--eval_image_folder",
                      gen_root, "--compared_path", npz, "--select_epochs",
                      "1", "--inception_ckpt", inception],
        "inception_score": ["eegan_tpu_torch.inception_score",
                            "--eval_image_folder", gen_root,
                            "--select_epochs", "1", "--is_classifier",
                            classifier, "--num_classes", str(classes + 1),
                            "--cfg", cfg]}, tmp)
    second_s = time.perf_counter() - t0
    fid = re.search(r"Epoch_1_0: FID = ([0-9.e+-]+)", second["fid_sweep"])
    score = re.search(r"Epoch_1_0: IS = ([0-9.e+-]+)",
                      second["inception_score"])
    if not fid or not math.isfinite(float(fid.group(1))) \
            or float(fid.group(1)) < 0:
        fail(f"fid_score sweep: {second['fid_sweep'][-2000:]}")
    if not score or not 1.0 <= float(score.group(1)) <= classes:
        fail(f"inception_score: {second['inception_score'][-2000:]}")
    result = dict(test_images=pngs, test_r_precision=r_precision,
                  fid=float(fid.group(1)), inception_score=float(
                      score.group(1)), first_group_s=first_s,
                  second_group_s=second_s,
                  test_mesh=dict(images=mesh_pngs, r_precision=float(
                      mesh_found.group(1))))
    log(f"phase 16 CLIs ok: test wrote {pngs} PNGs, R-precision "
        f"{r_precision}; fid_score {result['fid']}; finetune_inception "
        f"{FINETUNE_ITERS} iterations, inception_score "
        f"{result['inception_score']}; sample --from_dataset --model_dir "
        f"({first_s:.1f} s and {second_s:.1f} s)")
    return result


def phase_eval_overlap(tmp, data_dir):
    """(16c) a Trainer for two epochs with an AsyncEvaluator (FID against
    the test split's statistics under the evaluator's own network, random
    from its seed; R-precision; EVAL_OVERLAP_IMAGES images): epoch
    1's snapshot is scored on the evaluator's stream while epoch 2 trains.
    The result holds eval/fid and eval/r_precision, no eval/error; the
    trainer's images/s at the end of each epoch."""
    import torch

    from eegan_tpu_torch.data.datasets import TextOnlyDataset
    from eegan_tpu_torch.evaluation.async_eval import (
        AsyncEvaluator,
        eval_bundle,
    )
    from eegan_tpu_torch.evaluation.fid import (
        FIDExtractor,
        dataset_statistics,
        save_npz_stats,
    )
    from eegan_tpu_torch.evaluation.tester import Tester
    from eegan_tpu_torch.training.trainer import Trainer

    config = trainer_config(data_dir)
    stats_npz = os.path.join(tmp, "overlap_stats.npz")
    save_npz_stats(stats_npz, *dataset_statistics(
        config, FIDExtractor(batch_size=TRAIN_BATCH, device="cuda"),
        n_images=EVAL_OVERLAP_IMAGES))
    trainer = Trainer(config, os.path.join(tmp, "overlap"), seed=SEED)
    tester = Tester(config, eval_bundle(trainer.models), trainer.frozen,
                    TextOnlyDataset(config, split="test"),
                    batch_size=TRAIN_BATCH)
    evaluator = AsyncEvaluator(tester, writer=trainer.writer,
                               real_stats=stats_npz,
                               eval_nums=EVAL_OVERLAP_IMAGES,
                               compute_r_precision=True)
    trainer.async_eval = evaluator
    ips, ends = [], []
    save_images = trainer.save_images

    def save_images_at_epoch_end(epoch):
        torch.cuda.synchronize()
        ips.append(trainer.timer.images_per_sec)
        ends.append(time.perf_counter())
        save_images(epoch)

    trainer.save_images = save_images_at_epoch_end
    t0 = time.perf_counter()
    trainer.train(max_epochs=2)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trainer.close()  # waits for the evaluation
    wait_s = time.perf_counter() - t0 - train_s
    res = evaluator.results.get(1, {})
    if "eval/error" in res or not math.isfinite(res.get("eval/fid", math.nan)) \
            or res["eval/fid"] < 0 \
            or not 0.0 <= res.get("eval/r_precision", -1.0) <= 1.0:
        fail(f"overlapped evaluation of epoch 1: {evaluator.results}")
    iters = len(trainer.pipeline)
    result = dict(eval=res, images_per_s_epoch_1=ips[0],
                  images_per_s_epochs_1_2=ips[1],
                  ms_per_iteration_epoch_2=(ends[1] - ends[0]) / iters * 1e3,
                  train_s=train_s, eval_wait_after_training_s=wait_s,
                  iterations_per_epoch=iters)
    log(f"phase 16 overlap ok: epoch 1 scored while epoch 2 trained: {res};"
        f" trainer {ips[0]} images/s after epoch 1, {ips[1]} after epoch 2 "
        f"(the evaluation running), {result['ms_per_iteration_epoch_2']} ms "
        f"per iteration of epoch 2 (its save_images included); waited "
        f"{wait_s:.1f} s for the evaluation after training")
    return result


def phase_eval_times(data_dir, model_dir):
    """(16d) times on the card, bf16, B=32: the sweep's generation +
    R-precision (``Tester.generate``, EVAL_TIMED_IMAGES images) without
    and with PNG writes, and its kernel launches per batch; FID feature
    extraction and IS probabilities images/s (``time_host``); the IS
    fine-tune step's ms; one sweep batch's device busy time and idle share
    (torch.profiler)."""
    import numpy as np
    import torch

    from eegan_tpu_torch.data.synthetic import synthetic_batch
    from eegan_tpu_torch.evaluation import inception_finetune
    from eegan_tpu_torch.evaluation.fid import FIDExtractor
    from eegan_tpu_torch.evaluation.inception_score import InceptionScorer

    config = trainer_config(data_dir)
    tester = eval_tester(config, "cuda", model_dir, TRAIN_BATCH)
    with tempfile.TemporaryDirectory() as out:
        # Warm-up: the caption cache, cuDNN's plans, the writer's imports.
        tester.generate(out, sampling_nums=TRAIN_BATCH, seed=1,
                        compute_r_precision=True)
        ips, launches = {}, None
        for pngs in (False, True):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tester.generate(os.path.join(out, str(pngs)),
                            sampling_nums=EVAL_TIMED_IMAGES, seed=2,
                            compute_r_precision=True, saving_images=pngs)
            torch.cuda.synchronize()
            ips[pngs] = EVAL_TIMED_IMAGES / (time.perf_counter() - t0)
            if not pngs:
                launches = read_counts()
    batches = EVAL_TIMED_IMAGES // TRAIN_BATCH
    per_batch = launches_of(affine_mask_relu=14)
    if launches != {k: batches * v for k, v in per_batch.items()}:
        fail(f"the sweep launched {launches} in {batches} batches")

    rng = np.random.default_rng([3])
    batch = next(tester._batches(TRAIN_BATCH, rng))
    z = tester.noise_fn(3)(0, TRAIN_BATCH)
    images = tester.sample_step(batch["caps"], batch["cap_lens"],
                                batch["attrs"], batch["attr_lens"], z)[-1]

    def sweep_batch():
        imgs = tester.sample_step(batch["caps"], batch["cap_lens"],
                                  batch["attrs"], batch["attr_lens"], z)
        tester._r_precision_batch(batch, imgs[-1], R_VAL, rng)

    batch_ms = TRAIN_BATCH / ips[False] * 1e3
    saved = read_counts()
    profile = profile_steps(sweep_batch, 3, batch_ms)
    set_counts(saved)
    extractor = FIDExtractor(batch_size=TRAIN_BATCH, device="cuda")
    fid_ms = time_host(lambda: extractor.features_device(images))
    scorer = InceptionScorer(num_classes=config.TRAIN.CLASS_NUM + 1,
                             batch_size=TRAIN_BATCH, device="cuda")
    is_ms = time_host(lambda: scorer.probs_device(images))
    model = inception_finetune.build_is_model(config, "cuda")
    step, init_opt = inception_finetune.make_finetune_step(config, model)
    opt = init_opt(model)
    ft_batch = synthetic_batch(config, TRAIN_BATCH, seed=SEED)
    ft_dev = {k: torch.from_numpy(ft_batch[k]).cuda()
              for k in (f"img{config.imsizes[-1]}", "class_ids")}
    ft_ms = time_host(lambda: step(opt, ft_dev), reps=10)
    result = dict(
        config="cfg/bird.yml + RUNTIME.PALLAS_AFFINE=true, the trainer's "
               "epoch-1 weights, demo corpus test split",
        batch=TRAIN_BATCH, dtype="bfloat16", images=EVAL_TIMED_IMAGES,
        sweep_images_per_s=ips[False], sweep_images_per_s_with_pngs=ips[True],
        sweep_batch_ms=batch_ms, launches_per_batch=per_batch,
        fid_features_images_per_s=TRAIN_BATCH / fid_ms * 1e3,
        is_probs_images_per_s=TRAIN_BATCH / is_ms * 1e3,
        finetune_step_ms=ft_ms,
        sweep_batch_device_busy_ms=profile["device_busy_ms_per_step"],
        sweep_batch_idle_share=profile["idle_share_vs_untraced_step"],
        sweep_batch_device_ops=profile["device_ops_per_step"],
        top_device_ops=profile["top_device_ops"])
    log(f"phase 16 times ok: sweep {ips[False]} images/s ({ips[True]} with "
        f"PNGs), B={TRAIN_BATCH} bf16, kernel 1 launched 14 times per batch;"
        f" device busy {profile['device_busy_ms_per_step']} ms of a "
        f"{batch_ms} ms batch; FID features {result['fid_features_images_per_s']}"
        f" images/s, IS probabilities {result['is_probs_images_per_s']} "
        f"images/s, fine-tune step {ft_ms} ms")
    return result


def damsm_gaps(sides, lr, b1, select):
    """Gaps between two DAMSM steps from the same start (``sides``: two
    (models, optimizers) pairs, the reference first), over the parameters
    ``select(encoder, name)`` picks: the relative L2 gap of the gradients
    each Adam took (its first moments over 1 - b1) over them all and at the
    worst tensor, the largest parameter gap, and the share of parameter
    entries more than lr/100 apart."""
    import torch

    grads, params = [], []
    for models, opts in sides:
        g, p = {}, {}
        for j, enc in enumerate(("text_encoder", "image_encoder")):
            for k, t in getattr(models, enc).named_parameters():
                if select(enc, k):
                    g[enc, k] = (opts[j].state[t]["exp_avg"].cpu().double()
                                 / (1 - b1))
                    p[enc, k] = t.detach().cpu()
        grads.append(g)
        params.append(p)
    (want, got), keys = grads, list(grads[0])
    flat = [torch.cat([d[k].flatten() for k in keys]) for d in grads]
    errs = [(params[1][k] - params[0][k]).abs() for k in keys]
    return dict(
        grad_rel_l2=float((flat[1] - flat[0]).norm() / flat[0].norm()),
        grad_rel_l2_worst_tensor=max(
            float((got[k] - want[k]).norm() / want[k].norm()) for k in keys),
        param_max_abs_err=max(float(e.max()) for e in errs),
        param_share_beyond_lr_100=(sum(int((e > lr / 100).sum())
                                       for e in errs)
                                   / sum(e.numel() for e in errs)))


CUDNN_KINDS = ("conv_forward", "conv_dgrad", "conv_wgrad", "batch_norm")
# The kinds turned off together, one run each: none, each alone, and the
# conv's two backward passes together.
CUDNN_OFF = ((), ("conv_forward",), ("conv_dgrad",), ("conv_wgrad",),
             ("conv_dgrad", "conv_wgrad"), ("batch_norm",))


def cudnn_per_kind(on):
    """A context in which the DAMSM encoders' convs (``layers.Conv2d``: the
    forward, the data gradient and the weight gradient apart) and batch
    norms (``inception.BasicConv2d``) take cuDNN or not, as ``on`` (kind ->
    bool, CUDNN_KINDS) says; TF32 off throughout. A conv's output takes
    its input's memory format; the stem's input (from the resize) is NCHW,
    so the trunk runs in NCHW here. A diagnostic: it says whether a kind
    of cuDNN operation moves the trunk's gradients."""
    import contextlib
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from eegan_tpu_torch.models import inception, layers

    def flags(kind):
        return torch.backends.cudnn.flags(enabled=on[kind], allow_tf32=False)

    class Conv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, stride, padding):
            ctx.save_for_backward(x, w)
            ctx.geometry = (stride, padding)
            with flags("conv_forward"):
                y = F.conv2d(x, w, None, stride, padding)
            return y.contiguous(memory_format=torch.channels_last
                                if x.is_contiguous(
                                    memory_format=torch.channels_last)
                                else torch.contiguous_format)

        @staticmethod
        def backward(ctx, dy):
            x, w = ctx.saved_tensors
            stride, padding = ctx.geometry
            grads = [None, None]
            for j, kind in enumerate(("conv_dgrad", "conv_wgrad")):
                if ctx.needs_input_grad[j]:
                    with flags(kind):
                        grads[j] = torch.ops.aten.convolution_backward(
                            dy, x, w, None, stride, padding, (1, 1), False,
                            (0, 0), 1, [j == 0, j == 1, False])[j]
            return grads[0], grads[1], None, None

    def conv_forward(self, x):
        if self.bias is not None:
            raise ValueError("cudnn_per_kind takes convs without a bias")
        dt = self.compute_dtype
        return Conv.apply(x.to(dt), self.weight.to(dt), self.stride,
                          self.padding)

    def basic_forward(self, x):
        y = self.conv(x).to(self.bn.weight.dtype)
        with flags("batch_norm"):
            y = self.bn(y)
        return F.relu(y)

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(layers.Conv2d, "forward",
                                          conv_forward))
    stack.enter_context(mock.patch.object(inception.BasicConv2d, "forward",
                                          basic_forward))
    return stack


def damsm_step_run(config, batch, device, cudnn=True, float64=False,
                   channels_last_pool=False):
    """One DAMSM step from the seed's weights, dropout 0: (models,
    optimizers, metrics). ``cudnn``: on or off for the whole step, or a
    CUDNN_KINDS -> bool dict (``cudnn_per_kind``); ``float64``: the
    encoders in float64 (the yardstick); ``channels_last_pool``: the
    Inception's padded average pools in channels_last memory (PyTorch's
    CUDA backward of that pool is wrong; ``inception.avg_pool3_s1_p1``
    computes it in NCHW). TF32 is off."""
    import contextlib
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from eegan_tpu_torch.models import inception
    from eegan_tpu_torch.models.factory import (
        build_models,
        randomize_,
        to_float64_,
    )
    from eegan_tpu_torch.training.damsm_trainer import make_damsm_train_step

    models = build_models(config, N_WORDS, device)
    for i, m in enumerate((models.text_encoder, models.image_encoder)):
        randomize_(m, SEED + 300 + i)
        if float64:
            to_float64_(m)
    models.text_encoder.drop.p = 0.0
    step, init_opt = make_damsm_train_step(config, models)
    opts = init_opt(models.text_encoder, models.image_encoder)
    zero_counts()
    context = (cudnn_per_kind(cudnn) if isinstance(cudnn, dict)
               else contextlib.nullcontext())
    pool = (mock.patch.object(inception, "avg_pool3_s1_p1", lambda x:
                              F.avg_pool2d(x, 3, 1, 1,
                                           count_include_pad=False))
            if channels_last_pool else contextlib.nullcontext())
    with torch.backends.cudnn.flags(enabled=bool(cudnn),
                                    allow_tf32=False), context, pool:
        metrics = {k: float(v) for k, v in step(opts, batch).items()}
    if read_counts() != launches_of():
        fail(f"the DAMSM step on {device} launched {read_counts()}")
    return models, opts, metrics


def phase_damsm_parity():
    """(15) one float32 DAMSM pretraining step on cuda (TF32 off) against
    the same step on the CPU, full width, B=8, dropout 0 (the two devices
    draw other masks), the step launching no kernel (the plain words loss,
    as in JAX). Metrics within 1e-3 relative. The text encoder, the image
    encoder's heads (``emb_*``) and its Inception trunk (its convs on
    ``layers.TwiceDifferentiableConv``, with cuDNN): the gradients each
    Adam took (from its moments) within 1e-3 relative L2 and 5e-2 at the
    worst tensor, parameters within PERF.md §2's bar for an Adam step
    (2·ENCODER_LR, at most 1% of the entries beyond ENCODER_LR/100); the
    text gradient's norm at most RNN_GRAD_CLIP on both devices; and the
    same step on cuda with cuDNN off holds the whole image encoder to
    those bars. The trunk is also held against the same step in float64
    on the CPU: the relative L2 distance of its gradients from float64's,
    over the trunk and at the worst tensor, within twice the CPU float32
    step's for cuda's step with cuDNN, without it, and with the convs and
    batch norms in ``cudnn_per_kind`` (cuDNN on for every kind, and off
    for one kind at a time, CUDNN_OFF). Reported, not held: the trunk's
    convs on PyTorch's own conv autograd with cuDNN (the route that
    strays), and the distance of four of the trunk's convs' float32
    passes from float64 (``conv_pass_errors``)."""
    import torch

    from eegan_tpu_torch.data.synthetic import synthetic_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = bird_config("float32")
    lr, clip = config.TRAIN.ENCODER_LR, config.TRAIN.RNN_GRAD_CLIP
    b1 = 0.5  # the DAMSM Adam's betas are (0.5, 0.999)
    batch = synthetic_batch(config, DAMSM_PARITY_BATCH, seed=SEED,
                            n_words=N_WORDS)
    runs = {"cpu": ("cpu", True, False, False),
            "cpu_float64": ("cpu", True, True, False),
            "cuda": ("cuda", True, False, False),
            "cuda_no_cudnn": ("cuda", False, False, False),
            "cuda_channels_last_pool": ("cuda", True, False, True)}
    per_kind = [f"cuda_cudnn_but_{'_'.join(off)}" if off
                else "cuda_cudnn_every_kind" for off in CUDNN_OFF]
    for side, off in zip(per_kind, CUDNN_OFF):
        runs[side] = ("cuda", {k: k not in off for k in CUDNN_KINDS}, False,
                      False)
    sides, metrics = {}, {}
    for side, (device, cudnn, float64, cl_pool) in runs.items():
        models, opts, metrics[side] = damsm_step_run(
            config, batch, device, cudnn, float64, cl_pool)
        sides[side] = (models, opts)
    rel = {side: {k: abs(m[k] - v) / abs(v)
                  for k, v in metrics["cpu"].items()}
           for side, m in metrics.items() if side != "cpu"}
    if any(r > 1e-3 for side_rel in rel.values()
           for r in side_rel.values()):
        fail(f"DAMSM step cuda vs cpu: {metrics}")

    heads = lambda enc, k: enc == "image_encoder" and k.startswith("emb_")
    trunk = lambda enc, k: enc == "image_encoder" and not heads(enc, k)
    groups = (("cuda", "text_encoder", lambda enc, k: enc == "text_encoder"),
              ("cuda", "image_heads", heads),
              ("cuda", "image_trunk", trunk),
              ("cuda_no_cudnn", "image_encoder",
               lambda enc, k: enc == "image_encoder"))
    gaps = {}
    for side, group, select in groups:
        g = damsm_gaps((sides["cpu"], sides[side]), lr, b1, select)
        gaps[f"{side}/{group}"] = g
        if (g["grad_rel_l2"] > 1e-3 or g["grad_rel_l2_worst_tensor"] > 5e-2
                or g["param_share_beyond_lr_100"] > 0.01
                or g["param_max_abs_err"] > 2 * lr + 1e-6):
            fail(f"DAMSM step {side} vs cpu, {group}: {g}")
    # The trunk's gradients against float64's. With the padded average
    # pools in channels_last memory they lie hundreds of times farther from
    # float64 than the CPU's float32 step: PyTorch's CUDA backward of that
    # pool is wrong (``pool_backward_errors``).
    to_float64 = {}
    for side in runs:
        if side != "cpu_float64":
            g = damsm_gaps((sides["cpu_float64"], sides[side]), lr, b1,
                           trunk)
            to_float64[side] = {k: g[k] for k in (
                "grad_rel_l2", "grad_rel_l2_worst_tensor")}
    for side in ("cuda", "cuda_no_cudnn", *per_kind):
        if (to_float64[side]["grad_rel_l2"]
                > 2 * to_float64["cpu"]["grad_rel_l2"] + 1e-6):
            fail(f"DAMSM trunk on {side}: {to_float64[side]} from float64, "
                 f"more than twice the CPU's {to_float64['cpu']}")
    conv_err = conv_pass_errors(sides["cpu_float64"][0].image_encoder)
    pool_err = pool_backward_errors()
    if any(v > 1e-6 for k, v in pool_err.items()
           if k.startswith("avg_pool3_s1_p1")):
        fail(f"the Inception's average pool on cuda: {pool_err} from "
             "float64")
    norms = {}
    for side in ("cpu", "cuda"):
        models, opts = sides[side]
        norms[side] = float(torch.sqrt(sum(
            (opts[0].state[p]["exp_avg"].double() / (1 - b1)).square().sum()
            for p in models.text_encoder.parameters())))
    if not all(v <= clip * (1 + 1e-4) for v in norms.values()):
        fail(f"DAMSM step text gradient norms {norms}, above the clip {clip}")
    log(f"phase 15 ok: float32 DAMSM step (bird.yml, B={DAMSM_PARITY_BATCH})"
        f" on cuda against the CPU step: metric rel err {rel}; text "
        f"gradient norms {norms}; gaps {gaps}; the trunk's gradients from "
        f"float64's {to_float64}; conv passes from float64's {conv_err}; "
        f"pool backward from float64's {pool_err}")
    return dict(metric_rel_err=rel, metrics=metrics["cuda"],
                text_grad_norm=norms, trunk_to_float64=to_float64,
                conv_passes_to_float64=conv_err,
                pool_backward_to_float64=pool_err, **gaps)


def pool_backward_errors():
    """Relative L2 distance from float64 of the input gradient of the
    Inception's 3x3 stride-1 average pool (padding 1, the padded cells not
    counted) on cuda in float32, at the shapes of Mixed_5b, Mixed_6b and
    Mixed_7b (B=8), input in channels_last: ``inception.avg_pool3_s1_p1``
    (held to 1e-6 by the caller) and PyTorch's ``avg_pool2d`` on the
    channels_last tensor itself (reported: wrong in torch 2.11)."""
    import torch
    import torch.nn.functional as F

    from eegan_tpu_torch.models.inception import avg_pool3_s1_p1

    plain = lambda x: F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
    gen = torch.Generator().manual_seed(SEED + 302)
    out = {}
    for shape in ((8, 192, 35, 35), (8, 768, 17, 17), (8, 1280, 8, 8)):
        x = torch.randn(shape, generator=gen, dtype=torch.float64)
        dy = torch.randn(shape, generator=gen, dtype=torch.float64)
        for name, pool in (("avg_pool3_s1_p1", avg_pool3_s1_p1),
                           ("avg_pool2d_channels_last", plain)):
            grads = []
            for dev, dt in (("cpu", torch.float64), ("cuda", torch.float32)):
                xx = x.to(dev, dt).contiguous(
                    memory_format=torch.channels_last).requires_grad_(True)
                pool(xx).backward(dy.to(dev, dt))
                grads.append(xx.grad.cpu().double())
            out[f"{name}/{shape}"] = float(
                (grads[1] - grads[0]).norm() / grads[0].norm())
    return out


def conv_pass_errors(encoder64):
    """Relative L2 distance from float64 of the float32 forward, data
    gradient and weight gradient of four of the trunk's convs (the stem,
    Conv2d_2a_3x3, Mixed_6a's stride-2 3x3 and Mixed_6e's 1x7) on cuda
    with cuDNN, TF32 off, on random inputs of their shapes at B=8, input
    and weight in channels_last (as the encoder holds them) and in NCHW;
    with cuDNN's ``fp32_precision="ieee"`` too where this torch has
    it."""
    import inspect

    import torch

    settings = {"allow_tf32_false": dict(allow_tf32=False)}
    if "fp32_precision" in inspect.signature(
            torch.backends.cudnn.flags).parameters:
        settings["fp32_precision_ieee"] = dict(allow_tf32=False,
                                               fp32_precision="ieee")
    gen = torch.Generator().manual_seed(SEED + 301)
    out = {}
    for name, hw in (("Conv2d_1a_3x3", 299), ("Conv2d_2a_3x3", 149),
                     ("Mixed_6a.branch3x3", 35),
                     ("Mixed_6e.branch7x7_2", 17)):
        conv = encoder64.get_submodule(name).conv
        x = torch.randn((DAMSM_PARITY_BATCH, conv.in_channels, hw, hw),
                        generator=gen, dtype=torch.float64)
        geometry = (conv.stride, conv.padding, (1, 1), False, (0, 0), 1)
        w64 = conv.weight.detach()
        y = torch.nn.functional.conv2d(x, w64, None, *geometry[:2])
        dy = torch.randn(y.shape, generator=gen, dtype=torch.float64)
        want = (y, *torch.ops.aten.convolution_backward(
            dy, x, w64, None, *geometry, [True, True, False])[:2])
        for setting, kw in settings.items():
            for layout, fmt in (("channels_last", torch.channels_last),
                                ("nchw", torch.contiguous_format)):
                xc, dyc = (t.float().cuda().contiguous(memory_format=fmt)
                           for t in (x, dy))
                wc = w64.float().cuda().contiguous(memory_format=fmt)
                with torch.backends.cudnn.flags(enabled=True, **kw):
                    got = (torch.nn.functional.conv2d(xc, wc, None,
                                                      *geometry[:2]),
                           *torch.ops.aten.convolution_backward(
                               dyc, xc, wc, None, *geometry,
                               [True, True, False])[:2])
                out[f"{name}/{setting}/{layout}"] = {
                    p: float((g.cpu().double() - w).norm() / w.norm())
                    for p, g, w in zip(("forward", "dgrad", "wgrad"), got,
                                       want)}
    return out


# ---------------------------------------------------------------------------
# Training at scale: activation rematerialisation (phase 17) and the
# data-parallel step (phase 18)
# ---------------------------------------------------------------------------

REMAT_ON = ("RUNTIME.REMAT=true", "RUNTIME.REMAT_D=true",
            "RUNTIME.REMAT_IMAGE_ENCODER=true")
# (name, overrides, timed steps) of the bf16 settings timed at B=32.
REMAT_TIMED_STEPS = 3
REMAT_SETTINGS = (
    ("off", (), REMAT_TIMED_STEPS),
    ("remat", ("RUNTIME.REMAT=true",), REMAT_TIMED_STEPS),
    ("remat_blocks_4_5_6_cum", ("RUNTIME.REMAT=true",
                                "RUNTIME.REMAT_BLOCKS=4,5,6,cum"), 1),
    ("remat_image_encoder", ("RUNTIME.REMAT_IMAGE_ENCODER=true",), 1))
LARGE_BATCH = 192
SAGB_BLOCKS = 7
MESH_RANKS = 2
MESH_BATCH = 8  # global; 4 per rank
NCCL_ITERS = 8
FSDP = 2  # phase 19: data:1,fsdp:2 on phase 18's two gloo ranks


def timed_step(config, batch_size: int, reps: int = REMAT_TIMED_STEPS):
    """(step ms, peak MiB) of the train step at ``batch_size`` on the
    card: random weights, the synthetic batch on the device; the peak
    is that of the steps after the first (``time_host``'s warm-up and
    timed steps)."""
    import torch

    from eegan_tpu_torch.training.state import create_train_state
    from eegan_tpu_torch.training.steps import make_train_step

    models, _ = train_models(config, "cuda")
    state, frozen = create_train_state(config, models)
    step = make_train_step(config, models)
    batch, noise = train_inputs(config, batch_size, SEED + 2)
    dev_batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    for k in ("cap_lens", "unpair_cap_lens", "attr_lens"):
        dev_batch[k] = torch.from_numpy(batch[k])  # host: the packed RNN
    noise = torch.from_numpy(noise).cuda()
    holder = [state, None]

    def run():
        holder[0], holder[1] = step(holder[0], frozen, dev_batch, noise)

    run()  # the optimizers' state exists from here on
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_host(run, reps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    bad = [k for k, v in holder[1].items() if not math.isfinite(float(v))]
    if bad:
        fail(f"train step at B={batch_size}: non-finite metrics {bad}")
    del models, state, frozen, step, holder, dev_batch
    torch.cuda.empty_cache()
    return ms, peak


def phase_remat():
    """(17) REMAT on the card: the float32 step (TF32 off, B=4) with REMAT,
    REMAT_D and REMAT_IMAGE_ENCODER on against the same step with them off,
    from the same weights, batch and noise: metrics, Adam moments, BN
    running stats, and kernel 1 launched again in the backward for every
    recomputed SAGB block; then bf16 step times and peak memory at B=32
    for four settings, and at B=192 with REMAT on."""
    import torch

    from eegan_tpu_torch.config import apply_overrides
    from eegan_tpu_torch.training.state import create_train_state
    from eegan_tpu_torch.training.steps import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    sds = None
    batch, noise = train_inputs(bird_config("float32"), PARITY_BATCH, SEED)
    for name, overrides in (("off", ()), ("on", REMAT_ON)):
        config = apply_overrides(bird_config("float32"), list(overrides))
        models, mods = train_models(config, "cuda", sds)
        if sds is None:
            sds = {k: {n: v.clone() for n, v in m.state_dict().items()}
                   for k, m in mods.items()}
        state, frozen = create_train_state(config, models)
        step = make_train_step(config, models)
        zero_counts()
        state, metrics = step(state, frozen, batch, noise)
        torch.cuda.synchronize()
        runs[name] = dict(counts=read_counts(), metrics=metrics,
                          moments=optimizer_moments(state),
                          sds={k: m.state_dict() for k, m in mods.items()},
                          remat=models.generator.remat)
        del models, state, frozen, step
    if not runs["on"]["remat"] or runs["off"]["remat"]:
        fail("phase 17: REMAT did not reach the generator")
    metric_err = metric_errors(runs["on"]["metrics"], runs["off"]["metrics"],
                               "REMAT step vs plain step")
    moments = moment_distances(runs["on"]["moments"],
                               runs["off"]["moments"])[1]
    if max(moments.values()) > 1e-3:
        fail(f"REMAT step Adam moments vs the plain step: {moments}")
    stats_err = 0.0
    for name in ("generator",):
        for k, v in runs["off"]["sds"][name].items():
            got = runs["on"]["sds"][name][k]
            if k.endswith("num_batches_tracked"):
                if int(got) != int(v) or int(v) != 1:
                    fail(f"REMAT step {k}: {int(got)}, plain {int(v)}")
            elif "running_" in k:
                stats_err = max(stats_err, float((got - v).abs().max()))
    if stats_err > 1e-6:
        fail(f"REMAT step BN running stats {stats_err} from the plain step")
    want_on = launches_of(**dict(TRAIN_LAUNCHES, affine_mask_relu=14
                                 + 2 * SAGB_BLOCKS))
    if runs["off"]["counts"] != launches_of(**TRAIN_LAUNCHES) \
            or runs["on"]["counts"] != want_on:
        fail(f"REMAT step launches {runs['on']['counts']} (expected "
             f"{want_on}), plain {runs['off']['counts']}")
    del runs["off"]["sds"], runs["on"]["sds"]
    torch.cuda.empty_cache()
    log(f"phase 17 parity ok: float32 REMAT step (bird.yml, B="
        f"{PARITY_BATCH}) matches the plain step: max metric err "
        f"{max(metric_err.values())}, moments {moments}, BN stats "
        f"{stats_err}; launches {runs['on']['counts']}")

    times = {}
    for name, overrides, reps in REMAT_SETTINGS:
        config = apply_overrides(bird_config("bfloat16"), list(overrides))
        ms, peak = timed_step(config, TRAIN_BATCH, reps)
        times[name] = dict(batch=TRAIN_BATCH, ms=ms,
                           images_per_s=TRAIN_BATCH / ms * 1e3,
                           peak_mib=peak, overrides=list(overrides),
                           timed_steps=reps)
    config = apply_overrides(bird_config("bfloat16"), ["RUNTIME.REMAT=true"])
    ms, peak = timed_step(config, LARGE_BATCH, reps=3)
    times["remat_large_batch"] = dict(
        batch=LARGE_BATCH, ms=ms, images_per_s=LARGE_BATCH / ms * 1e3,
        peak_mib=peak, overrides=["RUNTIME.REMAT=true"])
    log(f"phase 17 times ok (bf16): {json.dumps(times)}")
    return dict(metric_max_abs_err=metric_err, moments=moments,
                bn_stats_max_abs_err=stats_err,
                launches=runs["on"]["counts"],
                launches_plain=runs["off"]["counts"], times=times)


def state_bytes(state, fsdp: int):
    """What the train state holds on this rank at rest, in bytes, split by
    whether ``fsdp_spec`` shards a leaf over an fsdp axis of ``fsdp``: each
    parameter (under FSDP the rank's slice of a sharded one) with its Adam
    moments and EMA copy; the modules' buffers count as replicated. Also
    the number of leaves the rule shards and their share of the
    parameters' elements."""
    from eegan_tpu_torch.parallel.fsdp import fsdp_spec
    from eegan_tpu_torch.training.state import trained_tensors

    out = dict(sharded=0, replicated=0, sharded_leaves=0, leaves=0)
    elems = [0, 0]
    emas = {id(state.generator): state.g_ema,
            id(state.attr_enhance): state.attr_ema}
    for opt, modules in ((state.g_opt, (state.generator, state.attr_enhance)),
                         *((o, (d,)) for o, d in zip(state.d_opts,
                                                     state.discriminators))):
        for module in modules:
            shapes = ([tuple(p.shape) for p in module.parameters()]
                      if state.shards is None else
                      next(m.shapes for m in state.shards.modules()
                           if m.module is module))
            ema = emas.get(id(module))
            for (name, t), shape in zip(trained_tensors(module, state.shards),
                                        shapes):
                held = [t, *(v for k, v in opt.state[t].items()
                             if k in ("exp_avg", "exp_avg_sq")),
                        *([] if ema is None else [ema[name]])]
                n = sum(x.numel() * x.element_size() for x in held)
                full = math.prod(shape)
                sharded = fsdp_spec(shape, fsdp) is not None
                out["sharded" if sharded else "replicated"] += n
                out["sharded_leaves"] += sharded
                out["leaves"] += 1
                elems[0] += full if sharded else 0
                elems[1] += full
            out["replicated"] += sum(b.numel() * b.element_size()
                                     for b in module.buffers())
    out["total"] = out["sharded"] + out["replicated"]
    out["sharded_element_share"] = elems[0] / elems[1]
    return out


def _mesh_rank(rank: int, port: int, in_path: str, out_path: str,
               fsdp: int = 1) -> None:
    """Rank ``rank`` of phase 18's two gloo ranks on one card (phase 19:
    with an fsdp axis of ``fsdp``). Saves the metrics, the launches, the
    state in the unsharded layout and what the state holds at rest."""
    import torch

    sys.path.insert(0, ROOT)
    from eegan_tpu_torch.parallel import distributed
    from eegan_tpu_torch.parallel.mesh import Mesh
    from eegan_tpu_torch.training.state import (
        create_train_state,
        full_state_dict,
    )
    from eegan_tpu_torch.training.steps import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(f"127.0.0.1:{port}", MESH_RANKS, rank,
                           device="cuda", backend="gloo")
    try:
        inputs = torch.load(in_path, weights_only=False)
        config = bird_config("float32")
        models, mods = train_models(config, "cuda", inputs["weights"])
        mesh = Mesh.current("cuda:0", fsdp=fsdp)
        state, frozen = create_train_state(config, models, mesh)
        step = make_train_step(config, models, mesh=mesh)
        zero_counts()
        state, metrics = step(state, frozen, mesh.shard_batch(inputs["batch"]),
                              mesh.rows(inputs["noise"]))
        torch.cuda.synchronize()
        counts = read_counts()
        metrics = {k: float(v) for k, v in metrics.items()}
        # At rest: no gradients, nothing of the step alive.
        for opt in (state.g_opt, *state.d_opts):
            opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        at_rest = dict(memory_allocated=torch.cuda.memory_allocated(),
                       **state_bytes(state, FSDP))
        full = full_state_dict(state)
        sds = {"generator": full["generator"],
               "attr_enhance": full["attr_enhance"],
               **{f"disc_{i}": sd
                  for i, sd in enumerate(full["discriminators"])}}
        moments = {(name, int(j), key): v
                   for name, sd in (("g", full["g_opt"]),
                                    *((f"d{i}", o) for i, o in
                                      enumerate(full["d_opts"])))
                   for j, slot in sd["state"].items()
                   for key, v in slot.items()}
        torch.save(dict(
            counts=counts, metrics=metrics, at_rest=at_rest,
            sds={k: {n: v.cpu() for n, v in sd.items()}
                 for k, sd in sds.items()},
            moments={k: v.cpu() for k, v in moments.items()}),
            f"{out_path}.{rank}")
    finally:
        distributed.shutdown()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_mesh_step(tmp: str):
    """(18a) the data-parallel step: two gloo ranks on the one card,
    float32 (TF32 off), cfg/bird.yml, global B=8 (4 per rank), one step
    against the single-process step at B=8 on the card: metrics, Adam
    moments, parameters and BN running stats at PERF.md §2's card bars."""
    import torch
    import torch.multiprocessing as mp

    from eegan_tpu_torch.training.state import create_train_state
    from eegan_tpu_torch.training.steps import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = bird_config("float32")
    models, mods = train_models(config, "cuda")
    sds = {k: {n: v.cpu().clone() for n, v in m.state_dict().items()}
           for k, m in mods.items()}
    batch, noise = train_inputs(config, MESH_BATCH, SEED + 5)
    state, frozen = create_train_state(config, models)
    zero_counts()
    state, metrics = make_train_step(config, models)(state, frozen, batch,
                                                     noise)
    torch.cuda.synchronize()
    single_counts = read_counts()
    want = dict(metrics={k: float(v) for k, v in metrics.items()},
                sds={k: m.state_dict() for k, m in mods.items()},
                moments=optimizer_moments(state))
    in_path, out_path = os.path.join(tmp, "mesh_in.pt"), os.path.join(
        tmp, "mesh_out")
    torch.save(dict(weights=sds, batch=batch, noise=noise), in_path)
    t0 = time.perf_counter()
    mp.start_processes(_mesh_rank, args=(_free_port(), in_path, out_path),
                       nprocs=MESH_RANKS, join=True, start_method="spawn")
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(f"{out_path}.{r}", weights_only=False)
             for r in range(MESH_RANKS)]
    result = dict(batch=MESH_BATCH, ranks=MESH_RANKS, backend="gloo",
                  ranks_s=ranks_s, single_launches=single_counts)
    for r, got in enumerate(ranks):
        what = f"mesh step rank {r} vs the single-process step"
        metric_err = metric_errors(got["metrics"], want["metrics"], what)
        moments = moment_distances(got["moments"], want["moments"])[1]
        if max(moments.values()) > 1e-3:
            fail(f"{what}: Adam moments {moments}")
        param_err, bad = adam_param_errors(config, got["sds"], want["sds"])
        if bad:
            fail(f"{what}: params out of bounds in {bad}: {param_err}")
        result[f"rank{r}"] = dict(metric_max_abs_err=max(metric_err.values()),
                                  moments=moments, params=param_err,
                                  launches=got["counts"],
                                  at_rest=got["at_rest"])
    local = MESH_BATCH // MESH_RANKS
    for r, got in enumerate(ranks):
        if got["counts"] != single_counts:
            fail(f"mesh rank {r} launches {got['counts']}, the "
                 f"single-process step {single_counts}")
    log(f"phase 18 mesh ok: {MESH_RANKS} gloo ranks on one card at local "
        f"B={local} (kernel 3 at (Bi, Bt) = ({local}, {MESH_BATCH})) match "
        f"the single-process step at B={MESH_BATCH}: "
        f"{ {r: result[f'rank{r}']['moments'] for r in range(MESH_RANKS)} }; "
        f"launches per rank {ranks[0]['counts']}; {ranks_s:.1f} s")
    return result, dict(in_path=in_path, want=want, ranks=ranks,
                        single_counts=single_counts, config=config)


# Phase 19 holds the FSDP ranks against the data:2 ranks at bars that the
# card's own run-to-run spread of the data:2 step meets with room (two runs
# of the same code differ there: the generator's bilinear mask resize has
# an atomicAdd backward; a rerun's G moments lay 1.11e-6 relative L2 from
# the first run's, PERF.md §6): metrics within 1e-6 relative, each
# optimizer's Adam moments within FSDP_MOMENTS_L2 relative L2, and every
# parameter and BN stat within 1e-6 but for at most FSDP_OFF_SHARE of each
# module's entries (Adam's first step turns a rounding of a near-zero
# gradient into up to 2 lr). A stale gather or a missed average moves
# moments by per cents and whole modules by about lr.
FSDP_MOMENTS_L2 = 1e-5
FSDP_OFF_SHARE = 1e-4


def rank_gaps(got, want):
    """Two ranks' results apart: each metric's relative gap, each
    optimizer moment's relative L2 distance, and per module the largest
    |gap| of its state-dict entries and how many lie beyond 1e-6."""
    import torch

    if set(got["metrics"]) != set(want["metrics"]) \
            or set(got["moments"]) != set(want["moments"]):
        fail("two ranks hold different metrics or moments")
    metrics = max(abs(got["metrics"][k] - v) / (1 + abs(v))
                  for k, v in want["metrics"].items())
    modules = {}
    for name, sd in want["sds"].items():
        if set(got["sds"][name]) != set(sd):
            fail(f"{name}: the two ranks' state dicts have different keys")
        worst, off, n = 0.0, 0, 0
        for k, v in sd.items():
            a = got["sds"][name][k]
            if a.shape != v.shape:
                fail(f"{name}.{k}: shapes {tuple(a.shape)} and "
                     f"{tuple(v.shape)}")
            err = (a.double() - v.double()).abs()
            worst = max(worst, float(err.max()))
            off += int((err > 1e-6).sum())
            n += err.numel()
        modules[name] = dict(max_abs=worst, off_1e6=off, n=n)
    return dict(metrics_rel=metrics,
                moments_rel_l2=moment_distances(got["moments"],
                                                want["moments"])[1],
                modules=modules)


def spawn_ranks(port, in_path, out_path, fsdp):
    """Phase 18's two gloo ranks, started without waiting."""
    import torch.multiprocessing as mp

    return mp.start_processes(_mesh_rank, args=(port, in_path, out_path,
                                                fsdp),
                              nprocs=MESH_RANKS, join=False,
                              start_method="spawn")


def phase_fsdp_step(tmp: str, ctx):
    """(19) FSDP: phase 18's two gloo ranks on the one card at
    data:1,fsdp:2 (float32, TF32 off, global B=8), one step from phase
    18's weights, batch and noise: against the single-process step at
    phase 18's bars, against phase 18's data:2 ranks at the bars above,
    with the single-process step's launches per rank; beside it, the
    data:2 ranks once more, whose distance to phase 18's is the card's own
    spread. The state each rank holds at rest (``memory_allocated`` and
    the state's own bytes) against a data:2 rank's."""
    import torch

    outs = {k: os.path.join(tmp, f"{k}_out") for k in ("fsdp", "again")}
    t0 = time.perf_counter()
    groups = [spawn_ranks(_free_port(), ctx["in_path"], outs["fsdp"], FSDP),
              spawn_ranks(_free_port(), ctx["in_path"], outs["again"], 1)]
    for group in groups:
        while not group.join():
            pass
    ranks_s = time.perf_counter() - t0
    ranks, again = ([torch.load(f"{outs[k]}.{r}", weights_only=False)
                     for r in range(MESH_RANKS)] for k in ("fsdp", "again"))
    want, config = ctx["want"], ctx["config"]
    result = dict(mesh=f"data:{MESH_RANKS // FSDP},fsdp:{FSDP}",
                  batch=MESH_BATCH, ranks=MESH_RANKS, backend="gloo",
                  ranks_s=ranks_s, with_data_parallel_rerun=True)
    for r, got in enumerate(ranks):
        what = f"FSDP rank {r} vs the single-process step"
        metric_err = metric_errors(got["metrics"], want["metrics"], what)
        moments = moment_distances(got["moments"], want["moments"])[1]
        if max(moments.values()) > 1e-3:
            fail(f"{what}: Adam moments {moments}")
        param_err, bad = adam_param_errors(config, got["sds"], want["sds"])
        if bad:
            fail(f"{what}: params out of bounds in {bad}: {param_err}")
        dp = ctx["ranks"][r]
        gaps = rank_gaps(got, dp)
        spread = rank_gaps(again[r], dp)
        if gaps["metrics_rel"] > 1e-6 \
                or max(gaps["moments_rel_l2"].values()) > FSDP_MOMENTS_L2 \
                or any(m["off_1e6"] > FSDP_OFF_SHARE * m["n"]
                       for m in gaps["modules"].values()):
            fail(f"FSDP rank {r} vs data:2 rank {r}: {gaps} (the data:2 "
                 f"rerun: {spread})")
        if got["counts"] != ctx["single_counts"]:
            fail(f"FSDP rank {r} launches {got['counts']}, the "
                 f"single-process step {ctx['single_counts']}")
        rest, dp_rest = got["at_rest"], dp["at_rest"]
        if rest["sharded"] * FSDP != dp_rest["sharded"] \
                or rest["replicated"] != dp_rest["replicated"]:
            fail(f"FSDP rank {r} at rest {rest}, data:2 rank {dp_rest}: "
                 f"the sharded leaves should hold 1/{FSDP}")
        result[f"rank{r}"] = dict(
            metric_max_abs_err=max(metric_err.values()), moments=moments,
            params=param_err, gap_to_data_parallel=gaps,
            data_parallel_rerun_gap=spread, launches=got["counts"],
            at_rest=rest, data_parallel_at_rest=dp_rest,
            state_bytes_ratio=rest["total"] / dp_rest["total"],
            memory_allocated_ratio=(rest["memory_allocated"]
                                    / dp_rest["memory_allocated"]))
    r0 = result["rank0"]

    def summary(g):
        return dict(metrics_rel=g["metrics_rel"],
                    moments_rel_l2=max(g["moments_rel_l2"].values()),
                    max_abs=max(m["max_abs"] for m in g["modules"].values()),
                    off_1e6=sum(m["off_1e6"] for m in g["modules"].values()))

    log(f"phase 19 fsdp ok: {result['mesh']} on one card (gloo) matches the "
        f"single-process step at B={MESH_BATCH} (moments "
        f"{ {r: result[f'rank{r}']['moments'] for r in range(MESH_RANKS)} })"
        f" and the data:2 ranks: {summary(r0['gap_to_data_parallel'])}, "
        f"where a data:2 rerun lies {summary(r0['data_parallel_rerun_gap'])}"
        f"; launches per rank {r0['launches']}; state at rest per rank "
        f"{r0['at_rest']['total']} bytes against "
        f"{r0['data_parallel_at_rest']['total']} "
        f"({r0['state_bytes_ratio']:.4f}x; {r0['at_rest']['sharded_leaves']}"
        f" of {r0['at_rest']['leaves']} leaves sharded, "
        f"{r0['at_rest']['sharded_element_share']:.4f} of the elements), "
        f"memory_allocated {r0['at_rest']['memory_allocated']} against "
        f"{r0['data_parallel_at_rest']['memory_allocated']} "
        f"({r0['memory_allocated_ratio']:.4f}x); both groups {ranks_s:.1f} s")
    return result


def start_nccl_cli(tmp: str, data_dir: str):
    """Start phase 18b in the background: ``python -m eegan_tpu_torch.train
    --distributed`` as one NCCL rank (EEGAN_NUM_PROCESSES=1) on phase 14's
    demo corpus, cfg/bird.yml bf16 B=32, NCCL_ITERS iterations (the mesh
    path's collectives on NCCL). It runs beside phases 15-16's CLIs, which
    time nothing; :func:`phase_nccl_cli` waits for it."""
    os.makedirs(tmp, exist_ok=True)
    port = _free_port()
    env = dict(os.environ, EEGAN_COORDINATOR=f"127.0.0.1:{port}",
               EEGAN_NUM_PROCESSES="1", EEGAN_PROCESS_ID="0")
    args = ["eegan_tpu_torch.train", "--distributed", "--max_epochs", "1",
            "--max_iters", str(NCCL_ITERS), "--output_dir", "nccl",
            "--set", f"SAVE_DIR={tmp}", "--set", f"DATA_DIR={data_dir}",
            "--set", "TEXT.CAPTIONS_PER_IMAGE=2",
            "--set", "TEXT.DAMSM_NAME=''",
            "--set", "RUNTIME.ALLOW_RANDOM_ENCODERS=true",
            "--set", "RUNTIME.PALLAS_AFFINE=true",
            "--set", "RUNTIME.PALLAS_DAMSM=true"]
    out, err = (open(os.path.join(tmp, f"cli.{k}"), "w+")
                for k in ("out", "err"))
    proc = background(subprocess.Popen(
        [sys.executable, "-m", *args], cwd=ROOT, stdout=out, stderr=err,
        text=True, env=env))
    return dict(tmp=tmp, proc=proc, out=out, err=err,
                t0=time.perf_counter())


def phase_nccl_cli(job):
    """(18b) wait for :func:`start_nccl_cli`'s run and check it: rank 0 of
    1 on the NCCL backend, a finite images/s per epoch (taken beside other
    CLIs: not a rate), its checkpoint, generator and metrics."""
    tmp, proc = job["tmp"], job["proc"]
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    cli_s = time.perf_counter() - job["t0"]
    stdout, stderr = job["out"], job["err"]
    for f in (stdout, stderr):
        f.seek(0)
    stdout, stderr = stdout.read(), stderr.read()
    job["out"].close()
    job["err"].close()
    if proc.returncode != 0:
        fail(f"train --distributed exit {proc.returncode}:\n"
             f"{stdout[-4000:]}\n{stderr[-4000:]}")
    if "rank 0 of 1" not in stdout or "backend nccl" not in stdout:
        fail(f"train --distributed did not run as NCCL rank 0 of 1:\n"
             f"{stdout[-2000:]}")
    rates = [float(line.split()[2]) for line in stdout.splitlines()
             if line.startswith("epoch ") and line.endswith("images/s")]
    if not rates or not all(math.isfinite(r) and r > 0 for r in rates):
        fail(f"train --distributed printed no images/s:\n{stdout[-2000:]}")
    for rel in ("Model/state/1.pt", "Model/netG_1.pth",
                "writer/metrics.jsonl"):
        if not os.path.isfile(os.path.join(tmp, "nccl", rel)):
            fail(f"train --distributed did not write {rel}")
    log(f"phase 18 nccl ok: train --distributed, one NCCL rank, "
        f"{NCCL_ITERS} iterations B={TRAIN_BATCH} bf16: {rates[-1]} "
        f"images/s beside phases 15-16's CLIs ({cli_s:.1f} s with "
        f"start-up)")
    return dict(images_per_s=rates[-1], iterations=NCCL_ITERS,
                batch=TRAIN_BATCH, dtype="bfloat16", cli_s=cli_s,
                beside="phases 15-16's CLIs")

# ---------------------------------------------------------------------------
# The learning probes (phase 20)
# ---------------------------------------------------------------------------

# Kernels 1-4 on: the affine kernels through the probes' switches, the
# DAMSM kernels through RUNTIME.PALLAS_DAMSM (on by default; --pallas 1 for
# the words probe).
PROBE_ENV = {"EEGAN_PROBE_PAFFINE": "1", "EEGAN_PROBE_UPFUSE": "1"}
PROBE_STEPS, PROBE_DAMSM_STEPS, PROBE_TRACED = 40, 20, 3
PROBE_WORDS_STEPS = 20  # each arm


def probe_recorder(records):
    """A stand-in for ``training/probes.py:train_and_probe`` that runs it
    with each GAN step's kernel launches and metrics recorded, then traces
    PROBE_TRACED more steps (``profile_steps``: device busy per step); one
    record per loop goes to ``records``."""
    from eegan_tpu_torch.training import probes

    real = probes.train_and_probe

    def recording(step_fn, state, frozen, pool, steps, noise, probe, **kw):
        rec = {"launches": [], "metrics": []}
        capture = not records  # the colour probe: its states for A1
        if capture:
            rec["frozen"] = frozen
            rec["states"] = [("step 0", state_snapshot(state, "cuda"))]

        def step(*args):
            if capture and "inputs" not in rec:
                rec["inputs"] = [(args[2], args[3].clone())]
            before = read_counts()
            out = step_fn(*args)
            after = read_counts()
            rec["launches"].append({k: after[k] - before[k] for k in after})
            rec["metrics"].append({k: float(v) for k, v in out[1].items()})
            return out

        out = real(step, state, frozen, pool, steps, noise, probe, **kw)
        rec["ms_per_step"] = out.train_s / out.steps * 1e3
        b = pool[0]["caps"].shape[0]
        if capture:
            rec["states"].append((f"step {steps}",
                                  state_snapshot(state, "cuda")))
            rec["inputs"].append((pool[(steps + 1) % len(pool)],
                                  noise(steps + 1, b)))
        rec["profile"] = profile_steps(
            lambda: step_fn(state, frozen, pool[1], noise(0, b)),
            PROBE_TRACED, rec["ms_per_step"])
        records.append(rec)
        return out

    return real, recording


def probe_summary(rec, result, keys):
    launches = rec["launches"]
    per_step = {k: launches[0][k] for k in launches[0]}
    if any(row != per_step for row in launches):
        fail(f"phase 20: launches differ between probe steps: {launches}")
    bad = [(i, k, v) for i, m in enumerate(rec["metrics"])
           for k, v in m.items() if not math.isfinite(v)]
    if bad:
        fail(f"phase 20: non-finite probe metrics {bad[:5]}")
    prof = rec["profile"]
    return {"ms_per_step": rec["ms_per_step"],
            "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
            "idle_share": prof["idle_share_vs_untraced_step"],
            "launches_per_step": per_step, "steps": len(launches),
            "result": {k: result[k] for k in keys}}


def probe_switch_checks(rec):
    """A1 at the probes' configuration (GF_DIM = DF_DIM = 16, B = 32,
    float32): from the colour probe's state before its first GAN step and
    after its last, each with the step's own batch and noise, kernels 1-2
    on against off (:func:`affine_switch_check`) with RUNTIME.FUSED_UPSAMPLE
    on and off."""
    from eegan_tpu_torch import validate_learning
    from eegan_tpu_torch.training import probes
    from eegan_tpu_torch.training.state import create_train_state
    from eegan_tpu_torch.training.steps import make_train_step

    out = {}
    for upfuse in (True, False):
        config = validate_learning.build_config(overrides=[
            "RUNTIME.PALLAS_AFFINE=true",
            f"RUNTIME.FUSED_UPSAMPLE={str(upfuse).lower()}"])
        models = probes.build_probe_models(
            config, validate_learning.ColorDataset(config).n_words, 0,
            "cuda")
        state, _ = create_train_state(config, models)
        step_fn = make_train_step(config, models)
        for (label, snap), (batch, noise) in zip(rec["states"],
                                                 rec["inputs"]):
            state_restore(state, snap)
            key = f"UPFUSE={int(upfuse)}, {label}"
            out[key] = affine_switch_check(f"phase 20 ({key})", step_fn,
                                           state, rec["frozen"], batch, noise)
    return out


def phase_probes(tmp: str):
    """(20) the learning probes' own mains on the card at a few steps,
    kernels 1-4 on: the colour probe (20 DAMSM, 40 GAN steps, one probe),
    the words probe's two arms (--pallas 1), the R-precision gate (6 GAN
    steps, the ``test`` CLI's sweep of 64 images as a subprocess on cuda)
    and the IS fine-tune check (10 steps). Per GAN step of each probe
    loop: ms (host clock, synchronised), device busy (3 more steps
    traced), kernel launches (the colour probe and the words arm 14 / 14 /
    1 / 1 / 0, the off arm 14 / 14 / 0 / 0 / 0); every loss finite."""
    from eegan_tpu_torch import (
        validate_is_finetune,
        validate_learning,
        validate_rprecision,
        validate_words,
    )
    from eegan_tpu_torch.training import probes

    import torch

    records = []
    real, recording = probe_recorder(records)
    saved_env = {k: os.environ.get(k) for k in PROBE_ENV}
    os.environ.update(PROBE_ENV)
    probes.train_and_probe = recording
    # The probes run as their CLIs do, with PyTorch's defaults (cuDNN's
    # convs may use TF32, matmuls may not); earlier phases turned TF32 off
    # for their parity checks.
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        t0 = time.perf_counter()
        color = validate_learning.main(
            steps=PROBE_STEPS, damsm_steps=PROBE_DAMSM_STEPS, check=False,
            device="cuda")
        color_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        words = validate_words.main(
            [str(PROBE_WORDS_STEPS), "--arm", "both", "--pallas", "1",
             "--damsm_steps", str(PROBE_DAMSM_STEPS), "--no_check",
             "--device", "cuda"])
        words_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rprec = validate_rprecision.main(
            steps=6, sampling_nums=64, damsm_steps=PROBE_DAMSM_STEPS,
            work_dir=os.path.join(tmp, "rprecision"), check=False,
            device="cuda")
        rprec_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        is_ft = validate_is_finetune.main(steps=10, device="cuda",
                                          check=False)
        is_s = time.perf_counter() - t0
    finally:
        probes.train_and_probe = real
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    seconds = time.perf_counter() - t_start
    if len(records) != 3:
        fail(f"phase 20: {len(records)} probe loops recorded, want 3")
    keys = ("best", "best_step", "final", "final_kind", "passed",
            "train_ms_per_step", "damsm_ms_per_step")
    wkeys = tuple(k for k in keys if k != "passed")
    out = {"colour": probe_summary(records[0], color, keys),
           "words": probe_summary(records[1], words["words"], wkeys),
           "off": probe_summary(records[2], words["off"], wkeys)}
    want = {"colour": launches_of(affine_mask_relu=14,
                                  affine_mask_relu_backward=14,
                                  words_similarity_forward=1,
                                  words_similarity_backward_dr=1)}
    want["words"] = want["colour"]
    want["off"] = launches_of(affine_mask_relu=14,
                              affine_mask_relu_backward=14)
    for name, w in want.items():
        if out[name]["launches_per_step"] != w:
            fail(f"phase 20: {name} probe launches per step "
                 f"{out[name]['launches_per_step']}, want {w}")
    finite = [rprec["value"], rprec["random_init"], *rprec["metrics"].values(),
              is_ft["final_acc"], is_ft["is_good"][0], is_ft["is_noise"][0]]
    if not all(math.isfinite(v) for v in finite):
        fail(f"phase 20: non-finite R-precision or IS results {finite}")
    out["rprecision"] = {k: rprec[k] for k in (
        "value", "random_init", "per_epoch", "separation_sigma", "passed",
        "train_ms_per_step", "damsm_ms_per_step", "sweep_s")}
    out["is_finetune"] = {k: is_ft[k] for k in (
        "final_acc", "is_good", "is_noise", "passed", "step_ms")}
    t0 = time.perf_counter()
    out["moments"] = probe_switch_checks(records[0])
    out["seconds"] = {"colour": color_s, "words": words_s,
                      "rprecision": rprec_s, "is_finetune": is_s,
                      "moments": time.perf_counter() - t0,
                      "total": seconds}
    log(f"phase 20 ok: the probes at a few steps in {seconds:.1f} s; ms per "
        f"GAN step {out['colour']['ms_per_step']:.2f} (colour), "
        f"{out['words']['ms_per_step']:.2f} / {out['off']['ms_per_step']:.2f}"
        f" (words / off arm), device busy "
        f"{out['colour']['device_busy_ms_per_step']:.2f} ms per colour step; "
        f"launches per step {out['colour']['launches_per_step']} (off arm "
        f"{out['off']['launches_per_step']})")
    return out


EVAL_MESH_IMAGES = 256  # phase 21's sweep, float32, B=32 (16 per rank)
EVAL_MESH_SEED = 21
FT_MESH_BATCH = 32  # phase 21's IS fine-tune step, global


def eval_mesh_run(inputs, mesh=None):
    """Phase 21's work in one process, or on one rank of ``mesh``
    (float32, TF32 off): the sweep of EVAL_MESH_IMAGES images with PNGs and
    R-precision (each batch's images, codes and similarities recorded,
    kernel launches counted), on a rank the sweep timed without and with
    PNGs, and one IS fine-tune step at the global batch in float32 and in
    float64 (its metrics, Adam moments and running statistics). In one
    process also a second float32 fine-tune step from the same start (the
    card's spread)."""
    import torch

    from eegan_tpu_torch.evaluation import inception_finetune
    from eegan_tpu_torch.models.factory import to_float64_

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = trainer_config(inputs["data_dir"], "float32")
    tester = eval_tester(config, "cuda", inputs["model_dir"], TRAIN_BATCH,
                         mesh)
    imgs, sims = [], []
    sample, similarities = tester.sample_step, tester._similarities
    tester.sample_step = recorded(sample, imgs)
    tester._similarities = recorded(similarities, sims)
    zero_counts()
    result = tester.generate(inputs["png_dir"], sampling_nums=EVAL_MESH_IMAGES,
                             seed=EVAL_MESH_SEED, compute_r_precision=True,
                             r_val=R_VAL)
    torch.cuda.synchronize()
    out = dict(result=result, launches=read_counts(),
               imgs=[o[-1].float().cpu() for o in imgs],
               codes=[c for c, _ in sims], sims=[s for _, s in sims])
    tester.sample_step, tester._similarities = sample, similarities
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        for pngs in (False, True) if mesh is not None else ():
            mesh.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tester.generate(os.path.join(tmp, str(pngs)),
                            sampling_nums=EVAL_MESH_IMAGES,
                            seed=EVAL_MESH_SEED + 1, compute_r_precision=True,
                            r_val=R_VAL, saving_images=pngs)
            torch.cuda.synchronize()
            seconds[pngs] = time.perf_counter() - t0
    out["sweep_s"] = seconds.get(False)
    out["sweep_with_pngs_s"] = seconds.get(True)

    def finetune(float64=False):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED + 21)
            model = inception_finetune.build_is_model(config, "cuda")
        batch = inputs["ft_batch"]
        if mesh is not None:
            batch = mesh.shard_batch(batch)
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        if float64:
            to_float64_(model)
            batch["img256"] = batch["img256"].double()
        step, init_opt = inception_finetune.make_finetune_step(
            config, model, mesh=mesh)
        opt = init_opt(model)
        metrics = {k: float(v) for k, v in step(opt, batch).items()}
        return dict(metrics=metrics,
                    grads={n: opt.state[p]["exp_avg"].double().cpu()
                           for n, p in model.named_parameters()},
                    stats={k: v.double().cpu()
                           for k, v in model.state_dict().items()
                           if "running_" in k})

    out["finetune"] = finetune()
    out["finetune_float64"] = finetune(float64=True)
    if mesh is None:
        out["finetune_rerun"] = finetune()
    return out


def _eval_rank(rank: int, port: int, in_path: str, out_path: str) -> None:
    """Rank ``rank`` of phase 21's two gloo ranks on one card."""
    import torch

    sys.path.insert(0, ROOT)
    from eegan_tpu_torch.parallel import distributed
    from eegan_tpu_torch.parallel.mesh import Mesh

    distributed.initialize(f"127.0.0.1:{port}", MESH_RANKS, rank,
                           device="cuda", backend="gloo")
    try:
        inputs = torch.load(in_path, weights_only=False)
        torch.save(eval_mesh_run(inputs, Mesh.current("cuda:0")),
                   f"{out_path}.{rank}")
    finally:
        distributed.shutdown()


def png_gaps(got_dir: str, want_dir: str):
    """(names equal, largest pixel gap, share of pixels that differ) of two
    PNG folders."""
    import numpy as np
    from PIL import Image

    names = [sorted(f for f in os.listdir(d) if f.endswith(".png"))
             for d in (got_dir, want_dir)]
    worst, differ, total = 0, 0, 0
    for name in names[1]:
        if name not in names[0]:
            continue
        a, b = (np.asarray(Image.open(os.path.join(d, name))).astype(int)
                for d in (got_dir, want_dir))
        gap = np.abs(a - b)
        worst = max(worst, int(gap.max()))
        differ += int((gap > 0).sum())
        total += gap.size
    return names[0] == names[1], worst, differ / max(total, 1), len(names[1])


def phase_eval_mesh(tmp: str, cli):
    """(21) evaluation over the mesh: two gloo ranks on the one card
    (``Tester(mesh=...)``, ``make_finetune_step(mesh=...)``) against one
    process, on phase 14's corpus and epoch-1 snapshot, float32, TF32 off:
    the sweep of EVAL_MESH_IMAGES images at B=32 (16 rows per rank) with
    PNGs, the images and codes within 1e-3 of their largest, the hits equal
    where the top two similarities differ by more than 1e-3, R-precision
    within the near ties, 14 launches of kernel 1 per rank per batch, the
    PNG folders the same files within one level in at most 1% of pixels;
    the sweep's images/s on the two ranks without and with PNGs; one IS
    fine-tune step at global B=32: loss rtol 1e-4, the head's gradient
    within 1e-3 relative L2, the whole network's within twice the larger
    of the card's rerun spread and the float32 step's distance from
    float64, each running statistic within the larger of 1e-4 of its
    largest and twice that float64 distance; the same step in float64 on
    the ranks and in one process, where rounding no longer hides a fault:
    the gradient (Adam's first moment) within 1e-5 relative L2 over the
    network and in each tensor; and ``cli``, what the ``test``
    CLI with ``--set RUNTIME.MESH=data:2`` gave in phase 16's group of
    CLIs (its two ranks share the card through gloo)."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from eegan_tpu_torch.data.synthetic import synthetic_batch

    t_start = time.perf_counter()
    data_dir = os.path.join(tmp, "trainer", "data")
    model_dir = os.path.join(tmp, "trainer", "run", "Model")
    work = os.path.join(tmp, "eval_mesh")
    os.makedirs(work, exist_ok=True)
    config = trainer_config(data_dir, "float32")
    ft_batch = synthetic_batch(config, FT_MESH_BATCH, seed=SEED + 21)
    inputs = dict(data_dir=data_dir, model_dir=model_dir,
                  ft_batch={k: ft_batch[k] for k in ("img256", "class_ids")})
    in_path, out_path = (os.path.join(work, "in.pt"),
                         os.path.join(work, "out"))
    torch.save(dict(inputs, png_dir=os.path.join(work, "mesh")), in_path)
    t0 = time.perf_counter()
    mp.start_processes(_eval_rank, args=(_free_port(), in_path, out_path),
                       nprocs=MESH_RANKS, join=True, start_method="spawn")
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(f"{out_path}.{r}", weights_only=False)
             for r in range(MESH_RANKS)]
    saved = read_counts()
    one = eval_mesh_run(dict(inputs, png_dir=os.path.join(work, "one")))
    set_counts(saved)

    batches = EVAL_MESH_IMAGES // TRAIN_BATCH
    want_launches = launches_of(affine_mask_relu=14 * batches)
    for r, got in enumerate(ranks):
        if got["launches"] != want_launches:
            fail(f"phase 21: rank {r} launched {got['launches']}, want "
                 f"{want_launches}")
    img_err = max(float((torch.cat([r["imgs"][i] for r in ranks]) - w)
                        .abs().max()) / float(w.abs().max())
                  for i, w in enumerate(one["imgs"]))
    rel = lambda got, want: max(float(np.abs(g - w).max() / np.abs(w).max())
                                for g, w in zip(got, want))
    code_err = max(rel(r["codes"], one["codes"]) for r in ranks)
    sim_err = max(rel(r["sims"], one["sims"]) for r in ranks)
    ties = 0
    for r in ranks:
        for got, want in zip(r["sims"], one["sims"]):
            top2 = np.sort(want, axis=1)[:, -2:]
            close = top2[:, 1] - top2[:, 0] <= 1e-3
            ties += int(close.sum())
            differ = (np.argmax(got, 1) == 0) != (np.argmax(want, 1) == 0)
            if (differ & ~close).any():
                fail(f"phase 21: R-precision hits differ: {got} vs {want}")
    if img_err > 1e-3 or code_err > 1e-3 or sim_err > 1e-3:
        fail(f"phase 21: the ranks' sweep against one process: images "
             f"{img_err}, codes {code_err}, similarities {sim_err}")
    means = [r["result"]["r_precision_mean"] for r in ranks]
    want_mean = one["result"]["r_precision_mean"]
    # A flipped hit moves the mean of 10 clusters' rates by at most this.
    flip = 1 / (10 * (EVAL_MESH_IMAGES // 10))
    if means[0] != means[1] or abs(means[0] - want_mean) > ties * flip \
            + 1e-9:
        fail(f"phase 21: R-precision {means} against {want_mean} with "
             f"{ties} near ties")
    same, px_gap, px_share, n_png = png_gaps(os.path.join(work, "mesh"),
                                             os.path.join(work, "one"))
    if not same or n_png != EVAL_MESH_IMAGES or px_gap > 1 \
            or px_share > 1e-2:
        fail(f"phase 21: PNG folders: same names {same} ({n_png}), largest "
             f"pixel gap {px_gap}, share differing {px_share}")

    # One IS fine-tune step at the global batch.
    want = one["finetune"]
    dist = lambda a, b, keys: float(
        torch.cat([a[k].reshape(-1) - b[k].reshape(-1) for k in keys]).norm()
        / torch.cat([b[k].reshape(-1) for k in keys]).norm())
    names = list(want["grads"])
    head = [n for n in names if n.startswith("fc.")]
    spread = dist(one["finetune_rerun"]["grads"], want["grads"], names)
    f64 = dist(want["grads"], one["finetune_float64"]["grads"], names)
    yardstick = max(spread, f64)
    ft = {}
    for r, got in enumerate(ranks):
        g = got["finetune"]
        loss, want_loss = (g["metrics"]["is_finetune/loss"],
                           want["metrics"]["is_finetune/loss"])
        whole = dist(g["grads"], want["grads"], names)
        head_gap = dist(g["grads"], want["grads"], head)
        stat_bad = []
        for k, v in want["stats"].items():
            bar = max(1e-4 * float(v.abs().max()), 2 * float(
                (v - one["finetune_float64"]["stats"][k]).abs().max()))
            if float((g["stats"][k] - v).abs().max()) > bar:
                stat_bad.append(k)
        g64, w64 = got["finetune_float64"], one["finetune_float64"]
        whole64 = dist(g64["grads"], w64["grads"], names)
        worst64 = max(dist(g64["grads"], w64["grads"], [n]) for n in names)
        ft[f"rank{r}"] = dict(loss=loss, whole_network=whole,
                              head=head_gap, stats_beyond_bar=stat_bad,
                              whole_network_float64=whole64,
                              worst_tensor_float64=worst64)
        if not math.isclose(loss, want_loss, rel_tol=1e-4) \
                or head_gap > 1e-3 or whole > 2 * yardstick or stat_bad \
                or whole64 > 1e-5 or worst64 > 1e-5:
            fail(f"phase 21: fine-tune step rank {r} against one process: "
                 f"loss {loss} vs {want_loss}, head {head_gap}, whole "
                 f"{whole} (bar {2 * yardstick}), running stats beyond "
                 f"their bars {stat_bad[:5]}; in float64 whole {whole64}, "
                 f"worst tensor {worst64} (bar 1e-5)")

    def ips(key, runs):
        return EVAL_MESH_IMAGES / max(run[key] for run in runs)

    times = dict(
        ranks_images_per_s=ips("sweep_s", ranks),
        ranks_images_per_s_with_pngs=ips("sweep_with_pngs_s", ranks))
    result = dict(
        images=EVAL_MESH_IMAGES, batch=TRAIN_BATCH, dtype="float32",
        ranks=MESH_RANKS, backend="gloo", image_rel_err=img_err,
        code_rel_err=code_err, similarity_rel_err=sim_err, near_ties=ties,
        r_precision={"ranks": means[0], "one_process": want_mean},
        launches_per_rank=ranks[0]["launches"],
        png={"files": n_png, "largest_pixel_gap": px_gap,
             "share_differing": px_share},
        finetune=dict(batch=FT_MESH_BATCH, rerun_spread=spread,
                      float64_distance=f64, **ft),
        cli=cli,
        times=times, ranks_s=ranks_s,
        seconds=time.perf_counter() - t_start)
    log(f"phase 21 ok: evaluation over two gloo ranks on one card against "
        f"one process: sweep of {EVAL_MESH_IMAGES} images, images "
        f"{img_err}, codes {code_err}, similarities {sim_err} (near ties "
        f"{ties}), R-precision {means[0]} vs {want_mean}, kernel 1 "
        f"{ranks[0]['launches']['affine_mask_relu']} launches per rank; "
        f"PNGs {n_png} files, {px_share} of pixels one level off; fine-tune "
        f"step {ft} (rerun spread {spread}, float64 distance {f64}); test "
        f"CLI over data:2 (phase 16's group) {cli}; images/s "
        f"{times} (both ranks share the card: no scaling figure); "
        f"{result['seconds']:.1f} s")
    return result


# ---------------------------------------------------------------------------
# The benchmark entry point
# ---------------------------------------------------------------------------

# Short windows: one call of two steps after the warm-up and the counted
# step; no best recipe (the matmul calibration stays on).
BENCH_ENV = {"EEGAN_BENCH_WINDOWS": "1", "EEGAN_BENCH_ITERS": "1",
             "EEGAN_BENCH_SCAN": "2", "EEGAN_BENCH_BEST": "0"}
BENCH_TIMEOUT_S = 600


def bench_step_count(device, width: int = 4, batch: int = 4):
    """``bench.count_step`` of one step of the benchmark's recipe at a
    small width on ``device``: (total, by op)."""
    import torch

    from eegan_tpu_torch import bench
    from eegan_tpu_torch.training.steps import make_train_step

    config, models, state, frozen, stacked, noise = bench.build_recipe(
        bench.knobs({"EEGAN_BENCH_GF": str(width)}), batch, 1,
        torch.device(device))
    ops, _ = bench.count_step(make_train_step(config, models), state, frozen,
                              {k: v[0] for k, v in stacked.items()},
                              noise[0], config, batch)
    return ops["total"], ops["by_op"]


def phase_bench():
    """(22) the benchmark's operation count of one step (GF_DIM=4, B=4)
    the same on the card (cuDNN's LSTM and kernels 3-4 counted from their
    shapes) as on the CPU (their plain versions dispatched); then ``python
    -m eegan_tpu_torch.bench`` as a subprocess with short windows
    (:data:`BENCH_ENV`), alone on the card: its last line has the root
    bench.py's keys and the port's four, a finite ``value`` > 0 and
    ``mfu`` in (0, 1.05), and the DAMSM kernels 3 and 4 launched once per
    step over its timed windows (the benchmark itself refuses a count of
    operations from a call whose launches per step differ)."""
    from eegan_tpu_torch import bench

    saved = read_counts()
    card_ops, card_by_op = bench_step_count("cuda")
    cpu_ops, cpu_by_op = bench_step_count("cpu")
    set_counts(saved)
    if card_ops != cpu_ops:
        fail(f"benchmark step count: card {card_ops} {card_by_op}, CPU "
             f"{cpu_ops} {cpu_by_op}")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "eegan_tpu_torch.bench"], cwd=ROOT,
            env={**os.environ, **BENCH_ENV}, capture_output=True, text=True,
            timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"benchmark: no line within {BENCH_TIMEOUT_S} s")
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"benchmark exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines else {}
    want = set(bench.BENCH_PY_KEYS) | set(bench.ADDED_KEYS)
    if set(line) != want:
        fail(f"benchmark line keys: missing {sorted(want - set(line))}, "
             f"extra {sorted(set(line) - want)}")
    value, mfu = line["value"], line["mfu"]
    if not (isinstance(value, (int, float)) and math.isfinite(value)
            and value > 0):
        fail(f"benchmark value {value}")
    if mfu is None or not 0 < mfu < 1.05:
        fail(f"benchmark mfu {mfu}")
    counted = [ln[len(bench.LAUNCHES):] for ln in proc.stderr.splitlines()
               if ln.startswith(bench.LAUNCHES)]
    launches = json.loads(counted[0]) if counted else {}
    want_launches = launches_of(words_similarity_forward=1,
                                words_similarity_backward_dr=1)
    if launches != want_launches:
        fail(f"benchmark launches per step {launches}, expected "
             f"{want_launches}")
    log(f"phase 22 ok: one step's count at GF_DIM=4, B=4 {card_ops} on "
        f"the card and on the CPU; python -m eegan_tpu_torch.bench with "
        f"{BENCH_ENV}, alone on the card: {value} images/s per card, mfu "
        f"{mfu}, {line['step_tflops']} TFLOP per step, launches per step "
        f"in the timed windows {launches}; {seconds:.1f} s")
    return dict(line=line, launches_per_step=launches, env=BENCH_ENV,
                seconds=seconds, small_step_ops=card_ops,
                small_step_by_op=card_by_op, stderr=proc.stderr[-4000:])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "build",
                                                      "chip_smoke.json"),
                        help="JSON file for the full results")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, ROOT)

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    env = dict(torch=torch.__version__, cuda=torch.version.cuda,
               cudnn=torch.backends.cudnn.version(), python=sys.version.split()[0],
               gpu=name, nvidia_smi=smi, device_count=torch.cuda.device_count())
    log("env " + json.dumps(env))

    watch = Stopwatch()
    # The build runs beside phase 15's DAMSM step parity, which launches no
    # kernel (it sets TF32 off; the later phases start from the defaults).
    build = start_build()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    damsm_parity = watch("phase 15 DAMSM step parity, beside the build",
                         phase_damsm_parity)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32
    build_s = watch("phase 2 build, the rest of it", finish_build, build)

    from eegan_tpu_torch.config import fresh_config

    ngf = fresh_config(os.path.join(ROOT, "cfg", "sample_bird.yml")).GAN.GF_DIM
    train_ngf = bird_config("float32").GAN.GF_DIM
    from eegan_tpu_torch.validate_learning import build_config

    probe_config = build_config()
    probe = (probe_config.GAN.GF_DIM, probe_config.TRAIN.BATCH_SIZE)
    err_f32, err_bf16, zeros_differ = watch(
        "phase 3", phase_kernel_vs_plain, ngf, train_ngf, probe)
    bwd_err = watch("phase 8", phase_affine_backward, train_ngf, probe)
    damsm_err = watch("phase 9", phase_damsm_kernels)
    parity = watch("phase 10", phase_train_parity)
    bf16_train, train = watch("phase 11", phase_train_bf16)
    slice_result, (step_bf16, models_bf16, inputs) = watch(
        "phase 4", phase_slice, ngf)
    watch("phase 5", phase_cli)
    rows, step, step_ms = watch("phase 6", phase_times, ngf, step_bf16,
                                models_bf16, inputs)
    breakdown = watch("phase 7", phase_breakdown, step_bf16, models_bf16,
                      inputs, step["kernel"])
    fwd_rows, bwd_rows, damsm_rows, train_ms, train_runs = watch(
        "phase 12", phase_train_times, train_ngf, train)
    train_breakdown = watch("phase 13", phase_train_breakdown, train,
                            train_ms)
    del train
    with tempfile.TemporaryDirectory() as tmp:
        trainer_dir = os.path.join(tmp, "trainer")
        data_dir = os.path.join(trainer_dir, "data")
        model_dir = os.path.join(trainer_dir, "run", "Model")
        eval_dir = os.path.join(trainer_dir, "eval")
        trainer = watch("phase 14", phase_trainer, trainer_dir)
        # Phase 18's NCCL CLI runs beside the CLIs and the parity check
        # of phases 15-16, which time nothing; this process gives back
        # its cached device memory to the CLIs first.
        gc.collect()
        torch.cuda.empty_cache()
        nccl_job = start_nccl_cli(os.path.join(tmp, "nccl"), data_dir)
        clis = watch("phase 15 CLIs", phase_clis, os.path.join(tmp, "clis"))
        os.makedirs(eval_dir, exist_ok=True)
        evaluation = dict(
            parity=watch("phase 16 parity", phase_eval_parity, data_dir,
                         model_dir),
            clis=watch("phase 16 CLIs", phase_eval_clis, eval_dir,
                       data_dir, model_dir))
        nccl_cli = watch("phase 18 NCCL CLI, the rest of it",
                         phase_nccl_cli, nccl_job)
        evaluation["times"] = watch("phase 16 times", phase_eval_times,
                                    data_dir, model_dir)
        evaluation["overlap"] = watch("phase 16 overlap", phase_eval_overlap,
                                      eval_dir, data_dir)
        remat = watch("phase 17", phase_remat)
        mesh_step, mesh_ctx = watch("phase 18 mesh", phase_mesh_step, tmp)
        mesh = dict(step=mesh_step, nccl_cli=nccl_cli)
        fsdp = watch("phase 19", phase_fsdp_step, tmp, mesh_ctx)
        del mesh_ctx
        probe_runs = watch("phase 20", phase_probes,
                           os.path.join(tmp, "probes"))
        eval_mesh = watch("phase 21", phase_eval_mesh, tmp,
                          evaluation["clis"]["test_mesh"])
    # The benchmark runs alone: this process gives back its cached device
    # memory first.
    gc.collect()
    torch.cuda.empty_cache()
    bench_run = watch("phase 22", phase_bench)

    card = {"gpu": name, "nvidia_smi": smi}
    step_line = {"sample_step": {
        "config": "cfg/sample_bird.yml + RUNTIME.PALLAS_AFFINE=true",
        "batch": BATCH, "dtype": "bfloat16",
        "ms": step["kernel"], "images_per_s": BATCH / step["kernel"] * 1e3,
        "ms_plain_affine": step["plain"], "runs_ms": step_ms, **card}}
    train_line = {"train_step": {
        "config": "cfg/bird.yml + RUNTIME.PALLAS_AFFINE=true "
                  "+ RUNTIME.PALLAS_DAMSM=true",
        "batch": TRAIN_BATCH, "dtype": "bfloat16", "ms": train_ms,
        "images_per_s": TRAIN_BATCH / train_ms * 1e3, "runs_ms": train_runs,
        "launches_per_step": bf16_train["launches_per_step"],
        "float32_parity": parity, **card}}
    trainer_line = {"trainer": {**trainer, **card}}
    eval_line = {"evaluation": {
        **{k: v for k, v in evaluation["times"].items()
           if k != "top_device_ops"},
        "overlap": evaluation["overlap"], "clis": evaluation["clis"],
        "parity": evaluation["parity"], **card}}
    results = {"affine_launches": rows, "affine_train_launches": fwd_rows,
               "affine_backward_launches": bwd_rows,
               "damsm": damsm_rows, **step_line, **train_line,
               **trainer_line, "clis": clis, "damsm_step_parity": damsm_parity,
               "evaluation": evaluation, "remat": remat, "mesh": mesh,
               "fsdp": fsdp, "probes": probe_runs, "eval_mesh": eval_mesh,
               "bench": bench_run,
               "breakdown": breakdown, "train_breakdown": train_breakdown,
               "bf16_train_metrics": bf16_train["metrics"],
               "build_s": build_s, "phase_seconds": watch.seconds,
               "checks": {"affine_max_abs_err": {"float32": err_f32,
                                                 "bfloat16": err_bf16},
                          "affine_relu_zeros_differ_f32": zeros_differ,
                          "affine_backward_max_abs_err": bwd_err,
                          "damsm_max_abs_err": damsm_err,
                          "sample_slice": slice_result},
               **card}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    # Per-launch times and the profiles' operation lists are in the file;
    # standard output keeps the summaries.
    log(json.dumps(step_line))
    log(json.dumps({k: v for k, v in train_line["train_step"].items()
                    if k != "float32_parity"}))
    log(json.dumps(trainer_line))
    log(json.dumps(eval_line))
    log(json.dumps({"remat": {"times": remat["times"],
                              "moments": remat["moments"],
                              "launches": remat["launches"]},
                    "mesh": {"step": {k: v for k, v in mesh["step"].items()
                                      if not k.startswith("rank")},
                             "moments": {r: mesh["step"][f"rank{r}"]["moments"]
                                         for r in range(MESH_RANKS)},
                             "nccl_cli": mesh["nccl_cli"]}, **card}))
    log(json.dumps({"fsdp": {
        "mesh": fsdp["mesh"], "batch": fsdp["batch"],
        "ranks_s": fsdp["ranks_s"],
        **{f"rank{r}": {k: fsdp[f"rank{r}"][k] for k in (
            "moments", "gap_to_data_parallel", "data_parallel_rerun_gap",
            "at_rest", "data_parallel_at_rest", "state_bytes_ratio",
            "memory_allocated_ratio")} for r in range(MESH_RANKS)}},
        **card}))
    log(json.dumps({"probes": {
        **{k: v for k, v in probe_runs.items() if k != "moments"},
        "moments": {k: {m: v[m] for m in ("max_b", "max_c", "per_optimizer")}
                    for k, v in probe_runs["moments"].items()}}, **card}))
    log(json.dumps({"eval_mesh": eval_mesh, **card}))
    log(json.dumps({"bench": bench_run["line"], "env": bench_run["env"],
                    "seconds": bench_run["seconds"]}))
    for key, value in (("breakdown", breakdown),
                       ("train_breakdown", train_breakdown)):
        log(json.dumps({key: {k: v for k, v in value.items()
                              if not k.startswith("top_")}, **card}))

    launches = parity["launches"]
    timed_bwd = ("one train step's 14 backward launches, B=32, bfloat16, "
                 "sum of per-launch medians")
    timed_damsm = "one launch at (Bi, Bt, S, L, D) = (32, 32, 289, 20, 256)"
    kernels = {"kernels": [
        {"name": "affine_mask_relu", "route": "cuda",
         "source": "eegan_tpu_torch/ops/csrc/affine_mask_relu.cu",
         "replaces": "eegan_tpu/ops/affine_pallas.py:60",
         "launches": launches["affine_mask_relu"],
         "launches_sample_step": slice_result["launches"],
         "max_abs_err": err_f32, "max_abs_err_bf16": err_bf16,
         "relu_zeros_differ_f32": zeros_differ,
         "ms": sum(r["ms"] for r in rows),
         "plain_ms": sum(r["plain_ms"] for r in rows),
         "bound_ms": sum(r["bound_ms"] for r in rows),
         "bound_by": "bytes", "library_ms": None,
         "timed": "one generator forward's 14 launches, B=8, bfloat16, "
                  "sum of per-launch medians",
         "train_ms": sum(r["ms"] for r in fwd_rows),
         "train_plain_ms": sum(r["plain_ms"] for r in fwd_rows),
         "train_bound_ms": sum(r["bound_ms"] for r in fwd_rows),
         "train_timed": "one train step's 14 forward launches, B=32, "
                        "bfloat16, sum of per-launch medians"},
        {"name": "affine_mask_relu_backward", "route": "cuda",
         "source": "eegan_tpu_torch/ops/csrc/affine_mask_relu_bwd.cu",
         "replaces": "eegan_tpu/ops/affine_pallas.py:74",
         "launches": launches["affine_mask_relu_backward"],
         "max_abs_err": max(v for k, v in bwd_err.items()
                            if k.endswith("float32")),
         "max_abs_err_bf16": max(v for k, v in bwd_err.items()
                                 if k.endswith("bfloat16")),
         "ms": sum(r["ms"] for r in bwd_rows),
         "plain_ms": sum(r["plain_ms"] for r in bwd_rows),
         "bound_ms": sum(r["bound_ms"] for r in bwd_rows),
         "bound_by": "bytes", "library_ms": None, "timed": timed_bwd},
    ]}
    for kname, replaces, err in (
            ("words_similarity_forward", "_kernel", damsm_err["sims"]),
            ("words_similarity_backward_dr", "_bwd_dr_kernel",
             damsm_err["d_regions"]),
            ("words_similarity_backward_dw", "_bwd_dw_kernel",
             damsm_err["d_words"])):
        line = {"_kernel": 109, "_bwd_dr_kernel": 178,
                "_bwd_dw_kernel": 202}[replaces]
        row = damsm_rows[kname]
        kernels["kernels"].append({
            "name": kname, "route": "cuda",
            "source": "eegan_tpu_torch/ops/csrc/damsm_words.cu",
            "replaces": f"eegan_tpu/ops/damsm_pallas.py:{line}",
            "launches": launches[kname], "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "operations",
            "library_ms": None, "timed": timed_damsm})
    for row in kernels["kernels"]:
        row["launches_trainer_per_iteration"] = \
            trainer["launches_per_iteration"][row["name"]]
        row["launches_trainer_save_images"] = \
            trainer["launches_save_images"][row["name"]]
        row["launches_trainer_epoch"] = trainer["launches_epoch"][row["name"]]
        row["launches_bench_step"] = \
            bench_run["launches_per_step"][row["name"]]
        row["launches_eval_batch"] = \
            evaluation["times"]["launches_per_batch"][row["name"]]
        row["launches_remat_step"] = remat["launches"][row["name"]]
        row["launches_mesh_rank_step"] = \
            mesh["step"]["rank0"]["launches"][row["name"]]
        row["launches_fsdp_rank_step"] = \
            fsdp["rank0"]["launches"][row["name"]]
        row["launches_probe_step"] = \
            probe_runs["colour"]["launches_per_step"][row["name"]]
        row["launches_probe_step_off_arm"] = \
            probe_runs["off"]["launches_per_step"][row["name"]]
        row["launches_eval_mesh_rank_batch"] = \
            eval_mesh["launches_per_rank"][row["name"]] // (
                EVAL_MESH_IMAGES // TRAIN_BATCH)
    log(json.dumps({"phase_seconds": watch.seconds,
                    "total_s": watch.total()}))
    log(json.dumps(kernels))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
