"""Training driver: epoch loop, logging, checkpointing, fixed-batch sampling
(counterpart of ``eegan_tpu/training/trainer.py``; reference
`train.py:105-502`).

* one train step per iteration (``training/steps.py``), or K per call with
  RUNTIME.STEPS_PER_DISPATCH > 1 (``make_multi_train_step``, the same
  steps in order);
* data flows through the deterministic host pipeline and
  :func:`~eegan_tpu_torch.data.pipeline.device_prefetch`;
* the noise of each iteration comes from a ``torch.Generator`` on the
  device seeded from (seed, ``state.step``), and the data order from
  (seed, epoch), so a resumed run draws what an uninterrupted one would;
* checkpoints carry the full train state (``training/checkpoint.py``);
* per-epoch image grids of a fixed batch from the EMA generator (when on),
  a caption/attribute text dump, and scalar metrics every UPDATE_INTERVAL
  iterations on the persistent ``state.step`` (reference tags);
* images/sec and the host's wait on the data pipeline are logged;
* with ``async_eval`` (``evaluation/async_eval.AsyncEvaluator``), each
  saved generator snapshot is scored (FID / R-precision) on a background
  thread while training goes on.

With a ``mesh`` (``parallel/mesh.py``; ``train.py --mesh data:N`` or
``--distributed`` starts one process per device), TRAIN.BATCH_SIZE stays
the global batch and must divide by the ranks; each rank loads its rows
(``DataPipeline(process_index, process_count)``), takes its rows of the
iteration's global noise and runs the mesh step, whose math is the global
batch's. Every rank loads a resume; rank 0 alone writes checkpoints,
``metrics.jsonl``, images and traces, and runs the fixed-batch sampling
(the global batch, eval-mode batch norm) and the overlapped evaluation.
With an fsdp axis (``--mesh data:D,fsdp:F``) the state is sharded
(``parallel/fsdp.py``): every rank then joins the gathers behind each
checkpoint, generator snapshot, image grid and overlapped evaluation, and
rank 0 writes; the checkpoints keep the unsharded layout.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from eegan_tpu_torch import resolve_device
from eegan_tpu_torch.config import Config
from eegan_tpu_torch.data.pipeline import (
    DataPipeline,
    device_prefetch,
    group_batches,
)
from eegan_tpu_torch.models.factory import build_models
from eegan_tpu_torch.parallel.mesh import Mesh
from eegan_tpu_torch.training.checkpoint import (
    FROZEN_DIR,
    CheckpointManager,
    load_frozen_dir,
)
from eegan_tpu_torch.training.logging import (
    MetricWriter,
    StepTimer,
    start_trace,
    stop_trace,
)
from eegan_tpu_torch.training.state import (
    FrozenEncoders,
    TrainState,
    create_train_state,
    full_state_dict,
    generator_weights,
)
from eegan_tpu_torch.training.steps import (
    make_multi_train_step,
    make_sample_step,
    make_train_step,
)
from eegan_tpu_torch.utils.images import (
    mkdir_p,
    save_img_results,
    save_text_results,
)

UPDATE_INTERVAL = 100  # reference train.py:34


def load_frozen_encoders(config: Config,
                         init_frozen: FrozenEncoders) -> FrozenEncoders:
    """Resolve the frozen DAMSM encoders, loading into ``init_frozen``'s
    modules.

    Priority (as the JAX package's): AttnGAN ``.pth`` files (reference
    `train.py:233-248`) > the port's ``frozen_encoders`` directory (as
    ``pretrain_damsm`` writes it; TEXT.DAMSM_NAME may name it or its parent
    ``Model`` dir) > the random init — and that ONLY with the explicit
    RUNTIME.ALLOW_RANDOM_ENCODERS smoke flag; anything else hard-fails. A
    run that silently trains against random encoders has no text
    conditioning at all.
    """
    from eegan_tpu_torch.utils.convert import load_damsm_encoders

    name = config.TEXT.DAMSM_NAME
    if name and name.endswith(".pth") and os.path.isfile(name):
        print(f"loading DAMSM encoders from {name}")
        return load_damsm_encoders(name, init_frozen)
    if name and os.path.isdir(name):
        sub = os.path.join(name, FROZEN_DIR)
        if os.path.isdir(sub):
            name = sub
        print(f"loading DAMSM encoders from directory {name}")
        return load_frozen_dir(name, init_frozen)
    if name and not config.RUNTIME.ALLOW_RANDOM_ENCODERS:
        raise FileNotFoundError(
            f"TEXT.DAMSM_NAME={name!r} is neither a .pth file nor a "
            "frozen_encoders directory")
    if name:
        print(f"WARNING: TEXT.DAMSM_NAME={name!r} not found — using "
              "randomly initialised frozen encoders "
              "(RUNTIME.ALLOW_RANDOM_ENCODERS)")
        return init_frozen
    if not config.RUNTIME.ALLOW_RANDOM_ENCODERS:
        raise RuntimeError(
            "TEXT.DAMSM_NAME is unset: training would proceed with randomly "
            "initialised frozen DAMSM encoders and NO text conditioning. "
            "Point TEXT.DAMSM_NAME at the pretrained encoders (reference "
            "train.py:233-248 hard-requires them), or opt into smoke mode "
            "explicitly with --synthetic / "
            "--set RUNTIME.ALLOW_RANDOM_ENCODERS=true")
    print("WARNING: TEXT.DAMSM_NAME unset — using randomly initialised "
          "frozen encoders (smoke mode)")
    return init_frozen


def noise_seed(seed: int, step: int) -> int:
    """The seed of iteration ``step``'s noise generator: a 63-bit mix of
    (seed, step)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return int(state[0]) & (2 ** 63 - 1)


@contextlib.contextmanager
def ema_weights(state: TrainState):
    """Within the block, the generator and AttrEnhance hold their full EMA
    parameters (when G-EMA is on; under FSDP their full live ones
    otherwise); what they held is put back after. Under FSDP every rank
    must enter (it gathers)."""
    if state.g_ema is None and state.shards is None:
        yield
        return
    g, a = generator_weights(state)
    pairs = [(p, w[name])
             for module, w in ((state.generator, g), (state.attr_enhance, a))
             for name, p in module.named_parameters()]
    held = [p.data for p, _ in pairs]
    for p, w in pairs:
        p.data = w
    try:
        yield
    finally:
        for (p, _), data in zip(pairs, held):
            p.data = data


class Trainer:
    def __init__(self, config: Config, output_dir: str, dataset=None,
                 seed: int = 3407, data_workers: Optional[int] = None,
                 device="cuda", async_eval=None, mesh: Optional[Mesh] = None):
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh else device)
        self.is_main = mesh is None or mesh.rank == 0
        self.config = config
        self.output_dir = output_dir
        self.model_dir = os.path.join(output_dir, "Model")
        self.image_dir = os.path.join(output_dir, "Image")
        if self.is_main:
            mkdir_p(self.image_dir)
            mkdir_p(self.model_dir)
        self.seed = seed
        self.batch_size = config.TRAIN.BATCH_SIZE
        ranks = mesh.size if mesh else 1
        if self.batch_size % ranks:
            raise ValueError(f"batch size {self.batch_size} not divisible "
                             f"by {ranks} ranks")

        # ---- data ----------------------------------------------------
        if dataset is None:
            from eegan_tpu_torch.data.datasets import TextImageDataset

            dataset = TextImageDataset(
                config, split="train",
                preload=config.RUNTIME.DATA_PRELOAD,
                uint8_images=config.RUNTIME.UINT8_TRANSFER)
        self.dataset = dataset
        self.n_words = dataset.n_words
        self.ixtoword = dataset.ixtoword
        workers = (config.RUNTIME.DATA_WORKERS
                   if data_workers is None else data_workers)
        self.pipeline = DataPipeline(
            dataset, self.batch_size, seed=seed, num_workers=workers,
            process_index=mesh.rank if mesh else 0, process_count=ranks)

        # ---- models / state -----------------------------------------
        # The initial weights follow from the seed (drawn on the CPU)
        # without touching the caller's global RNG.
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.models = build_models(config, self.n_words, self.device)
        self.state, init_frozen = create_train_state(config, self.models,
                                                     mesh)
        self.frozen = load_frozen_encoders(config, init_frozen)
        self.train_step = make_train_step(config, self.models, mesh=mesh)
        self.steps_per_dispatch = max(1, config.RUNTIME.STEPS_PER_DISPATCH)
        self.multi_train_step = (
            make_multi_train_step(config, self.models, mesh=mesh)
            if self.steps_per_dispatch > 1 else None)
        self.sample_step = make_sample_step(config, self.models)

        # ---- bookkeeping --------------------------------------------
        self.ckpt = CheckpointManager(self.model_dir)
        self.writer = (MetricWriter(os.path.join(output_dir, "writer"))
                       if self.is_main else None)
        self.start_epoch = 1
        if self.ckpt.latest_epoch() is not None:
            self.state, epoch = self.ckpt.restore_state(self.state)
            self.start_epoch = epoch + 1
            print(f"Resumed from epoch {epoch}")
        self.max_epoch = config.TRAIN.MAX_EPOCH + 1
        self.timer = StepTimer(self.batch_size, device=self.device)
        self.last_metrics = None
        # Host seconds spent waiting for the next batch, and the count.
        self.data_wait_s = 0.0
        self.data_waits = 0
        # Optional overlapped evaluation of each generator snapshot.
        self.async_eval = async_eval

        self._sample_batch = (self._prepare_sampling() if self.is_main
                              else None)

    # ------------------------------------------------------------------
    def _prepare_sampling(self) -> Dict[str, np.ndarray]:
        """Fixed batch for per-epoch visualisation (reference
        `prepare_sampling`, train.py:282-306): the first global batch of
        epoch 0."""
        pipeline = self.pipeline if self.mesh is None else DataPipeline(
            self.dataset, self.batch_size, seed=self.seed)
        batch = next(pipeline.epoch(0))
        save_text_results(
            batch["caps"], batch["cap_lens"], self.ixtoword,
            os.path.join(self.image_dir, "sampling_text.txt"),
            batch.get("attrs"), batch.get("attr_lens"))
        pyramid = [batch[f"img{s}"] for s in self.config.imsizes]
        save_img_results(pyramid, prefix="sample_image",
                         image_dir=self.image_dir)
        return batch

    def step_noise(self, step: int, batch_size: int) -> torch.Tensor:
        """(batch_size, Z_DIM) noise of iteration ``step``; under a mesh,
        ``batch_size`` is the local batch and the rows are this rank's of
        the global batch's noise."""
        gen = torch.Generator(self.device).manual_seed(
            noise_seed(self.seed, step))
        ranks = self.mesh.size if self.mesh else 1
        noise = torch.randn((batch_size * ranks, self.config.GAN.Z_DIM),
                            generator=gen, device=self.device)
        return noise if self.mesh is None else self.mesh.rows(noise)

    def save_images(self, epoch: int) -> None:
        """Sample the fixed batch from the EMA generator (when on), with
        noise seeded from ``epoch``. Under FSDP every rank calls it (the
        weights are gathered) and rank 0 samples."""
        with ema_weights(self.state):
            if not self.is_main:
                return
            b = self._sample_batch
            gen = torch.Generator(self.device).manual_seed(epoch)
            noise = torch.randn((len(b["caps"]), self.config.GAN.Z_DIM),
                                generator=gen, device=self.device)
            imgs = self.sample_step(b["caps"], b["cap_lens"], b["attrs"],
                                    b["attr_lens"], noise)
        save_img_results([im.float().cpu().numpy() for im in imgs],
                         prefix=f"epoch_{epoch}", image_dir=self.image_dir)

    def save_model(self, epoch: int) -> None:
        """Epoch-gated saving (reference `save_model`, train.py:308-319) +
        full-state checkpoint for resume. Rank 0 writes; under FSDP every
        rank gathers."""
        if not (self.is_main or self.state.shards is not None):
            return
        t = self.config.TRAIN
        if epoch == 1 or (epoch >= t.WARMUP_EPOCHS and epoch % t.GSAVE_INTERVAL == 0):
            weights = generator_weights(self.state)
            if self.is_main:
                self.ckpt.save_generator(epoch, self.state, weights)
                print("Save Gen model.")
                if self.async_eval is not None:
                    self._submit_eval(epoch, weights)
        if epoch == 1 or (epoch >= t.WARMUP_EPOCHS and epoch % t.DSAVE_INTERVAL == 0):
            full = full_state_dict(self.state)
            if self.is_main:
                self.ckpt.save_state(epoch, self.state, full)
                print("Save full train state.")

    def _submit_eval(self, epoch: int, weights) -> None:
        """Hand the snapshot the sweep would see (``weights``: the state's
        ``generator_weights``, the EMA weights when on; the live BN stats)
        to the overlapped evaluation."""
        g, a = weights
        if not self.async_eval.submit(
                epoch, g, a, dict(self.state.generator.named_buffers())):
            print(f"[async-eval] busy — skipped epoch {epoch}")

    def _timed(self, batches):
        """``batches``, adding the host's wait for each to data_wait_s."""
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                return
            self.data_wait_s += time.perf_counter() - t0
            self.data_waits += 1
            yield batch

    # ------------------------------------------------------------------
    def train(self, max_epochs: Optional[int] = None,
              max_iters_per_epoch: Optional[int] = None,
              profile_steps: int = 0) -> None:
        """Epoch loop. With ``profile_steps`` > 0, a torch.profiler trace of
        that many steps after two warm-up steps goes to
        <output_dir>/profile/trace.json."""
        end_epoch = self.max_epoch if max_epochs is None \
            else min(self.max_epoch, self.start_epoch + max_epochs)
        profile_at = 2 if profile_steps > 0 else -1
        prof = None
        steps_done = 0
        # A trace covers single steps: K-step calls are split up.
        k = 1 if profile_steps > 0 else self.steps_per_dispatch
        log_every = max(1, UPDATE_INTERVAL // k)
        wait_logged = (self.data_wait_s, self.data_waits)

        for epoch in range(self.start_epoch, end_epoch):
            src = self.pipeline.epoch(epoch)
            if max_iters_per_epoch is not None:
                src = itertools.islice(src, max_iters_per_epoch)
            if k > 1:
                src = group_batches(src, k)
            batches = self._timed(device_prefetch(src, self.device))
            for i, batch in enumerate(batches):
                if steps_done == profile_at and self.is_main:
                    prof = start_trace()
                step = self.state.step
                if k > 1:
                    n_sub, b = batch["caps"].shape[:2]
                    noises = torch.stack([self.step_noise(step + j, b)
                                          for j in range(n_sub)])
                    self.state, metrics = self.multi_train_step(
                        self.state, self.frozen, batch, noises)
                else:
                    n_sub = 1
                    self.state, metrics = self.train_step(
                        self.state, self.frozen, batch,
                        self.step_noise(step, batch["caps"].shape[0]))
                for _ in range(n_sub):
                    self.timer.tick()
                self.last_metrics = metrics
                steps_done += 1
                if prof is not None and \
                        steps_done == profile_at + profile_steps:
                    stop_trace(prof, os.path.join(self.output_dir,
                                                  "profile"))
                    prof = None

                if i % log_every == 0 and self.is_main:
                    # K-stacked metrics reduce by MEAN over the sub-steps
                    # (reference logs each UPDATE_INTERVAL,
                    # train.py:462-498), against the persistent step, so a
                    # resumed run's stream continues where it stopped.
                    scalars = {key: float(v.float().mean())
                               for key, v in metrics.items()}
                    ips = self.timer.images_per_sec
                    if ips is not None:
                        scalars["perf/images_per_sec"] = ips
                    waited = self.data_waits - wait_logged[1]
                    if waited:
                        scalars["perf/data_wait_ms"] = (
                            (self.data_wait_s - wait_logged[0]) / waited
                            * 1e3)
                    wait_logged = (self.data_wait_s, self.data_waits)
                    self.writer.write_scalars(self.state.step, scalars)

            if self.is_main:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                ips = self.timer.images_per_sec
                if ips is not None:
                    print(f"epoch {epoch}: {ips} images/s")
            if self.is_main or self.state.shards is not None:
                self.save_images(epoch)
            self.save_model(epoch)
        if prof is not None:
            stop_trace(prof, os.path.join(self.output_dir, "profile"))

    def close(self):
        if self.async_eval is not None:
            self.async_eval.close()
        self.pipeline.close()
        if self.writer is not None:
            self.writer.close()
