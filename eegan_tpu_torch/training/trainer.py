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

One device: the JAX package's meshes and FSDP are not ported
(RUNTIME.MESH is ignored; ``train.py`` refuses the flags).
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
    """Within the block, the generator and AttrEnhance hold their EMA
    parameters (when G-EMA is on); the live ones are put back after."""
    if state.g_ema is None:
        yield
        return
    pairs = [(p, ema[name])
             for module, ema in ((state.generator, state.g_ema),
                                 (state.attr_enhance, state.attr_ema))
             for name, p in module.named_parameters()]
    live = [p.detach().clone() for p, _ in pairs]
    with torch.no_grad():
        for p, e in pairs:
            p.copy_(e)
    try:
        yield
    finally:
        with torch.no_grad():
            for (p, _), saved in zip(pairs, live):
                p.copy_(saved)


class Trainer:
    def __init__(self, config: Config, output_dir: str, dataset=None,
                 seed: int = 3407, data_workers: Optional[int] = None,
                 device="cuda", async_eval=None):
        self.device = resolve_device(device)
        self.config = config
        self.output_dir = output_dir
        self.model_dir = os.path.join(output_dir, "Model")
        self.image_dir = os.path.join(output_dir, "Image")
        mkdir_p(self.image_dir)
        mkdir_p(self.model_dir)
        self.seed = seed
        self.batch_size = config.TRAIN.BATCH_SIZE

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
        self.pipeline = DataPipeline(dataset, self.batch_size, seed=seed,
                                     num_workers=workers)

        # ---- models / state -----------------------------------------
        # The initial weights follow from the seed (drawn on the CPU)
        # without touching the caller's global RNG.
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.models = build_models(config, self.n_words, self.device)
        self.state, init_frozen = create_train_state(config, self.models)
        self.frozen = load_frozen_encoders(config, init_frozen)
        self.train_step = make_train_step(config, self.models)
        self.steps_per_dispatch = max(1, config.RUNTIME.STEPS_PER_DISPATCH)
        self.multi_train_step = (make_multi_train_step(config, self.models)
                                 if self.steps_per_dispatch > 1 else None)
        self.sample_step = make_sample_step(config, self.models)

        # ---- bookkeeping --------------------------------------------
        self.ckpt = CheckpointManager(self.model_dir)
        self.writer = MetricWriter(os.path.join(output_dir, "writer"))
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

        self._sample_batch = self._prepare_sampling()

    # ------------------------------------------------------------------
    def _prepare_sampling(self) -> Dict[str, np.ndarray]:
        """Fixed batch for per-epoch visualisation (reference
        `prepare_sampling`, train.py:282-306)."""
        batch = next(self.pipeline.epoch(0))
        save_text_results(
            batch["caps"], batch["cap_lens"], self.ixtoword,
            os.path.join(self.image_dir, "sampling_text.txt"),
            batch.get("attrs"), batch.get("attr_lens"))
        pyramid = [batch[f"img{s}"] for s in self.config.imsizes]
        save_img_results(pyramid, prefix="sample_image",
                         image_dir=self.image_dir)
        return batch

    def step_noise(self, step: int, batch_size: int) -> torch.Tensor:
        """(batch_size, Z_DIM) noise of iteration ``step``."""
        gen = torch.Generator(self.device).manual_seed(
            noise_seed(self.seed, step))
        return torch.randn((batch_size, self.config.GAN.Z_DIM),
                           generator=gen, device=self.device)

    def save_images(self, epoch: int) -> None:
        """Sample the fixed batch from the EMA generator (when on), with
        noise seeded from ``epoch``."""
        b = self._sample_batch
        gen = torch.Generator(self.device).manual_seed(epoch)
        noise = torch.randn((len(b["caps"]), self.config.GAN.Z_DIM),
                            generator=gen, device=self.device)
        with ema_weights(self.state):
            imgs = self.sample_step(b["caps"], b["cap_lens"], b["attrs"],
                                    b["attr_lens"], noise)
        save_img_results([im.float().cpu().numpy() for im in imgs],
                         prefix=f"epoch_{epoch}", image_dir=self.image_dir)

    def save_model(self, epoch: int) -> None:
        """Epoch-gated saving (reference `save_model`, train.py:308-319) +
        full-state checkpoint for resume."""
        t = self.config.TRAIN
        if epoch == 1 or (epoch >= t.WARMUP_EPOCHS and epoch % t.GSAVE_INTERVAL == 0):
            self.ckpt.save_generator(epoch, self.state)
            print("Save Gen model.")
            if self.async_eval is not None:
                self._submit_eval(epoch)
        if epoch == 1 or (epoch >= t.WARMUP_EPOCHS and epoch % t.DSAVE_INTERVAL == 0):
            self.ckpt.save_state(epoch, self.state)
            print("Save full train state.")

    def _submit_eval(self, epoch: int) -> None:
        """Hand the snapshot the sweep would see (the EMA weights when on,
        the live BN stats) to the overlapped evaluation."""
        st = self.state
        g = st.g_ema or dict(st.generator.named_parameters())
        a = st.attr_ema or dict(st.attr_enhance.named_parameters())
        if not self.async_eval.submit(epoch, g, a,
                                      dict(st.generator.named_buffers())):
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
                if steps_done == profile_at:
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

                if i % log_every == 0:
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

            self.save_images(epoch)
            self.save_model(epoch)
        if prof is not None:
            stop_trace(prof, os.path.join(self.output_dir, "profile"))

    def close(self):
        if self.async_eval is not None:
            self.async_eval.close()
        self.pipeline.close()
        self.writer.close()
