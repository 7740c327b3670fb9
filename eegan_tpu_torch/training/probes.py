"""What the learning probes share (``validate_learning``,
``validate_words`` and ``validate_rprecision`` of the port; the JAX
package's root scripts of the same names build it inline).

A probe trains at probe widths on a synthetic task with a known answer:

1. a pool of :data:`POOL_BATCHES` batches from the dataset's first epoch,
   put on the device once (:func:`device_pool`);
2. DAMSM pretraining of the frozen text and image encoders on that pool
   (:func:`pretrain_encoders`), with the sentence-separation diagnostic
   (:func:`sentence_separation`);
3. GAN steps on ``pool[step % len(pool)]``, and every
   :data:`PROBE_EVERY` steps (and at the last) a probe that samples fixed
   prompts from the live and, with G-EMA on, the EMA weights and keeps the
   better score (:func:`train_and_probe`, :func:`score_raw_and_ema`); the
   sweep keeps the best (:class:`Sweep`), as the reference's evaluation
   keeps the best checkpoint of a sweep.

Seeds. Every draw comes from an explicit ``torch.Generator`` or a seeded
CPU RNG whose seed is one of the JAX scripts' per-seed key constants, so
seed *k* names the same run on both sides (the draws differ: JAX's and
torch's random streams are not the same): the initial weights
:func:`init_seed`, DAMSM dropout :func:`damsm_seed`, the GAN steps' noise
:func:`gan_seed`, the probe's noise :data:`PROBE_SEED`. A test hands the
JAX draws over through the ``noise`` hook and ``probe_noise``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from eegan_tpu_torch.config import Config
from eegan_tpu_torch.data.pipeline import LENGTH_KEYS, DataPipeline
from eegan_tpu_torch.models.factory import ModelBundle, build_models
from eegan_tpu_torch.training.damsm_trainer import make_damsm_train_step
from eegan_tpu_torch.training.state import FrozenEncoders, TrainState
from eegan_tpu_torch.training.trainer import ema_weights

POOL_BATCHES = 12
PROBE_EVERY = 250
N_DRAWS = 8  # noise draws per class in a probe
PROBE_SEED = 7

NoiseFn = Callable[[int, int], torch.Tensor]  # (step, batch) -> (B, Z_DIM)
Prompts = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def init_seed(seed: int) -> int:
    return 1000 + seed


def damsm_seed(seed: int) -> int:
    return 11 + seed


def gan_seed(seed: int) -> int:
    return 1 + 7919 * seed


def synchronizer(device) -> Callable[[], None]:
    """A call that waits for ``device``'s queued work (nothing on the
    CPU), for host-clock times."""
    device = torch.device(device)
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def build_probe_models(config: Config, n_words: int, seed: int,
                       device) -> ModelBundle:
    """The modules at their initial weights, drawn on the CPU from
    :func:`init_seed` without touching the caller's global RNG."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(init_seed(seed))
        return build_models(config, n_words, device)


def to_device(batch: Dict, device) -> Dict:
    """A pipeline batch as tensors: the length leaves on the host (the
    packed LSTM reads them there), every other array on ``device``."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t if k in LENGTH_KEYS else t.to(device)
    return out


def device_pool(dataset, batch_size: int, seed: int, device,
                n: int = POOL_BATCHES) -> List[Dict]:
    """The first ``n`` batches of epoch 1 of ``DataPipeline(dataset,
    batch_size, seed)`` (the JAX scripts' pool, batch for batch), on the
    device. The probes' data cycles, so training reads this pool and no
    batch crosses to the device again."""
    pipe = DataPipeline(dataset, batch_size, seed=seed, num_workers=0)
    pool = []
    try:
        for batch in pipe.epoch(1):
            pool.append(to_device(batch, device))
            if len(pool) == n:
                break
    finally:
        pipe.close()
    return pool


def freeze(frozen: FrozenEncoders) -> FrozenEncoders:
    for module in (frozen.text_encoder, frozen.image_encoder):
        module.eval()
        module.requires_grad_(False)
    return frozen


def pretrain_encoders(config: Config, models: ModelBundle,
                      frozen: FrozenEncoders, pool: Sequence[Dict],
                      steps: int, generator: Optional[torch.Generator],
                      log: Callable[[str], None] = print,
                      log_keys: Optional[Dict[str, str]] = None
                      ) -> Tuple[FrozenEncoders, List[Dict[str, float]],
                                 float]:
    """``steps`` DAMSM steps on ``pool[step % len(pool)]`` (the port's
    ``make_damsm_train_step``; ``generator`` draws the dropout masks),
    training ``frozen``'s modules in place; they are frozen again after.
    Every 100 steps logs ``label=value`` for each of ``log_keys`` (label
    -> metric; default the total). Returns the encoders, every step's
    metrics as floats and the steps' synchronised seconds."""
    log_keys = log_keys or {"total": "damsm/total"}
    for module in (frozen.text_encoder, frozen.image_encoder):
        module.requires_grad_(True)
    step, init_opt = make_damsm_train_step(
        config, dataclasses.replace(models, text_encoder=frozen.text_encoder,
                                    image_encoder=frozen.image_encoder))
    opts = init_opt(frozen.text_encoder, frozen.image_encoder)
    history = []
    sync = synchronizer(models.device)
    sync()
    t0 = time.perf_counter()
    for done in range(1, steps + 1):
        metrics = step(opts, pool[done % len(pool)], generator)
        history.append(metrics)
        if done % 100 == 0:
            log(f"damsm step {done}: " + " ".join(
                f"{label}={float(metrics[key]):.3f}"
                for label, key in log_keys.items()))
    sync()
    seconds = time.perf_counter() - t0
    history = [{k: float(v) for k, v in m.items()} for m in history]
    return freeze(frozen), history, seconds


@torch.no_grad()
def sentence_separation(text_encoder, caps: np.ndarray,
                        cap_lens: np.ndarray, device) -> float:
    """The largest cosine between two different captions' sentence
    embeddings (want << 1 after pretraining)."""
    text_encoder.eval()
    _, sent = text_encoder(torch.from_numpy(caps).long().to(device),
                           torch.from_numpy(cap_lens).long())
    sent = sent.float().cpu().numpy()
    sent = sent / np.linalg.norm(sent, axis=1, keepdims=True)
    k = len(caps)
    return float((sent @ sent.T)[~np.eye(k, dtype=bool)].max())


def repeat_prompts(caps: np.ndarray, cap_lens: np.ndarray, attrs: np.ndarray,
                   n_draws: int = N_DRAWS) -> Prompts:
    """Each class's caption and attributes ``n_draws`` times in a row, with
    every attribute of length 1 (the probes' attributes are one word)."""
    rep = lambda a: np.repeat(a, n_draws, axis=0)
    return (rep(caps), rep(cap_lens), rep(attrs),
            np.ones(rep(attrs).shape[:2], np.int32))


def probe_noise_for(n: int, config: Config, device) -> torch.Tensor:
    """The probe's (n, Z_DIM) noise, the same at every probe of a run."""
    gen = torch.Generator(device).manual_seed(PROBE_SEED)
    return torch.randn((n, config.GAN.Z_DIM), generator=gen, device=device)


def gan_noise(config: Config, seed: int, device) -> NoiseFn:
    """The GAN steps' noise: one (b, Z_DIM) draw per step, in step order,
    from a generator seeded with :func:`gan_seed`."""
    gen = torch.Generator(device).manual_seed(gan_seed(seed))
    return lambda step, b: torch.randn((b, config.GAN.Z_DIM), generator=gen,
                                       device=device)


def score_raw_and_ema(state: TrainState, sample, prompts: Prompts,
                      noise: torch.Tensor, scorer):
    """``scorer`` (a function of the (N, H, W, 3) numpy images of the
    largest scale whose result's first item is the count of classes
    right) on the live weights and, with G-EMA on, on the EMA weights;
    the better with its label, "raw" on a tie."""
    def score():
        imgs = sample(*prompts, noise)
        return scorer(imgs[-1].float().cpu().numpy())

    raw = score()
    if state.g_ema is None:
        return raw, "raw"
    with ema_weights(state):
        ema = score()
    return (raw, "raw") if raw[0] >= ema[0] else (ema, "ema")


@dataclasses.dataclass
class Sweep:
    """The best probe of a run (the first to reach it)."""

    best: int = -1
    best_step: int = 0
    best_kind: str = "raw"

    def update(self, step: int, correct: int, kind: str) -> None:
        if correct > self.best:
            self.best, self.best_step, self.best_kind = correct, step, kind


@dataclasses.dataclass
class ProbeRun:
    """What :func:`train_and_probe` returns."""

    sweep: Sweep
    final: tuple  # the last probe's scorer result
    final_kind: str
    metrics: Dict[str, float]  # the last step's
    train_s: float  # synchronised seconds in the GAN steps, probes excluded
    steps: int


def train_and_probe(step_fn, state: TrainState, frozen: FrozenEncoders,
                    pool: Sequence[Dict], steps: int, noise: NoiseFn,
                    probe: Callable[[TrainState], tuple],
                    probe_every: int = PROBE_EVERY,
                    report: Optional[Callable[..., None]] = None,
                    snapshot: Optional[Callable[..., None]] = None
                    ) -> ProbeRun:
    """``steps`` calls of ``step_fn(state, frozen, batch, noise(step, b))``
    on ``pool[step % len(pool)]``; every ``probe_every`` steps and at the
    last, ``snapshot(step, state, frozen, pool)`` (to save the state),
    ``probe(state) -> (result, kind)`` and
    ``report(step, metrics, result, kind, sweep)``. The last probe is the
    final score."""
    sync = synchronizer(next(state.generator.parameters()).device)
    b = pool[0]["caps"].shape[0]
    sweep = Sweep()
    final, kind, metrics, train_s = None, "raw", {}, 0.0
    sync()
    t0 = time.perf_counter()
    for done in range(1, steps + 1):
        state, metrics = step_fn(state, frozen, pool[done % len(pool)],
                                 noise(done, b))
        if done % probe_every == 0 or done == steps:
            sync()
            train_s += time.perf_counter() - t0
            if snapshot is not None:
                snapshot(done, state, frozen, pool)
            final, kind = probe(state)
            sweep.update(done, final[0], kind)
            if report is not None:
                report(done, metrics, final, kind, sweep)
            sync()
            t0 = time.perf_counter()
    return ProbeRun(sweep=sweep, final=final, final_kind=kind,
                    metrics={k: float(v) for k, v in metrics.items()},
                    train_s=train_s, steps=steps)


def apply_env_switches(config: Config, unset: Optional[bool] = None
                       ) -> Config:
    """The probes' switches from the environment: ``EEGAN_PROBE_UPFUSE``
    sets RUNTIME.FUSED_UPSAMPLE and ``EEGAN_PROBE_PAFFINE``
    RUNTIME.PALLAS_AFFINE, ``1`` on and anything else off; an unset one
    leaves the config's value, or sets ``unset`` when given."""
    rt = config.RUNTIME
    for name, key in (("EEGAN_PROBE_UPFUSE", "FUSED_UPSAMPLE"),
                      ("EEGAN_PROBE_PAFFINE", "PALLAS_AFFINE")):
        value = os.environ.get(name)
        if value is not None:
            setattr(rt, key, value == "1")
        elif unset is not None:
            setattr(rt, key, unset)
    return config
