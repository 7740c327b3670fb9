"""The colour probe: does the port's adversarial loop learn? (Counterpart
of the JAX package's ``validate_learning.py``.)

    python -m eegan_tpu_torch.validate_learning [steps] [--dtype bfloat16]
        [--clip 100] [--damsm_steps N] [--seed K] [--device cpu]

K classes, each a solid RGB colour; the caption is the colour word and the
attribute repeats it. The generator only has to learn a constant per
condition. As in the JAX script:

1. DAMSM-pretrain the text BiLSTM and the Inception image encoder on the
   colour corpus (``training/damsm_trainer.py``), and print how far apart
   the classes' sentence embeddings end up;
2. train G and D against the frozen encoders with the DAMSM terms on
   (SIM_COE as in shells/train_cub.sh), GF_DIM = DF_DIM = 16, B = 32;
3. every 250 steps, probe: sample 8 draws of each class caption from the
   live and the EMA weights; a class counts as learned when the mean RGB
   of its draws is nearest its own palette colour; keep the better of the
   two and the best of the sweep.

Pass: best >= 4 of 8 classes (P[Binom(8, 1/8) >= 4] ~ 5.5e-4) and final
>= 2. The JAX package's record (one v5e chip, 3 configurations x 5 seeds
of 3000 steps, float32): 15/15 runs pass; peaks per seed 0-4 baseline
4,8,6,7,6, clip 5,8,8,8,6, raw 5,8,6,7,6.

``EEGAN_PROBE_UPFUSE=1`` turns RUNTIME.FUSED_UPSAMPLE on and
``EEGAN_PROBE_PAFFINE=1`` RUNTIME.PALLAS_AFFINE (kernels 1-2 on a CUDA
device); both are off when unset. RUNTIME.PALLAS_DAMSM keeps its default
(on: kernels 3-4 in the G step on a CUDA device). ``--set KEY=VALUE``
overrides the config after that (tests run tiny widths with it). Runs on
``--device cuda`` (default) and on the CPU only with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from eegan_tpu_torch import resolve_device
from eegan_tpu_torch.config import Config, apply_overrides
from eegan_tpu_torch.training import probes
from eegan_tpu_torch.training.state import create_train_state
from eegan_tpu_torch.training.steps import make_sample_step, make_train_step

PALETTE = np.array([
    [0.9, -0.8, -0.8],   # red
    [-0.8, 0.9, -0.8],   # green
    [-0.8, -0.8, 0.9],   # blue
    [0.9, 0.9, -0.8],    # yellow
    [0.9, -0.8, 0.9],    # magenta
    [-0.8, 0.9, 0.9],    # cyan
    [0.9, 0.9, 0.9],     # white
    [-0.9, -0.9, -0.9],  # black
], np.float32)


class ColorDataset:
    """caption = color word; image = solid class color (+ tiny noise)."""

    def __init__(self, config, size=512):
        self.config = config
        self.size = size
        self.k = len(PALETTE)
        self.n_words = self.k + 2
        self.ixtoword = {0: "<end>", **{i + 1: f"color{i}"
                                        for i in range(self.k)},
                         self.k + 1: "pad"}
        self.wordtoix = {v: k for k, v in self.ixtoword.items()}

    def __len__(self):
        return self.size

    def sample(self, index, rng, augment=True):
        c = self.config
        t = c.TEXT
        cls = index % self.k
        out = {}
        # brightness jitter + noise keep the real manifold from being
        # trivially separable (a saturated D gives the generator no signal)
        scale = 1.0 - 0.25 * rng.random()
        for s in c.imsizes:
            img = (PALETTE[cls] * scale)[None, None, :] + rng.normal(
                0, 0.1, (s, s, 3))
            out[f"img{s}"] = np.clip(img, -1, 1).astype(np.float32)
        caps = np.zeros(t.WORDS_NUM, np.int32)
        caps[0] = cls + 1
        out["caps"] = caps
        out["cap_lens"] = np.int32(1)
        attrs = np.zeros((t.MAX_ATTR_NUM, t.MAX_ATTR_LEN), np.int32)
        attrs[:, 0] = cls + 1
        out["attrs"] = attrs
        out["attr_lens"] = np.ones(t.MAX_ATTR_NUM, np.int32)
        wrong = (cls + int(rng.integers(1, self.k))) % self.k
        u = np.zeros(t.WORDS_NUM, np.int32)
        u[0] = wrong + 1
        out["unpair_caps"] = u
        out["unpair_cap_lens"] = np.int32(1)
        out["class_ids"] = np.int32(cls + 1)
        return out


def build_config(batch: int = 32, dtype: str = "float32", clip: float = 0.0,
                 sim_coe: float = 0.25, class_coe: float = 2.0,
                 ema: float = 0.995, overrides: Sequence[str] = ()) -> Config:
    """The probe's config (``validate_learning.py:135-146`` of the JAX
    package), then ``overrides``."""
    c = Config()
    c.GAN.GF_DIM = 16
    c.GAN.DF_DIM = 16
    c.TRAIN.BATCH_SIZE = batch
    c.TRAIN.CLASS_NUM = len(PALETTE)
    c.TRAIN.SIM_COE = sim_coe  # 0.25 = shells/train_cub.sh recipe
    c.TRAIN.CLASS_COE = class_coe
    c.TRAIN.D_GRAD_CLIP = clip
    c.TRAIN.G_EMA_DECAY = ema
    c.RUNTIME.COMPUTE_DTYPE = dtype
    probes.apply_env_switches(c, unset=False)
    return apply_overrides(c, overrides)


def class_captions(config: Config):
    """(caps, cap_lens, attrs) of the K class captions: the colour word."""
    k, t = len(PALETTE), config.TEXT
    caps = np.zeros((k, t.WORDS_NUM), np.int32)
    caps[:, 0] = np.arange(1, k + 1)
    attrs = np.zeros((k, t.MAX_ATTR_NUM, t.MAX_ATTR_LEN), np.int32)
    attrs[:, :, 0] = np.arange(1, k + 1)[:, None]
    return caps, np.ones(k, np.int32), attrs


def color_score(images: np.ndarray, n_draws: int = probes.N_DRAWS):
    """(correct, mean_rgb (K, 3), nearest (K,)) of K·n_draws NHWC images,
    class-major: a class is right when its draws' mean RGB is nearest its
    own palette colour."""
    k = len(PALETTE)
    mean_rgb = images.reshape(k, n_draws, *images.shape[1:]).mean(
        axis=(1, 2, 3))
    dists = np.linalg.norm(mean_rgb[:, None] - PALETTE[None], axis=-1)
    nearest = np.argmin(dists, axis=1)
    return int((nearest == np.arange(k)).sum()), mean_rgb, nearest


def passed(best: int, final: int) -> bool:
    """The pass rule: the best probe of the sweep beyond chance at p < 1e-3
    (>= 4 of 8) and the final state above chance (>= 2)."""
    return best >= 4 and final >= 2


def run(config: Config, seed: int = 0, steps: int = 3000,
        damsm_steps: int = 300, device="cuda", models=None,
        noise: Optional[probes.NoiseFn] = None,
        probe_noise: Optional[torch.Tensor] = None,
        log: Callable[[str], None] = print,
        snapshot: Optional[Callable[..., None]] = None) -> dict:
    """The probe's loop on ``config``: DAMSM pretraining, ``steps`` GAN
    steps with the sweep. ``models`` (default: built from the seed),
    ``noise(step, b)`` and ``probe_noise`` replace the seeded draws;
    ``snapshot`` is ``probes.train_and_probe``'s."""
    dev = resolve_device(device)
    ds = ColorDataset(config)
    if models is None:
        models = probes.build_probe_models(config, ds.n_words, seed, dev)
    state, frozen = create_train_state(config, models)
    pool = probes.device_pool(ds, config.TRAIN.BATCH_SIZE, seed, dev)

    frozen, damsm, damsm_s = probes.pretrain_encoders(
        config, models, frozen, pool, damsm_steps,
        torch.Generator(dev).manual_seed(probes.damsm_seed(seed)), log)
    k = len(PALETTE)
    caps, cap_lens, attrs = class_captions(config)
    separation = probes.sentence_separation(frozen.text_encoder, caps,
                                            cap_lens, dev)
    log(f"sentence-embedding separation: max off-diag cosine "
        f"{separation:.3f} (want << 1)")

    prompts = probes.repeat_prompts(caps, cap_lens, attrs)
    if probe_noise is None:
        probe_noise = probes.probe_noise_for(len(prompts[0]), config, dev)
    sample = make_sample_step(config, models)

    def probe(st):
        return probes.score_raw_and_ema(st, sample, prompts, probe_noise,
                                        color_score)

    def report(done, metrics, result, kind, sweep):
        log(f"step {done}: errG={float(metrics['errG/total']):.3f} "
            f"D256 real={float(metrics['errD_2/real_sent']):.3f} "
            f"fake={float(metrics['errD_2/fake_sent']):.3f} "
            f"probe {result[0]}/{k} [{kind}] "
            f"(best {sweep.best}/{k} @ {sweep.best_step} "
            f"[{sweep.best_kind}])")

    out = probes.train_and_probe(
        make_train_step(config, models), state, frozen, pool, steps,
        noise or probes.gan_noise(config, seed, dev), probe, report=report,
        snapshot=snapshot)
    correct, mean_rgb, nearest = out.final
    for i in range(k):
        log(f"class {i}: mean rgb {np.round(mean_rgb[i], 2)} -> "
            f"nearest {nearest[i]} ({'OK' if nearest[i] == i else 'X'})")
    best = out.sweep.best
    return {"best": best, "best_step": out.sweep.best_step,
            "final": correct, "k": k,
            "passed": passed(best, correct), "seed": seed,
            "best_kind": out.sweep.best_kind, "final_kind": out.final_kind,
            "mean_rgb": mean_rgb.tolist(), "separation": separation,
            "damsm": damsm, "metrics": out.metrics,
            "train_ms_per_step": out.train_s / max(steps, 1) * 1e3,
            "damsm_ms_per_step": damsm_s / max(damsm_steps, 1) * 1e3}


def main(steps: int = 3000, batch: int = 32, dtype: str = "float32",
         clip: float = 0.0, damsm_steps: int = 300,
         sim_coe: float = 0.25, class_coe: float = 2.0, seed: int = 0,
         ema: float = 0.995, check: bool = True, device="cuda",
         overrides: Sequence[str] = ()) -> dict:
    t0 = time.perf_counter()
    config = build_config(batch, dtype, clip, sim_coe, class_coe, ema,
                          overrides)
    r = run(config, seed=seed, steps=steps, damsm_steps=damsm_steps,
            device=device)
    k, best, correct = r["k"], r["best"], r["final"]
    r["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"metric": "color_conditioning_accuracy_best",
                      "value": best / k, "unit": "fraction",
                      "vs_baseline": correct / k,
                      "best_step": r["best_step"], "final": correct / k,
                      "best": best, "final_count": correct, "k": k,
                      "passed": r["passed"], "seed": seed,
                      "wall_s": r["wall_s"],
                      "train_ms_per_step": r["train_ms_per_step"],
                      "damsm_ms_per_step": r["damsm_ms_per_step"]}),
          flush=True)
    if check:
        if best < 4:
            raise AssertionError(
                f"best sweep score {best}/{k} — conditioning not shown")
        if correct < 2:
            raise AssertionError(f"final state collapsed to {correct}/{k}")
        print("LEARNING PROBE PASSED "
              f"(best {best}/{k} @ step {r['best_step']}, final "
              f"{correct}/{k})")
    return r


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="The colour learning probe "
                                "(PyTorch port)")
    p.add_argument("steps", nargs="?", type=int, default=3000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--clip", type=float, default=0.0)
    p.add_argument("--damsm_steps", type=int, default=300)
    p.add_argument("--sim_coe", type=float, default=0.25)
    p.add_argument("--class_coe", type=float, default=2.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ema", type=float, default=0.995)
    p.add_argument("--no_check", action="store_true",
                   help="report without asserting (campaign mode)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="config override, e.g. --set GAN.GF_DIM=4")
    return p.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    main(steps=a.steps, batch=a.batch, dtype=a.dtype, clip=a.clip,
         damsm_steps=a.damsm_steps, sim_coe=a.sim_coe, class_coe=a.class_coe,
         seed=a.seed, ema=a.ema, check=not a.no_check, device=a.device,
         overrides=a.overrides)
