"""Checkpoint evaluation sweep: bulk generation + R-precision (counterpart
of ``eegan_tpu/evaluation/tester.py``; reference `Tester`,
`test.py:74-374`).

For each epoch's generator snapshot (``netG_<epoch>.pth`` +
``attr_enhance_<epoch>.pth``) and repeat, generate ``sampling_nums`` 256²
images from test-set captions into ``GenImage/Epoch_{e}_{r}/`` (the input of
the FID and IS folder sweeps), and optionally score R-precision: rank the
true caption against 99 wrong-class captions by DAMSM cosine similarity, a
hit iff it ranks first, mean±std over 10 clusters (reference
`test.py:306-357`).

* Every test caption is encoded once per Tester into a host-side
  embedding cache; the wrong captions are vectorised index draws into it.
* The draws on the numpy ``Generator`` come in the JAX package's order
  (the batches, the cache's caption padding on first use, the wrong
  indices), so a seed gives the JAX package's captions and wrong captions.
* The noise cannot be JAX's: ``generate`` takes ``noise_fn(batch_idx,
  batch_size)``, by default a ``torch.Generator`` on the device seeded from
  (seed, batch_idx).
* The image encoder reads the generator's 256² output where it lies; only
  the (B, D) code comes to the host.
* PNGs are written by a background thread, so generation never waits on
  PNG encoding.

One device: the JAX package's mesh argument is the parallel item of
ROADMAP.md Queue 1.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from eegan_tpu_torch.config import Config
from eegan_tpu_torch.data.datasets import TextOnlyDataset, pad_caption
from eegan_tpu_torch.models.factory import ModelBundle
from eegan_tpu_torch.training.state import FrozenEncoders
from eegan_tpu_torch.training.steps import make_sample_step
from eegan_tpu_torch.training.trainer import noise_seed
from eegan_tpu_torch.utils.images import mkdir_p, save_img_results_one_by_one

NoiseFn = Callable[[int, int], torch.Tensor]


class Tester:
    """Generation and R-precision over ``models``' generator and
    AttrEnhance (whatever weights they hold) and the frozen encoders."""

    def __init__(self, config: Config, models: ModelBundle,
                 frozen: FrozenEncoders,
                 dataset: Optional[TextOnlyDataset] = None,
                 batch_size: Optional[int] = None):
        self.config = config
        self.models = models
        self.frozen = frozen
        self.device = models.device
        self.dataset = dataset or TextOnlyDataset(config, split="test")
        self.batch_size = batch_size or config.TRAIN.BATCH_SIZE
        self.sample_step = make_sample_step(config, models)
        # Built on first use: one encode per test caption per Tester (the
        # frozen text encoder never changes).
        self._cap_cache: Optional[np.ndarray] = None

    def noise_fn(self, seed: int) -> NoiseFn:
        """The default noise: batch ``batch_idx``'s (B, Z_DIM) normal draw
        from a ``torch.Generator`` on the device seeded from (seed,
        batch_idx)."""
        z_dim = self.config.GAN.Z_DIM

        def noise(batch_idx: int, batch_size: int) -> torch.Tensor:
            gen = torch.Generator(self.device).manual_seed(
                noise_seed(seed, batch_idx))
            return torch.randn((batch_size, z_dim), generator=gen,
                               device=self.device)
        return noise

    def _encode_sents(self, caps: np.ndarray, lens: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            _, sent = self.frozen.text_encoder(
                torch.from_numpy(np.asarray(caps)).to(self.device),
                torch.from_numpy(np.asarray(lens)))
        return sent.float().cpu().numpy()

    def _encode_image(self, img256: torch.Tensor) -> np.ndarray:
        with torch.inference_mode():
            _, code = self.frozen.image_encoder(img256)
        return code.float().cpu().numpy()

    # ------------------------------------------------------------------
    def _batches(self, total: int, rng: np.random.Generator):
        """Cycle the test set until ``total`` samples are drawn
        (reference `traverse_dataset_30k`, test.py:244-278)."""
        n = len(self.dataset)
        drawn = 0
        order = rng.permutation(n)
        pos = 0
        while drawn < total:
            idxs = []
            while len(idxs) < self.batch_size:
                if pos == len(order):
                    order = rng.permutation(n)
                    pos = 0
                idxs.append(int(order[pos]))
                pos += 1
            samples = [self.dataset.sample(i, rng) for i in idxs]
            batch = {k: (np.stack([s[k] for s in samples])
                         if not isinstance(samples[0][k], str)
                         else [s[k] for s in samples])
                     for k in samples[0]}
            drawn += self.batch_size
            yield batch

    def _caption_cache(self, rng: np.random.Generator) -> np.ndarray:
        """(n_captions, D) sentence embeddings of every scorable test
        caption, encoded once, in chunks."""
        if self._cap_cache is not None:
            return self._cap_cache
        ds = self.dataset
        n_caps = ds.img_sum * ds.embeddings_num
        t = ds.words_num
        caps = np.zeros((n_caps, t), np.int32)
        lens = np.zeros((n_caps,), np.int32)
        for i in range(n_caps):
            caps[i], lens[i] = pad_caption(ds.captions[i], t, rng)
        chunk = self.batch_size * max(1, 256 // self.batch_size)
        self._cap_cache = np.concatenate([
            self._encode_sents(caps[s:s + chunk], lens[s:s + chunk])
            for s in range(0, n_caps, chunk)])
        return self._cap_cache

    def _sample_wrong_indices(self, cls_ids: np.ndarray,
                              rng: np.random.Generator,
                              n_wrong: int) -> np.ndarray:
        """(B, n_wrong) caption indices from other classes — the
        reference's draw-then-walk-forward sampler
        (`get_sent_multi_unpair`, datasets.py:509-529) vectorised over the
        batch."""
        ds = self.dataset
        b = len(cls_ids)
        img_idx = rng.integers(0, ds.img_sum, size=(b, n_wrong))
        img_cls = np.asarray(ds.class_id)[:ds.img_sum]
        bad = img_cls[img_idx] == cls_ids[:, None]
        while bad.any():
            img_idx[bad] = (img_idx[bad] + 1) % ds.img_sum
            bad = img_cls[img_idx] == cls_ids[:, None]
        sub = rng.integers(0, ds.embeddings_num, size=(b, n_wrong))
        return img_idx * ds.embeddings_num + sub

    def _similarities(self, batch, img256: torch.Tensor, r_val: int,
                      rng: np.random.Generator):
        """(code (B, D), sims (B, r_val)): the image codes of ``img256``
        (on the device) and their cosine similarity to the true caption
        (column 0) and r_val-1 wrong ones from the cache (reference
        `cal_sim_one_by_one`, test.py:306-357)."""
        cache = self._caption_cache(rng)
        wrong_idx = self._sample_wrong_indices(
            np.asarray(batch["class_ids"]), rng, r_val - 1)
        wrong = cache[wrong_idx]  # (B, r-1, D)
        true = self._encode_sents(batch["caps"], batch["cap_lens"])
        sent = np.concatenate([true[:, None, :], wrong], axis=1)
        code = self._encode_image(img256)
        sims = np.einsum("bd,brd->br", code, sent)
        sims /= np.maximum(
            np.linalg.norm(code, axis=-1, keepdims=True)
            * np.linalg.norm(sent, axis=-1), 1e-8)
        return code, sims

    def _r_precision_batch(self, batch, img256: torch.Tensor, r_val: int,
                           rng: np.random.Generator) -> np.ndarray:
        """Per sample: the true caption ranks first."""
        _, sims = self._similarities(batch, img256, r_val, rng)
        return np.argmax(sims, axis=1) == 0

    # ------------------------------------------------------------------
    def generate(self, out_dir: str, sampling_nums: int = 30000,
                 seed: int = 100, compute_r_precision: bool = False,
                 r_val: int = 100, clusters: int = 10,
                 saving_images: bool = True,
                 noise_fn: Optional[NoiseFn] = None) -> Dict[str, float]:
        """Generate ``sampling_nums`` 256² images with the weights the
        modules hold, optionally scoring R-precision along the way. With
        ``saving_images=False`` nothing is written (reference
        `--saving_image`, test.py:226-234)."""
        rng = np.random.default_rng([seed])
        noise_fn = noise_fn or self.noise_fn(seed)
        hits: List[np.ndarray] = []

        q: "queue.Queue" = queue.Queue(maxsize=8)
        errors: List[BaseException] = []
        wt = None
        if saving_images:
            mkdir_p(out_dir)

            def writer():
                while True:
                    item = q.get()
                    if item is None:
                        return
                    if errors:
                        continue  # drain, so the producer never blocks
                    try:
                        save_img_results_one_by_one(*item, out_dir)
                    except Exception as e:  # raised on the caller's thread
                        errors.append(e)

            wt = threading.Thread(target=writer, daemon=True)
            wt.start()

        produced = 0
        try:
            for batch_idx, batch in enumerate(
                    self._batches(sampling_nums, rng)):
                b = len(batch["caps"])
                imgs = self.sample_step(
                    batch["caps"], batch["cap_lens"], batch["attrs"],
                    batch["attr_lens"], noise_fn(batch_idx, b))
                dev256 = imgs[-1]
                take = min(b, sampling_nums - produced)
                if saving_images:
                    names = [f"{k.replace('/', '_')}_{batch_idx}_{j}"
                             for j, k in enumerate(batch["keys"])]
                    q.put((dev256[:take].cpu().numpy(), names[:take]))
                if compute_r_precision:
                    hits.append(self._r_precision_batch(batch, dev256,
                                                        r_val, rng))
                produced += take
        finally:
            if wt is not None:
                q.put(None)
                wt.join()
        if errors:
            raise errors[0]

        out = {"generated": float(produced)}
        if compute_r_precision and hits:
            all_hits = np.concatenate(hits)[:sampling_nums]
            rates = [float(np.mean(c))
                     for c in np.array_split(all_hits, clusters) if len(c)]
            out["r_precision_mean"] = float(np.mean(rates))
            out["r_precision_std"] = float(np.std(rates))
        return out

    def sweep(self, ckpt_manager, select_epochs: Sequence[int],
              repeat_times: int, gen_root: str, sampling_nums: int = 30000,
              compute_r_precision: bool = False,
              saving_images: bool = True) -> Dict:
        """Epoch×repeat sweep (reference `Tester.main`, test.py:184-242);
        an epoch without a generator snapshot is skipped."""
        results = {}
        available = set(ckpt_manager.available_generator_epochs())
        for epoch in select_epochs:
            if epoch not in available:
                print(f"epoch {epoch}: no checkpoint under "
                      f"{ckpt_manager.model_dir}")
                continue
            ckpt_manager.load_generator(epoch, self.models.generator,
                                        self.models.attr_enhance)
            for r in range(repeat_times):
                out_dir = os.path.join(gen_root, f"Epoch_{epoch}_{r}")
                res = self.generate(
                    out_dir, sampling_nums=sampling_nums,
                    seed=epoch * 1000 + r,
                    compute_r_precision=compute_r_precision,
                    saving_images=saving_images)
                results[(epoch, r)] = res
                print(f"Epoch_{epoch}_{r}: {res}")
        return results
