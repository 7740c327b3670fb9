"""Synthetic samples and batches (the port's copy of
``eegan_tpu/data/synthetic.py``).

numpy only, with the shapes, dtypes and keys the real pipeline emits:
NHWC float32 image pyramids in [-1, 1] (``img64``, ``img128``, ``img256``),
captions and their lengths, attributes, an unpaired caption and 1-based
class ids. The same seed (or generator) gives the same arrays as the JAX
package's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from eegan_tpu_torch.config import Config


class SyntheticDataset:
    """Drop-in dataset for smoke training without a corpus on disk.

    Exposes the same `.sample(index, rng)` / `n_words` / `ixtoword` surface
    as `TextImageDataset`.
    """

    def __init__(self, config: Config, size: int = 256, n_words: int = 100):
        self.config = config
        self.size = size
        self.n_words = n_words
        self.ixtoword = {i: f"w{i}" for i in range(n_words)}
        self.ixtoword[0] = "<end>"
        self.wordtoix = {v: k for k, v in self.ixtoword.items()}

    def __len__(self):
        return self.size

    def sample(self, index: int, rng: np.random.Generator,
               augment: bool = True) -> Dict[str, np.ndarray]:
        c, t = self.config, self.config.TEXT
        out: Dict[str, np.ndarray] = {}
        for s in c.imsizes:
            out[f"img{s}"] = rng.uniform(-1, 1, (s, s, 3)).astype(np.float32)
        out["caps"] = rng.integers(1, self.n_words, t.WORDS_NUM).astype(np.int32)
        out["cap_lens"] = np.int32(rng.integers(4, t.WORDS_NUM + 1))
        out["attrs"] = rng.integers(
            1, self.n_words, (t.MAX_ATTR_NUM, t.MAX_ATTR_LEN)).astype(np.int32)
        out["attr_lens"] = rng.integers(
            1, t.MAX_ATTR_LEN + 1, t.MAX_ATTR_NUM).astype(np.int32)
        out["unpair_caps"] = rng.integers(
            1, self.n_words, t.WORDS_NUM).astype(np.int32)
        out["unpair_cap_lens"] = np.int32(rng.integers(4, t.WORDS_NUM + 1))
        out["class_ids"] = np.int32(rng.integers(1, c.TRAIN.CLASS_NUM + 1))
        return out


def synthetic_batch(config: Config, batch_size: int, seed: int = 0,
                    n_words: int = 100) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    t = config.TEXT
    b = batch_size
    batch: Dict[str, np.ndarray] = {}
    for s in config.imsizes:
        batch[f"img{s}"] = rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    batch["caps"] = rng.randint(1, n_words, (b, t.WORDS_NUM)).astype(np.int32)
    batch["cap_lens"] = rng.randint(4, t.WORDS_NUM + 1, (b,)).astype(np.int32)
    batch["attrs"] = rng.randint(
        1, n_words, (b, t.MAX_ATTR_NUM, t.MAX_ATTR_LEN)).astype(np.int32)
    batch["attr_lens"] = rng.randint(
        1, t.MAX_ATTR_LEN + 1, (b, t.MAX_ATTR_NUM)).astype(np.int32)
    batch["unpair_caps"] = rng.randint(
        1, n_words, (b, t.WORDS_NUM)).astype(np.int32)
    batch["unpair_cap_lens"] = rng.randint(
        4, t.WORDS_NUM + 1, (b,)).astype(np.int32)
    batch["class_ids"] = rng.randint(
        1, config.TRAIN.CLASS_NUM + 1, (b,)).astype(np.int32)
    return batch
