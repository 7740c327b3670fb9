"""Synthetic training batches (the port's copy of
``eegan_tpu/data/synthetic.py::synthetic_batch``).

numpy only, with the shapes, dtypes and keys the real pipeline emits:
NHWC float32 image pyramids in [-1, 1] (``img64``, ``img128``, ``img256``),
captions and their lengths, attributes, an unpaired caption and 1-based
class ids. The same seed gives the same arrays as the JAX package's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from eegan_tpu_torch.config import Config


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
