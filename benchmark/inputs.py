"""Inputs drawn from the seed: the training pool and the captions' pool.

After ``eegan_tpu_torch/data/synthetic.py:synthetic_batch`` at git 310df21
(the real pipeline's keys, dtypes and ranges: NHWC float32 image pyramids
in [-1, 1], captions of 4 to WORDS_NUM words over the vocabulary,
MAX_ATTR_NUM attributes of 1 to MAX_ATTR_LEN words, an unpaired caption,
1-based class ids), drawn in bulk: the images on the device with a
``torch.Generator``, the token ids and lengths with numpy on the host.
The lengths stay on the host, where the program's packed LSTM reads
them, for the reference as for the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def imsizes(model: Dict) -> List[int]:
    tree = model["TREE"]
    return [tree["BASE_SIZE"] * 2 ** i for i in range(tree["BRANCH_NUM"])]


def captions(model: Dict, n_words: int, shape, rng: np.random.Generator
             ) -> Dict[str, np.ndarray]:
    """Captions, lengths, attributes and their lengths of ``shape``
    samples (int32)."""
    t = model["TEXT"]
    T, A, L = t["WORDS_NUM"], t["MAX_ATTR_NUM"], t["MAX_ATTR_LEN"]
    shape = tuple(shape)
    return {
        "caps": rng.integers(1, n_words, shape + (T,), dtype=np.int32),
        "cap_lens": rng.integers(4, T + 1, shape, dtype=np.int32),
        "attrs": rng.integers(1, n_words, shape + (A, L), dtype=np.int32),
        "attr_lens": rng.integers(1, L + 1, shape + (A,), dtype=np.int32),
    }


def train_pool(model: Dict, n_words: int, pool: int, batch: int, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """``pool`` batches of ``batch`` rows, stacked: leaves (pool, batch,
    ...). Lengths (``*_lens``) on the host."""
    rng = np.random.default_rng(seed)
    host = captions(model, n_words, (pool, batch), rng)
    T = model["TEXT"]["WORDS_NUM"]
    host["unpair_caps"] = rng.integers(1, n_words, (pool, batch, T),
                                       dtype=np.int32)
    host["unpair_cap_lens"] = rng.integers(4, T + 1, (pool, batch),
                                           dtype=np.int32)
    host["class_ids"] = rng.integers(1, model["TRAIN"]["CLASS_NUM"] + 1,
                                     (pool, batch), dtype=np.int32)
    out = {k: torch.from_numpy(v) for k, v in host.items()}
    for k in list(out):
        if not k.endswith("_lens"):
            out[k] = out[k].to(device)
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(0, 2 ** 62)))
    for s in imsizes(model):
        img = torch.empty((pool, batch, s, s, 3), device=device)
        out[f"img{s}"] = img.uniform_(-1.0, 1.0, generator=gen)
    return out


def step_batch(pool: Dict[str, torch.Tensor], i: int, device
               ) -> Dict[str, torch.Tensor]:
    """A copy of batch ``i`` of the pool on ``device``, the lengths on the
    host."""
    return {k: v[i].clone() if k.endswith("_lens") else v[i].to(device,
                                                                copy=True)
            for k, v in pool.items()}
