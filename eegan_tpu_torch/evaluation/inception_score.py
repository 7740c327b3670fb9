"""Inception Score on the device (counterpart of
``eegan_tpu/evaluation/inception_score.py``; the scoring math of reference
`metrics/IS_TF/inception_score.py:64-107`): per split, IS = exp(mean
KL(p(y|x) || p(y))), 10 splits, over the port's Inception-v3.

The reference scores with StackGAN's fine-tuned classifiers (50 bird / 20
flower classes + 1 background class, sliced off, reference :41-51,99); the
port trains one with ``evaluation/inception_finetune.py``. With random or
1000-class weights the scores are not comparable to published numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from eegan_tpu_torch import resolve_device
from eegan_tpu_torch.evaluation.fid import image_paths, load_resized
from eegan_tpu_torch.models.inception import InceptionV3
from eegan_tpu_torch.models.layers import resize_bilinear_half_pixel


def inception_score_from_probs(probs: np.ndarray, splits: int = 10
                               ) -> Tuple[float, float]:
    """exp(mean KL) per split, mean±std over splits (reference
    :99-107)."""
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        marginal = np.mean(part, axis=0, keepdims=True)
        kl = part * (np.log(np.maximum(part, 1e-30))
                     - np.log(np.maximum(marginal, 1e-30)))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))


class InceptionScorer:
    """Batched softmax probabilities on the device + split scoring.

    ``model``: an ``InceptionV3(num_classes)`` with the classifier's
    weights (``load_is_classifier``, or a torchvision ``.pth``); without
    one the weights are random from ``seed`` and ``finetuned`` is False.
    ``drop_background``: class 0 is the fine-tuned classifiers' background
    class, left out of the softmax (reference :99)."""

    def __init__(self, model: Optional[InceptionV3] = None,
                 num_classes: int = 51, drop_background: bool = True,
                 batch_size: int = 64, device="cuda", seed: int = 0):
        self.device = resolve_device(device)
        self.finetuned = model is not None
        if model is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                model = InceptionV3(num_classes=num_classes)
        self.model = model.to(self.device,
                              memory_format=torch.channels_last).eval()
        self.batch_size = batch_size
        self.drop_background = drop_background

    def probs_device(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) images in [-1, 1] -> (N, classes) probabilities on
        the device."""
        with torch.inference_mode():
            x = images.to(self.device).permute(0, 3, 1, 2).float()
            x = resize_bilinear_half_pixel(x, (299, 299))
            logits = self.model(x)["logits"]
            if self.drop_background:
                logits = logits[:, 1:]
            return torch.softmax(logits, dim=-1)

    def probs(self, images: np.ndarray) -> np.ndarray:
        """images: (N, H, W, 3) float in [-1, 1]."""
        outs = []
        for i in range(0, len(images), self.batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(
                images[i:i + self.batch_size], dtype=np.float32))
            outs.append(self.probs_device(chunk).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def score_folder(self, folder: str, splits: int = 10,
                     max_images: int = 30000,
                     shuffle_seed: Optional[int] = 0) -> Tuple[float, float]:
        """Score the images under ``folder`` (reference `load_data` +
        `get_inception_score`, :64-131), shuffled before splitting as the
        reference does."""
        paths = image_paths(folder, (".png", ".jpg"))[:max_images]
        if not paths:
            raise FileNotFoundError(f"no images under {folder}")
        if shuffle_seed is not None:
            np.random.RandomState(shuffle_seed).shuffle(paths)
        probs = self.probs(np.stack([load_resized(p) for p in paths]))
        return inception_score_from_probs(probs, splits)
