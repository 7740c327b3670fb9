"""Fréchet Inception Distance with on-device feature extraction
(counterpart of ``eegan_tpu/evaluation/fid.py``; reference
`metrics/FID/fid_score.py:49-305`).

Inception-v3 pool3 (2048-d) activations over generated images or image
folders (or a dataset ``.npz`` with keys ``mu``/``sigma``, reference
:100-103), their Gaussian statistics, and the stabilised matrix-sqrt
Fréchet distance. The network runs on the device in float32; ``sqrtm`` is a
one-off 2048x2048 operation and stays on the host (scipy).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import linalg

from eegan_tpu_torch import resolve_device
from eegan_tpu_torch.models.inception import InceptionV3
from eegan_tpu_torch.models.layers import resize_bilinear_half_pixel


def image_paths(folder: str, extensions: Tuple[str, ...]) -> list:
    """Sorted paths of the files under ``folder`` with one of
    ``extensions`` (lower case)."""
    return sorted(os.path.join(r, f) for r, _, files in os.walk(folder)
                  for f in files if f.lower().endswith(extensions))


def load_resized(path: str, size: int = 299) -> np.ndarray:
    """An image file as (size, size, 3) float32 in [-1, 1], PIL bilinear."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size),
                                                 Image.BILINEAR)
    return np.asarray(img, np.float32) / 127.5 - 1.0


class FIDExtractor:
    """pool3 features of Inception-v3 (``num_classes=0``), eval mode,
    float32, on ``device``. Inputs: NHWC in [-1, 1], resized to 299²
    (``resize_bilinear_half_pixel``, the JAX resize) on the device.

    ``model``: an ``InceptionV3`` with the weights to use (a torchvision
    ``.pth`` loads into it directly); without one the weights are random
    from ``seed`` (relative comparisons only)."""

    def __init__(self, model: Optional[InceptionV3] = None,
                 batch_size: int = 50, device="cuda", seed: int = 0):
        self.device = resolve_device(device)
        if model is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                model = InceptionV3(num_classes=0)
        self.model = model.to(self.device,
                              memory_format=torch.channels_last).eval()
        self.batch_size = batch_size

    def features_device(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) images on the device -> (N, 2048) float32 features,
        left on the device (the overlapped evaluation feeds the generator's
        output here without a host round trip)."""
        with torch.inference_mode():
            x = images.to(self.device).permute(0, 3, 1, 2).float()
            x = resize_bilinear_half_pixel(x, (299, 299))
            return self.model(x)["pool3"]

    def features(self, images: np.ndarray) -> np.ndarray:
        """images: (N, H, W, 3) float32 in [-1, 1] -> (N, 2048)."""
        outs = []
        for i in range(0, len(images), self.batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(
                images[i:i + self.batch_size], dtype=np.float32))
            outs.append(self.features_device(chunk).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def features_from_folder(self, folder: str,
                             max_images: Optional[int] = None) -> np.ndarray:
        paths = image_paths(folder, (".png", ".jpg", ".jpeg"))
        if max_images:
            paths = paths[:max_images]
        if not paths:
            raise FileNotFoundError(f"no images under {folder}")
        outs = []
        for i in range(0, len(paths), self.batch_size):
            outs.append(self.features(np.stack(
                [load_resized(p) for p in paths[i:i + self.batch_size]])))
        return np.concatenate(outs, axis=0)


def activation_statistics(features: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def load_npz_stats(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Dataset statistics npz with keys mu/sigma (reference :100-103)."""
    with np.load(path) as f:
        return f["mu"][:], f["sigma"][:]


def save_npz_stats(path: str, mu: np.ndarray, sigma: np.ndarray) -> None:
    np.savez(path, mu=mu, sigma=sigma)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """d² = ||mu1-mu2||² + Tr(S1 + S2 - 2 sqrt(S1 S2)), with the standard
    eps-offset retry and imaginary-part guard (reference :174-228)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"sqrtm imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real

    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def dataset_statistics(config, extractor: FIDExtractor, split: str = "test",
                       n_images: int = 30000, seed: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Activation statistics over ``n_images`` randomly augmented dataset
    crops (bbox crop for CUB), drawn as the JAX package draws them
    (reference `MeasureFID.gen_dataset_imgs` + `gen_npz_file`,
    `metrics/FID/fid_score.py:233-292`, without the on-disk dump)."""
    from eegan_tpu_torch.data.datasets import TextImageDataset
    from eegan_tpu_torch.data.transforms import load_image_pyramid

    ds = TextImageDataset(config, split=split)
    rng = np.random.default_rng([seed])
    feats, batch = [], []
    for _ in range(n_images):
        idx = int(rng.integers(0, len(ds)))
        key = ds.filenames[idx]
        bbox = ds.bbox[key] if ds.bbox is not None else None
        pyramid = load_image_pyramid(ds.image_path(key), ds.imsizes, bbox,
                                     rng, augment=True)
        batch.append(pyramid[-1])
        if len(batch) == extractor.batch_size:
            feats.append(extractor.features(np.stack(batch)))
            batch = []
    if batch:
        feats.append(extractor.features(np.stack(batch)))
    return activation_statistics(np.concatenate(feats, axis=0))


class MeasureFID:
    """Folder-sweep harness (reference `MeasureFID.calculate_fid`,
    :66-95)."""

    def __init__(self, extractor: FIDExtractor):
        self.extractor = extractor

    def stats_for(self, path: str, max_images: Optional[int] = None):
        if path.endswith(".npz"):
            return load_npz_stats(path)
        feats = self.extractor.features_from_folder(path, max_images)
        return activation_statistics(feats)

    def fid_between(self, real: str, fake_folder: str,
                    max_images: Optional[int] = None) -> float:
        m1, s1 = self.stats_for(real)
        m2, s2 = self.stats_for(fake_folder, max_images)
        return frechet_distance(m1, s1, m2, s2)

    def sweep(self, real: str, gen_root: str, epochs: Sequence[int],
              repeats: Sequence[int], max_images: Optional[int] = None):
        """Epoch×repeat sweep over ``<gen_root>/Epoch_{e}_{r}/``
        (reference :84-95; the folder layout of the ``test`` CLI)."""
        m1, s1 = self.stats_for(real)
        results = {}
        for e in epochs:
            for r in repeats:
                folder = os.path.join(gen_root, f"Epoch_{e}_{r}")
                if not os.path.isdir(folder):
                    continue
                feats = self.extractor.features_from_folder(folder,
                                                            max_images)
                m2, s2 = activation_statistics(feats)
                results[(e, r)] = frechet_distance(m1, s1, m2, s2)
                print(f"Epoch_{e}_{r}: FID = {results[(e, r)]:.3f}")
        return results
