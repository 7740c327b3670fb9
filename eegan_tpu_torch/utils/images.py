"""Image/text result saving (reference `miscc/utils.py:11-113`), PIL-based.

The port's copy of the sampling and training parts of
``eegan_tpu/utils/images.py`` (the port imports nothing of the JAX
package). Images are NHWC float arrays in the generator's [-1, 1] tanh
range, renormalised per image; the file layout matches the JAX package's so
FID/IS folder sweeps read either.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image


def mkdir_p(path: str, rm_exist: bool = False) -> None:
    """(reference `miscc/utils.py` mkdir_p)."""
    if rm_exist and os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)


def to_uint8(img: np.ndarray, scale_each: bool = True) -> np.ndarray:
    """(H, W, 3) float in [-1, 1] (or arbitrary range) -> uint8."""
    img = np.asarray(img, dtype=np.float32)
    if scale_each:
        lo, hi = img.min(), img.max()
    else:
        lo, hi = -1.0, 1.0
    img = (img - lo) / max(hi - lo, 1e-5)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """(N, H, W, 3) -> one uint8 grid array."""
    n, h, w, c = images.shape
    ncol = int(np.ceil(n / nrow))
    grid = np.zeros((ncol * (h + pad) + pad, nrow * (w + pad) + pad, c),
                    dtype=np.uint8)
    for i in range(n):
        r, col = divmod(i, nrow)
        y = pad + r * (h + pad)
        x = pad + col * (w + pad)
        grid[y:y + h, x:x + w] = to_uint8(images[i])
    return grid


def save_img_grid(images: np.ndarray, path: str, nrow: int = 8) -> None:
    Image.fromarray(make_grid(np.asarray(images), nrow)).save(path)


def save_img_results(img_pyramid: Sequence[np.ndarray], prefix: str,
                     image_dir: str) -> None:
    """One grid per scale (reference `save_img_results`)."""
    for imgs in img_pyramid:
        imgs = np.asarray(imgs)
        scale = imgs.shape[1]
        save_img_grid(imgs, os.path.join(image_dir, f"{prefix}_{scale}.png"))


def save_img_results_one_by_one(images: np.ndarray, keys: Sequence[str],
                                image_dir: str,
                                suffix: Optional[str] = None) -> None:
    """Per-sample PNGs feeding the FID/IS folder sweeps
    (reference `save_img_results_one_by_one`)."""
    os.makedirs(image_dir, exist_ok=True)
    for img, key in zip(np.asarray(images), keys):
        name = key.replace("/", "_")
        if suffix:
            name = f"{name}_{suffix}"
        Image.fromarray(to_uint8(img)).save(
            os.path.join(image_dir, f"{name}.png"))


def save_text_results(caps: np.ndarray, cap_lens: np.ndarray,
                      ixtoword: Dict[int, str], path: str,
                      attrs: Optional[np.ndarray] = None,
                      attr_lens: Optional[np.ndarray] = None) -> None:
    """Dump the captions (and attributes) of a batch
    (reference `save_text_results`)."""
    lines: List[str] = []
    caps = np.asarray(caps)
    cap_lens = np.asarray(cap_lens)
    for i in range(len(caps)):
        words = [ixtoword.get(int(w), "?") for w in caps[i][:cap_lens[i]]]
        line = f"[{i}] " + " ".join(words)
        if attrs is not None:
            parts = []
            for a in range(attrs.shape[1]):
                ln = int(attr_lens[i][a]) if attr_lens is not None else attrs.shape[2]
                toks = [ixtoword.get(int(w), "?") for w in attrs[i][a][:ln]
                        if int(w) != 0]
                if toks:
                    parts.append(" ".join(toks))
            line += "  | attrs: " + "; ".join(parts)
        lines.append(line)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
