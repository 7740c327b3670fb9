"""Image transforms reproducing the reference training pipeline on the host.

The port's copy of ``eegan_tpu/data/transforms.py`` (PIL + numpy; the port
imports nothing of the JAX package), so both packages give the same pixels.

The reference composes torchvision transforms (reference `train.py:269-272`):
Resize(imsize*76/64) -> RandomCrop(imsize) -> RandomHorizontalFlip, after an
optional CUB bounding-box crop with a 0.75 margin (reference
`datasets.py:391-424`), then per-branch Resize + ToTensor + Normalize(0.5).

Implemented with PIL + numpy, with ALL randomness drawn from an explicit
`numpy.random.Generator` so the pipeline is reproducible and shardable
(SURVEY.md §7 "randomness discipline"). Output is NHWC float32 in [-1, 1].
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
from PIL import Image


def bbox_crop(img: Image.Image, bbox: Sequence[int]) -> Image.Image:
    """CUB bbox crop with 0.75 margin (reference `datasets.py:402-410`)."""
    width, height = img.size
    r = int(np.maximum(bbox[2], bbox[3]) * 0.75)
    center_x = int((2 * bbox[0] + bbox[2]) / 2)
    center_y = int((2 * bbox[1] + bbox[3]) / 2)
    y1 = np.maximum(0, center_y - r)
    y2 = np.minimum(height, center_y + r)
    x1 = np.maximum(0, center_x - r)
    x2 = np.minimum(width, center_x + r)
    return img.crop((x1, y1, x2, y2))


def resize_shorter_side(img: Image.Image, size: int) -> Image.Image:
    """torchvision Resize(int): scale so the shorter side == size."""
    w, h = img.size
    if w <= h:
        ow, oh = size, max(1, int(round(size * h / w)))
    else:
        oh, ow = size, max(1, int(round(size * w / h)))
    return img.resize((ow, oh), Image.BILINEAR)


def random_crop(img: Image.Image, size: int, rng: np.random.Generator) -> Image.Image:
    w, h = img.size
    if w < size or h < size:
        img = img.resize((max(w, size), max(h, size)), Image.BILINEAR)
        w, h = img.size
    x = int(rng.integers(0, w - size + 1))
    y = int(rng.integers(0, h - size + 1))
    return img.crop((x, y, x + size, y + size))


def to_normalized_array(img: Image.Image) -> np.ndarray:
    """ToTensor + Normalize(0.5, 0.5): uint8 -> float32 in [-1, 1], HWC."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0


def quantize_u8(arr: np.ndarray) -> np.ndarray:
    """float [0, 255] -> uint8 with Pillow/native rounding (half away from
    zero on the clamped value — matches `image_ops.cpp` lround)."""
    return np.floor(np.clip(arr, 0.0, 255.0) + 0.5).astype(np.uint8)


def float_to_u8(arr: np.ndarray) -> np.ndarray:
    """[-1, 1] float image -> uint8 [0, 255] with the production rounding.

    The exact inverse of the on-device normalisation
    (`training/steps.py::normalize_image_leaves`, RUNTIME.UINT8_TRANSFER);
    benches/dryruns that synthesise uint8 pyramids must use this so they
    quantise identically to the data pipeline they exercise."""
    return quantize_u8((np.asarray(arr, np.float32) + 1.0) * 127.5)


def pyramid_from_array(arr: np.ndarray, imsizes: Sequence[int],
                       rng: Optional[np.random.Generator],
                       augment: bool = True,
                       use_native: bool = True,
                       as_uint8: bool = False) -> List[np.ndarray]:
    """Pyramid from a decoded uint8 HWC array (post bbox-crop).

    Same augmentation semantics as `load_image_pyramid`; used by the
    preload-cache fast path (datasets.TextImageDataset(preload=True)) where
    JPEG decode happens once up front. With ``as_uint8`` branches are
    emitted as uint8 in [0, 255] (RUNTIME.UINT8_TRANSFER: 4x smaller
    host->device transfer, on-device normalisation) instead of [-1, 1]
    float32.
    """
    from eegan_tpu_torch.data import native

    base = imsizes[-1]
    have_native = use_native and native.available()

    h, w = arr.shape[:2]
    target = int(base * 76 / 64) if augment else base
    if w <= h:
        ow, oh = target, max(1, int(round(target * h / w)))
    else:
        oh, ow = target, max(1, int(round(target * w / h)))

    if (oh, ow) == (h, w):
        # already at the augmentation frame (preload caches there); the
        # scale-1 triangle filter is an exact identity. Stay uint8 so the
        # hot preload path crops the small window first instead of
        # float-converting the whole cached frame.
        resized = arr
    elif have_native:
        resized = native.resize_bilinear(arr, (oh, ow))  # float32 [0,255]
    else:
        img = Image.fromarray(arr).resize((ow, oh), Image.BILINEAR)
        resized = np.asarray(img, dtype=np.float32)

    if augment:
        assert rng is not None
        y = int(rng.integers(0, max(oh - base, 0) + 1))
        x = int(rng.integers(0, max(ow - base, 0) + 1))
        crop = resized[y:y + base, x:x + base]
        if rng.random() < 0.5:
            crop = crop[:, ::-1]
    else:
        y, x = (oh - base) // 2, (ow - base) // 2
        crop = resized[y:y + base, x:x + base]
    crop = np.ascontiguousarray(crop)

    out = []
    if crop.dtype == np.uint8:  # identity fast path stayed uint8
        crop_u8 = crop
        crop = crop.astype(np.float32)
    else:
        crop_u8 = np.clip(crop, 0, 255).astype(np.uint8)
    for s in imsizes:
        if s == base:
            branch = crop
        elif have_native:
            branch = native.resize_bilinear(crop_u8, (s, s))
        else:
            img = Image.fromarray(crop_u8).resize((s, s), Image.BILINEAR)
            branch = np.asarray(img, np.float32)
        if as_uint8:
            out.append(quantize_u8(branch))
        else:
            out.append((branch / 127.5 - 1.0).astype(np.float32))
    return out


def load_image_pyramid(path: str, imsizes: Sequence[int],
                       bbox: Optional[Sequence[int]],
                       rng: Optional[np.random.Generator],
                       augment: bool = True,
                       use_native: bool = True,
                       as_uint8: bool = False) -> List[np.ndarray]:
    """Full per-sample image path -> [img64, img128, img256] float32 NHWC.

    Mirrors `TextDataset.get_imgs` (reference `datasets.py:391-424`): the
    largest branch gets the augmented crop directly; smaller branches are
    bilinear-resized from it. The per-branch resize + normalise runs through
    the native C++ ops (`data/csrc/image_ops.cpp`) when built, PIL otherwise.
    """
    img = Image.open(path).convert("RGB")
    if bbox is not None:
        img = bbox_crop(img, bbox)

    base = imsizes[-1]
    if augment:
        assert rng is not None
        img = resize_shorter_side(img, int(base * 76 / 64))
        img = random_crop(img, base, rng)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
    else:
        img = resize_shorter_side(img, base)
        w, h = img.size  # center crop
        x, y = (w - base) // 2, (h - base) // 2
        img = img.crop((x, y, x + base, y + base))

    if use_native:
        from eegan_tpu_torch.data import native

        if native.available():
            arr = np.asarray(img, dtype=np.uint8)
            out = []
            for s in imsizes:
                branch = (arr.astype(np.float32) if s == base
                          else native.resize_bilinear(arr, (s, s)))
                out.append(quantize_u8(branch) if as_uint8
                           else (branch / 127.5 - 1.0).astype(np.float32))
            return out

    out = []
    for s in imsizes:
        branch = img if s == base else img.resize((s, s), Image.BILINEAR)
        if as_uint8:
            out.append(np.asarray(branch, dtype=np.uint8))
        else:
            out.append(to_normalized_array(branch))
    return out
