"""Dataset objects: pickle-compatible loading + fixed-shape sample assembly.

The port's copy of ``eegan_tpu/data/datasets.py`` (numpy + PIL; the port
imports nothing of the JAX package). Every sample draws from its
``numpy.random.Generator`` in the JAX module's order, so a batch of the
port is the JAX package's batch bit for bit.

Consumes the exact artefact formats the reference reads (so an existing
AttnGAN/EE-GAN data directory works unchanged):

* ``<data_dir>/<split>/filenames.pickle``  — list of image keys
  (reference `datasets.py:230-239`)
* ``<data_dir>/captions.pickle``           — [train_ids, test_ids, ixtoword,
  wordtoix] (reference `datasets.py:268-284`)
* ``<data_dir>/<split>/class_info.pickle`` — per-file class id, else arange
  (reference `datasets.py:286-295`; note the reference's TextOnlyDataset
  drops the split arg when calling this — a bug we do not replicate)
* ``<data_dir>/bounding_boxes.pickle``     — CUB key -> bbox
  (reference `datasets.py:241-246`)
* ``<data_dir>/attributes/<name>.pickle``  — [train_attrs, test_attrs]
  (reference `datasets.py:248-266`)

Sample assembly reproduces the reference's per-index behaviour
(`prepare_train_pair`, `datasets.py:426-439`): random caption choice among
CAPTIONS_PER_IMAGE, caption pad/truncate to WORDS_NUM (random subsample kept
sorted when too long), attribute selection/shuffle into the fixed
(MAX_ATTR_NUM, MAX_ATTR_LEN) grid, and an unpaired caption drawn from a
different class. All randomness flows through an explicit
`numpy.random.Generator`; every output has a fixed shape (jit-friendly).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np

from eegan_tpu_torch.config import Config
from eegan_tpu_torch.data.transforms import load_image_pyramid


def load_filenames(data_dir: str, split: str) -> List[str]:
    path = os.path.join(data_dir, split, "filenames.pickle")
    if os.path.isfile(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    return []


def load_captions_pickle(data_dir: str):
    """Returns (train_caps, test_caps, ixtoword, wordtoix, n_words)."""
    path = os.path.join(data_dir, "captions.pickle")
    with open(path, "rb") as f:
        train_caps, test_caps, ixtoword, wordtoix = pickle.load(f)
    return train_caps, test_caps, ixtoword, wordtoix, len(ixtoword)


def load_class_ids(data_dir: str, split: str, total: int) -> np.ndarray:
    path = os.path.join(data_dir, split, "class_info.pickle")
    if os.path.isfile(path):
        with open(path, "rb") as f:
            return np.asarray(pickle.load(f, encoding="bytes"))
    return np.arange(total)


def load_bbox(data_dir: str) -> Dict[str, List[int]]:
    with open(os.path.join(data_dir, "bounding_boxes.pickle"), "rb") as f:
        return pickle.load(f)


def load_attributes(data_dir: str, attr_name: str, split: str):
    path = os.path.join(data_dir, "attributes", f"{attr_name}.pickle")
    with open(path, "rb") as f:
        train_attrs, test_attrs = pickle.load(f)[:2]
    return train_attrs if split == "train" else test_attrs


def pad_caption(token_ids: Sequence[int], words_num: int,
                rng: np.random.Generator) -> Tuple[np.ndarray, int]:
    """Pad/truncate to WORDS_NUM; long captions keep a sorted random subset
    (reference `get_caption`, datasets.py:342-361)."""
    ids = np.asarray(token_ids, dtype=np.int64)
    out = np.zeros(words_num, dtype=np.int32)
    n = len(ids)
    if n <= words_num:
        out[:n] = ids
        return out, max(n, 1)
    keep = np.sort(rng.permutation(n)[:words_num])
    out[:] = ids[keep]
    return out, words_num


def pad_attributes(sent_attrs: Sequence[Sequence[int]], max_num: int,
                   max_len: int, rng: np.random.Generator
                   ) -> Tuple[np.ndarray, int, np.ndarray]:
    """Fixed (max_num, max_len) attr grid (reference `get_attributes`,
    datasets.py:300-340): shuffle which attrs are kept, pad each to max_len
    (sorted random subset if longer), lengths default to 1 for empty slots."""
    out = np.zeros((max_num, max_len), dtype=np.int32)
    lens = np.ones(max_num, dtype=np.int32)
    n_avail = min(max_num, len(sent_attrs))
    order = rng.permutation(n_avail)
    for slot, ix in enumerate(order):
        attr = np.asarray(sent_attrs[ix], dtype=np.int64)
        if attr.size == 0:
            continue
        if attr.size <= max_len:
            out[slot, :attr.size] = attr
            lens[slot] = attr.size
        else:
            keep = np.sort(rng.permutation(attr.size)[:max_len])
            out[slot] = attr[keep]
            lens[slot] = max_len
    return out, n_avail, lens


class TextImageDataset:
    """Training dataset (reference `TextDataset`, datasets.py:192-445)."""

    def __init__(self, config: Config, split: str = "train",
                 attr_name: str = "EE-GAN", preload: bool = False,
                 uint8_images: bool = False):
        self.config = config
        # RUNTIME.UINT8_TRANSFER: emit uint8 [0,255] pyramids (4x smaller
        # host->device transfer); the train step normalises on the device.
        self.uint8_images = uint8_images
        self.split = split
        self.data_dir = config.DATA_DIR
        self.imsizes = config.imsizes
        self.embeddings_num = config.TEXT.CAPTIONS_PER_IMAGE
        self.words_num = config.TEXT.WORDS_NUM
        self.max_attr_num = config.TEXT.MAX_ATTR_NUM
        self.max_attr_len = config.TEXT.MAX_ATTR_LEN
        self.use_attr = config.TRAIN.USE_ATTR
        self.use_unpair = config.TRAIN.USE_UNPAIR

        self.filenames = load_filenames(self.data_dir, split)
        train_caps, test_caps, self.ixtoword, self.wordtoix, self.n_words = \
            load_captions_pickle(self.data_dir)
        self.captions = train_caps if split == "train" else test_caps
        self.class_id = load_class_ids(self.data_dir, split, len(self.filenames))
        self.bbox = (load_bbox(self.data_dir)
                     if config.DATASET_NAME == "bird" else None)
        self.attributes = (load_attributes(self.data_dir, attr_name, split)
                           if self.use_attr else None)

        # Optional decoded-image cache: JPEG decode + bbox crop happen once
        # here, and batch assembly collapses to one native OpenMP call per
        # batch in the calling process (no worker processes).
        self._decoded = None
        if preload:
            self._decoded = self._preload_images()

    def __len__(self) -> int:
        return len(self.filenames)

    def sample_batch(self, indices, rngs):
        """Batched fast path: ONE native OpenMP call for all image work.

        Requires preload=True and the native library; falls back to the
        per-sample path otherwise. Draw order per sample matches `sample`
        exactly, so the output is bit-identical to stacking per-sample calls
        (tested in tests/test_torch_pipeline.py).
        """
        from eegan_tpu_torch.data import native

        if self._decoded is None or not native.available():
            samples = [self.sample(i, rng) for i, rng in zip(indices, rngs)]
            return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

        base = self.imsizes[-1]
        target = int(base * 76 / 64)
        crops = np.zeros((len(indices), 3), np.int32)
        texts = []
        for j, (i, rng) in enumerate(zip(indices, rngs)):
            h, w = self._decoded[i].shape[:2]
            if w <= h:
                ow, oh = target, max(1, int(round(target * h / w)))
            else:
                oh, ow = target, max(1, int(round(target * w / h)))
            crops[j, 0] = int(rng.integers(0, max(oh - base, 0) + 1))
            crops[j, 1] = int(rng.integers(0, max(ow - base, 0) + 1))
            crops[j, 2] = int(rng.random() < 0.5)
            texts.append(self._text_fields(i, rng))

        pyramids = native.batch_pyramid_varsize(
            [self._decoded[i] for i in indices], crops, target, base,
            self.imsizes, as_uint8=self.uint8_images)
        out = {f"img{sz}": arr for sz, arr in zip(self.imsizes, pyramids)}
        for k in texts[0]:
            out[k] = np.stack([t[k] for t in texts])
        return out

    def _text_fields(self, index: int, rng: np.random.Generator):
        """Caption/attr/unpair fields for one sample (draw order shared with
        `sample`)."""
        cls_id = int(self.class_id[index])
        caps, cap_len, sent_ix = self.caption_for(index, rng)
        out = {"caps": caps, "cap_lens": np.int32(cap_len),
               "class_ids": np.int32(cls_id)}
        if self.use_attr:
            attrs, _, attr_lens = pad_attributes(
                self.attributes[sent_ix], self.max_attr_num,
                self.max_attr_len, rng)
        else:
            attrs = np.zeros((self.max_attr_num, self.max_attr_len), np.int32)
            attr_lens = np.ones(self.max_attr_num, np.int32)
        out["attrs"] = attrs
        out["attr_lens"] = attr_lens
        if self.use_unpair:
            u_caps, u_len, _ = self.unpair_caption(cls_id, rng)
        else:
            u_caps, u_len = caps, cap_len
        out["unpair_caps"] = u_caps
        out["unpair_cap_lens"] = np.int32(u_len)
        return out

    # ------------------------------------------------------------------
    def caption_for(self, index: int, rng: np.random.Generator
                    ) -> Tuple[np.ndarray, int, int]:
        """Random caption among this image's CAPTIONS_PER_IMAGE
        (reference `get_cap_one`, datasets.py:384-389)."""
        sub = int(rng.integers(0, self.embeddings_num))
        sent_ix = index * self.embeddings_num + sub
        caps, cap_len = pad_caption(self.captions[sent_ix], self.words_num, rng)
        return caps, cap_len, sent_ix

    def unpair_caption(self, cls_id, rng: np.random.Generator):
        """Caption from a different class (reference `get_cap_unpair`,
        datasets.py:376-382)."""
        idx = int(rng.integers(0, len(self)))
        while self.class_id[idx] == cls_id:
            idx = (idx + 1) % len(self)
        caps, cap_len, _ = self.caption_for(idx, rng)
        return caps, cap_len, int(self.class_id[idx])

    def image_path(self, key: str) -> str:
        return os.path.join(self.data_dir, "images", f"{key}.jpg")

    def _preload_images(self):
        from concurrent.futures import ThreadPoolExecutor

        from PIL import Image

        from eegan_tpu_torch.data.transforms import (
            bbox_crop,
            resize_shorter_side,
        )

        # Cache at the augmentation frame: the shorter-side resize to
        # base*76/64 is deterministic per image (only crop/flip are
        # random), so doing it once here removes the dominant per-step
        # resize from the hot path — batch assembly degenerates to
        # crop + flip + the two small pyramid downsizes. The per-step
        # shorter-side "resize" over the cached image is an exact
        # identity under the triangle filter (scale == 1).
        target = int(self.imsizes[-1] * 76 / 64)

        def decode(index):
            key = self.filenames[index]
            img = Image.open(self.image_path(key)).convert("RGB")
            if self.bbox is not None:
                img = bbox_crop(img, self.bbox[key])
            img = resize_shorter_side(img, target)
            return np.asarray(img, dtype=np.uint8)

        with ThreadPoolExecutor(max_workers=16) as pool:
            decoded = list(pool.map(decode, range(len(self))))
        total_mb = sum(a.nbytes for a in decoded) / 2 ** 20
        print(f"preloaded {len(decoded)} images ({total_mb:.0f} MiB)")
        return decoded

    def sample(self, index: int, rng: np.random.Generator,
               augment: bool = True) -> Dict[str, np.ndarray]:
        key = self.filenames[index]
        cls_id = int(self.class_id[index])
        bbox = self.bbox[key] if self.bbox is not None else None

        if self._decoded is not None:
            from eegan_tpu_torch.data.transforms import pyramid_from_array

            pyramid = pyramid_from_array(self._decoded[index], self.imsizes,
                                         rng, augment=augment,
                                         as_uint8=self.uint8_images)
        else:
            pyramid = load_image_pyramid(self.image_path(key), self.imsizes,
                                         bbox, rng, augment=augment,
                                         as_uint8=self.uint8_images)

        out: Dict[str, np.ndarray] = {
            f"img{s}": im for s, im in zip(self.imsizes, pyramid)}
        out.update(self._text_fields(index, rng))
        return out


class TextOnlyDataset:
    """Caption-only dataset for evaluation (reference `TextOnlyDataset`,
    datasets.py:448-538): per-image mode (random caption per image) or
    per-sentence mode, plus the 99-wrong-caption sampler for R-precision."""

    def __init__(self, config: Config, split: str = "test",
                 regard_sent: bool = False, attr_name: str = "EE-GAN"):
        self.config = config
        self.embeddings_num = config.TEXT.CAPTIONS_PER_IMAGE
        self.regard_sent = regard_sent
        self.words_num = config.TEXT.WORDS_NUM
        self.max_attr_num = config.TEXT.MAX_ATTR_NUM
        self.max_attr_len = config.TEXT.MAX_ATTR_LEN
        self.use_attr = config.TRAIN.USE_ATTR

        data_dir = config.DATA_DIR
        self.filenames = load_filenames(data_dir, split)
        train_caps, test_caps, self.ixtoword, self.wordtoix, self.n_words = \
            load_captions_pickle(data_dir)
        self.captions = train_caps if split == "train" else test_caps
        self.class_id = load_class_ids(data_dir, split, len(self.filenames))
        self.attributes = (load_attributes(data_dir, attr_name, split)
                           if self.use_attr else None)
        self.img_sum = (len(self.captions) // self.embeddings_num
                        if regard_sent else len(self.filenames))

    def __len__(self) -> int:
        return len(self.captions) if self.regard_sent else len(self.filenames)

    def sample(self, index: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        if self.regard_sent:
            sent_ix = index
            img_ix = index // self.embeddings_num
            caps, cap_len = pad_caption(self.captions[sent_ix],
                                        self.words_num, rng)
        else:
            img_ix = index
            sub = int(rng.integers(0, self.embeddings_num))
            sent_ix = img_ix * self.embeddings_num + sub
            caps, cap_len = pad_caption(self.captions[sent_ix],
                                        self.words_num, rng)

        out = {
            "caps": caps,
            "cap_lens": np.int32(cap_len),
            "class_ids": np.int32(self.class_id[img_ix]),
            "keys": self.filenames[img_ix],
        }
        if self.use_attr:
            attrs, _, attr_lens = pad_attributes(
                self.attributes[sent_ix], self.max_attr_num,
                self.max_attr_len, rng)
            out["attrs"] = attrs
            out["attr_lens"] = attr_lens
        return out

    def wrong_captions(self, cls_id, rng: np.random.Generator,
                       r_val: int = 100) -> Tuple[np.ndarray, np.ndarray]:
        """R_val-1 captions from other classes (reference
        `get_sent_multi_unpair`, datasets.py:509-529)."""
        n = r_val - 1
        caps = np.zeros((n, self.words_num), np.int32)
        lens = np.zeros(n, np.int32)
        for i in range(n):
            idx = int(rng.integers(0, self.img_sum))
            while self.class_id[idx] == cls_id:
                idx = (idx + 1) % self.img_sum
            sub = int(rng.integers(0, self.embeddings_num))
            sent_ix = idx * self.embeddings_num + sub
            caps[i], lens[i] = pad_caption(self.captions[sent_ix],
                                           self.words_num, rng)
        return caps, lens
