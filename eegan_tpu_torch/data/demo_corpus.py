"""Miniature CUB-shaped corpus builder (the port's copy of
``eegan_tpu/data/demo_corpus.py``; the same arguments write the same files).

Generates a small but STRUCTURALLY complete dataset — images/, text/,
train/test filenames+class pickles, bounding_boxes.pickle,
captions.pickle, attributes/EE-GAN.pickle — in the exact artefact formats
the reference pipeline consumes (reference `datasets.py:230-295`).

Used by the port's tests and by ``chip_smoke.py``, which trains on an
on-disk corpus without importing the JAX package.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

N_FILES = 6
CAPS_PER_IMAGE = 2


def build_corpus(root, n_files: int = N_FILES,
                 caps_per_image: int = CAPS_PER_IMAGE) -> str:
    from PIL import Image

    from eegan_tpu_torch.data.prep import build_captions_pickle

    root = str(root)
    rng = np.random.RandomState(0)

    filenames, bboxes = [], {}
    os.makedirs(os.path.join(root, "images", "001.cls"), exist_ok=True)
    os.makedirs(os.path.join(root, "text", "001.cls"), exist_ok=True)
    for i in range(n_files):
        key = f"001.cls/img_{i}"
        filenames.append(key)
        arr = rng.randint(0, 255, (300, 400, 3), np.uint8)
        Image.fromarray(arr).save(os.path.join(root, "images", f"{key}.jpg"))
        with open(os.path.join(root, "text", f"{key}.txt"), "w") as f:
            f.write(f"this bird has a bright red head number {i}\n"
                    f"a small bird with white belly and black wings\n")
        bboxes[key] = [50, 40, 200, 180]

    n_test = max(n_files // 3, 1)
    splits = [("train", filenames[:n_files - n_test]),
              ("test", filenames[n_files - n_test:])]
    for split, names in splits:
        os.makedirs(os.path.join(root, split), exist_ok=True)
        with open(os.path.join(root, split, "filenames.pickle"), "wb") as f:
            pickle.dump(names, f, protocol=2)
        with open(os.path.join(root, split, "class_info.pickle"), "wb") as f:
            pickle.dump([1 + (i % 2) for i in range(len(names))], f, protocol=2)

    with open(os.path.join(root, "bounding_boxes.pickle"), "wb") as f:
        pickle.dump(bboxes, f, protocol=2)

    build_captions_pickle(root, caps_per_image)

    with open(os.path.join(root, "captions.pickle"), "rb") as f:
        train_ids, test_ids, ixtoword, wordtoix = pickle.load(f)
    mk = lambda caps: [[c[:3], c[3:5]] if len(c) >= 5 else [c] for c in caps]
    os.makedirs(os.path.join(root, "attributes"), exist_ok=True)
    with open(os.path.join(root, "attributes", "EE-GAN.pickle"), "wb") as f:
        pickle.dump([mk(train_ids), mk(test_ids)], f, protocol=2)

    return root
