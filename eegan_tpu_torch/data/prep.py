"""Offline artefact builders: the caption vocab pickle and the bounding
boxes.

Copy of ``eegan_tpu/data/prep.py`` (the port imports nothing of the JAX
package). Rebuilds `InitDataMethod` (reference `datasets.py:55-189`):
tokenize the per-image caption .txt files (regex ``\\w+``, lowercase,
ascii-filter), build the vocabulary (every word), and emit
``captions.pickle`` holding the word-id lists; and CUB's
``bounding_boxes.txt`` as ``bounding_boxes.pickle``.
"""

from __future__ import annotations

import os
import pickle
import re
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

_TOKEN_RE = re.compile(r"\w+")


def tokenize_caption(text: str) -> List[str]:
    """RegexpTokenizer(r'\\w+') + lowercase + ascii filter
    (reference `load_captions`, datasets.py:144-177)."""
    tokens = _TOKEN_RE.findall(text.lower())
    out = []
    for t in tokens:
        t = t.encode("ascii", "ignore").decode("ascii")
        if t:
            out.append(t)
    return out


def load_caption_tokens(data_dir: str, filenames: Sequence[str],
                        captions_per_image: int) -> List[List[str]]:
    all_captions: List[List[str]] = []
    for name in filenames:
        path = os.path.join(data_dir, "text", f"{name}.txt")
        with open(path, "r") as f:
            raw = f.read().split("\n")
        cnt = 0
        for cap in raw:
            if not cap:
                continue
            tokens = tokenize_caption(cap)
            if not tokens:
                continue
            all_captions.append(tokens)
            cnt += 1
            if cnt == captions_per_image:
                break
        if cnt < captions_per_image:
            print(f"WARNING: {name} has only {cnt} captions "
                  f"(< {captions_per_image})")
    return all_captions


def build_dictionary(train_captions: List[List[str]],
                     test_captions: List[List[str]],
                     min_count: int = 0
                     ) -> Tuple[List[List[int]], List[List[int]],
                                Dict[int, str], Dict[str, int]]:
    """Vocab over train+test; id 0 is reserved for '<end>' (the pad token)."""
    word_counts: Dict[str, float] = defaultdict(float)
    for sent in train_captions + test_captions:
        for w in sent:
            word_counts[w] += 1
    vocab = [w for w in word_counts if word_counts[w] >= min_count]

    ixtoword = {0: "<end>"}
    wordtoix = {"<end>": 0}
    for ix, w in enumerate(vocab, start=1):
        wordtoix[w] = ix
        ixtoword[ix] = w

    def to_ids(caps):
        return [[wordtoix[w] for w in sent if w in wordtoix] for sent in caps]

    return to_ids(train_captions), to_ids(test_captions), ixtoword, wordtoix


def build_captions_pickle(data_dir: str, captions_per_image: int,
                          out_path: str = "") -> str:
    from eegan_tpu_torch.data.datasets import load_filenames

    train_names = load_filenames(data_dir, "train")
    test_names = load_filenames(data_dir, "test")
    train_caps = load_caption_tokens(data_dir, train_names, captions_per_image)
    test_caps = load_caption_tokens(data_dir, test_names, captions_per_image)
    train_ids, test_ids, ixtoword, wordtoix = build_dictionary(
        train_caps, test_caps)

    out_path = out_path or os.path.join(data_dir, "captions.pickle")
    with open(out_path, "wb") as f:
        pickle.dump([train_ids, test_ids, ixtoword, wordtoix], f, protocol=2)
    print("Save to:", out_path)
    return out_path


def build_bbox_pickle(data_dir: str, out_path: str = "") -> str:
    """CUB bounding_boxes.txt + images.txt -> key->bbox pickle
    (reference `init_bounding_box`, datasets.py:74-96)."""
    bboxes = {}
    with open(os.path.join(data_dir, "bounding_boxes.txt")) as f:
        bbox_rows = [[int(float(v)) for v in line.split()[1:]]
                     for line in f if line.strip()]
    with open(os.path.join(data_dir, "images.txt")) as f:
        names = [line.split()[1] for line in f if line.strip()]
    for name, bbox in zip(names, bbox_rows):
        bboxes[name[:-4]] = bbox

    out_path = out_path or os.path.join(data_dir, "bounding_boxes.pickle")
    with open(out_path, "wb") as f:
        pickle.dump(bboxes, f, protocol=2)
    print("Save to:", out_path)
    return out_path
