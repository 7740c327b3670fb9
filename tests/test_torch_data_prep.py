"""Port parity of the data preparation: ``build_bbox_pickle`` and
``build_attributes_pickle`` (``extract_all`` over a process pool) against
the JAX package's on the miniature corpus, and the
``python -m eegan_tpu_torch.prepare_attributes`` CLI as a subprocess.

The bounding-box pickles are compared byte for byte. The attribute pickles
too, once each caption's phrase list is in one order: the JAX extractor
lists a caption's phrases in ``set`` order, which follows the interpreter's
hash seed, where the port's lists them sorted."""

import os
import pickle
import subprocess
import sys

import pytest

from corpus_util import build_corpus
from eegan_tpu.data import attributes as jax_attributes
from eegan_tpu.data import prep as jax_prep
from eegan_tpu_torch.data import attributes, prep
from eegan_tpu_torch.data.datasets import load_captions_pickle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _names(root):
    names = []
    for split in ("train", "test"):
        with open(os.path.join(root, split, "filenames.pickle"), "rb") as f:
            names += pickle.load(f)
    return names


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = build_corpus(tmp_path_factory.mktemp("birds"))
    names = _names(root)
    # CUB's two text files, as the dataset ships them.
    with open(os.path.join(root, "images.txt"), "w") as f:
        for i, name in enumerate(names, 1):
            f.write(f"{i} {name}.jpg\n")
    with open(os.path.join(root, "bounding_boxes.txt"), "w") as f:
        for i in range(1, len(names) + 1):
            f.write(f"{i} {i * 3.0} {i + 7.0} {50.0 + i} {60.5 + i}\n")
    return root


def _canonical(path):
    """The attribute pickle with each caption's phrases sorted."""
    with open(path, "rb") as f:
        splits = pickle.load(f)
    return [[sorted(caption) for caption in split] for split in splits]


def test_bbox_pickle_is_byte_equal(corpus, tmp_path):
    ours = prep.build_bbox_pickle(corpus, str(tmp_path / "port.pickle"))
    ref = jax_prep.build_bbox_pickle(corpus, str(tmp_path / "jax.pickle"))
    data = open(ours, "rb").read()
    assert data == open(ref, "rb").read()
    boxes = pickle.loads(data)
    assert len(boxes) == len(set(_names(corpus)))
    assert all(len(b) == 4 for b in boxes.values())


@pytest.mark.parametrize("workers", [1, 2])
def test_attributes_pickle_matches_jax(corpus, tmp_path, workers):
    ours = attributes.build_attributes_pickle(
        corpus, "bird", attr_name=f"PORT{workers}", workers=workers)
    # The JAX package's pool forks; one process keeps this one unforked.
    ref = jax_attributes.build_attributes_pickle(
        corpus, "bird", attr_name=f"JAX{workers}", workers=1)
    port_lists = _canonical(ours)
    assert pickle.dumps(port_lists, protocol=2) == pickle.dumps(
        _canonical(ref), protocol=2)
    train_caps, test_caps, _, _, _ = load_captions_pickle(corpus)
    assert [len(s) for s in port_lists] == [len(train_caps), len(test_caps)]
    assert sum(len(c) for c in port_lists[0]) > 0


def test_extract_all_splits_work_over_chunks(corpus):
    """Chunks of 1 caption over 2 workers give what one process gives."""
    caps, _, ixtoword, wordtoix, _ = load_captions_pickle(corpus)
    one = attributes.extract_all(caps, ixtoword, wordtoix, "bird", workers=1)
    two = attributes.extract_all(caps, ixtoword, wordtoix, "bird", workers=2,
                                 chunk_size=1)
    assert one == two and len(one) == len(caps)


def test_prepare_attributes_cli(corpus, tmp_path):
    ref = jax_attributes.build_attributes_pickle(corpus, "bird",
                                                 attr_name="JAXCLI",
                                                 workers=1)
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = subprocess.run(
        [sys.executable, "-m", "eegan_tpu_torch.prepare_attributes",
         "--data_dir", corpus, "--dataset_name", "bird", "--attr_name",
         "CLI", "--workers", "2"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert run.returncode == 0, run.stderr
    out = os.path.join(corpus, "attributes", "CLI.pickle")
    assert _canonical(out) == _canonical(ref)

    sampled = subprocess.run(
        [sys.executable, "-m", "eegan_tpu_torch.prepare_attributes",
         "--data_dir", corpus, "--sampling", "3"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert sampled.returncode == 0, sampled.stderr
    lines = [ln for ln in sampled.stdout.splitlines() if " -> " in ln]
    assert len(lines) == 3
