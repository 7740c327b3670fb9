"""Port parity of the data layer: the demo corpus builder, the datasets, the
image transforms (native and PIL), the batching pipeline and the text/image
dumps against the JAX package's.

The data layer is host code (numpy, PIL, the same C++ source), so the port
must draw the JAX package's batches from the same seeds. Tolerances:
integer leaves bit for bit; image leaves within 1e-6 (float32 [-1, 1]) or
bit for bit (uint8).
"""

import filecmp
import os
import pickle

import numpy as np
import pytest
from PIL import Image

from eegan_tpu.config import Config as JaxConfig
from eegan_tpu.data import datasets as jax_datasets
from eegan_tpu.data import demo_corpus as jax_demo_corpus
from eegan_tpu.data import pipeline as jax_pipeline
from eegan_tpu.data import synthetic as jax_synthetic
from eegan_tpu.data import transforms as jax_transforms
from eegan_tpu.utils import images as jax_images
from eegan_tpu_torch.config import Config
from eegan_tpu_torch.data import (
    datasets,
    demo_corpus,
    native,
    pipeline,
    synthetic,
    transforms,
)
from eegan_tpu_torch.utils import images

N_FILES, BATCH, SEED = 12, 3, 7


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The JAX package's demo corpus (8 train, 4 test images)."""
    return jax_demo_corpus.build_corpus(tmp_path_factory.mktemp("birds"),
                                        n_files=N_FILES)


def configs(root, short=False):
    """The same data settings as the port's Config and the JAX package's;
    ``short`` makes captions and attributes longer than their slots, so
    the random subsampling runs."""
    out = []
    for c in (Config(), JaxConfig()):
        c.DATA_DIR = root
        c.DATASET_NAME = "bird"
        c.TEXT.CAPTIONS_PER_IMAGE = jax_demo_corpus.CAPS_PER_IMAGE
        if short:
            c.TEXT.WORDS_NUM = 6
            c.TEXT.MAX_ATTR_LEN = 2
        out.append(c)
    return out


def assert_batches_equal(got, want, what=""):
    assert set(got) == set(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        if k.startswith("img") and w.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                       err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


def test_demo_corpus_matches_jax(tmp_path):
    port = demo_corpus.build_corpus(tmp_path / "port", n_files=4)
    want = jax_demo_corpus.build_corpus(tmp_path / "jax", n_files=4)
    names = []
    for dirpath, _, files in os.walk(want):
        names += [os.path.relpath(os.path.join(dirpath, f), want)
                  for f in files]
    assert len(names) == 4 * 2 + 2 * 2 + 3  # images, texts, split + shared pickles
    for name in sorted(names):
        a, b = os.path.join(port, name), os.path.join(want, name)
        if name.endswith(".pickle"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert pickle.load(fa) == pickle.load(fb), name
        else:
            assert filecmp.cmp(a, b, shallow=False), name


@pytest.mark.parametrize("preload,uint8,short", [
    (False, False, False), (False, False, True), (True, False, False),
    (True, True, True)], ids=["per_sample", "per_sample_short", "preload",
                              "preload_uint8_short"])
def test_pipeline_batches_match_jax(corpus, preload, uint8, short):
    """Epochs 0 and 1 of TextImageDataset + DataPipeline, batch for batch:
    the per-sample path, and the preload cache's batched native path."""
    cfg, jcfg = configs(corpus, short)
    ds = datasets.TextImageDataset(cfg, "train", preload=preload,
                                   uint8_images=uint8)
    jds = jax_datasets.TextImageDataset(jcfg, "train", preload=preload,
                                        uint8_images=uint8)
    pipe = pipeline.DataPipeline(ds, BATCH, seed=SEED)
    jpipe = jax_pipeline.DataPipeline(jds, BATCH, seed=SEED)
    assert len(pipe) == len(jpipe) == 2
    for epoch in (0, 1):
        got, want = list(pipe.epoch(epoch)), list(jpipe.epoch(epoch))
        assert len(got) == len(want) == 2
        for i, (g, w) in enumerate(zip(got, want)):
            assert_batches_equal(g, w, f"epoch {epoch} batch {i}")
            img = g[f"img{cfg.imsizes[-1]}"]
            assert img.dtype == (np.uint8 if uint8 else np.float32)
    # the two epochs are shuffled differently
    assert not np.array_equal(got[0]["caps"], list(pipe.epoch(0))[0]["caps"])


def test_worker_processes_match_in_process(corpus):
    """Two spawned workers give the in-process batches."""
    cfg, _ = configs(corpus)
    ds = datasets.TextImageDataset(cfg, "train")
    pipe = pipeline.DataPipeline(ds, BATCH, seed=SEED, num_workers=2)
    try:
        got = list(pipe.epoch(1))
    finally:
        pipe.close()
    want = list(pipeline.DataPipeline(ds, BATCH, seed=SEED).epoch(1))
    for g, w in zip(got, want):
        assert_batches_equal(g, w)


def test_pil_fallback_matches_jax(corpus, monkeypatch):
    """Without the native library both packages take PIL: same pixels."""
    cfg, _ = configs(corpus)
    path = os.path.join(corpus, "images", "001.cls", "img_0.jpg")
    arr = np.asarray(Image.open(path).convert("RGB"))[:150, :200]
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert not native.available()
    for as_uint8 in (False, True):
        got = transforms.pyramid_from_array(
            arr, cfg.imsizes, np.random.default_rng(3), as_uint8=as_uint8)
        want = jax_transforms.pyramid_from_array(
            arr, cfg.imsizes, np.random.default_rng(3), use_native=False,
            as_uint8=as_uint8)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        got = transforms.load_image_pyramid(
            path, cfg.imsizes, [50, 40, 200, 180], np.random.default_rng(4),
            as_uint8=as_uint8)
        want = jax_transforms.load_image_pyramid(
            path, cfg.imsizes, [50, 40, 200, 180], np.random.default_rng(4),
            use_native=False, as_uint8=as_uint8)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_native_library_builds_outside_the_source_tree():
    assert native.available()
    path = native.library_path()
    assert path.is_file()
    assert path.parent.parts[-2:] == ("build", "eegan_tpu_torch")
    img = np.random.RandomState(0).randint(0, 256, (37, 53, 3), np.uint8)
    from eegan_tpu.data import native as jax_native

    np.testing.assert_array_equal(native.resize_bilinear(img, (16, 24)),
                                  jax_native.resize_bilinear(img, (16, 24)))


def test_text_only_dataset_matches_jax(corpus):
    cfg, jcfg = configs(corpus, short=True)
    for regard_sent in (False, True):
        ds = datasets.TextOnlyDataset(cfg, "test", regard_sent=regard_sent)
        jds = jax_datasets.TextOnlyDataset(jcfg, "test",
                                           regard_sent=regard_sent)
        assert len(ds) == len(jds) > 0
        for i in range(len(ds)):
            got = ds.sample(i, np.random.default_rng([1, i]))
            want = jds.sample(i, np.random.default_rng([1, i]))
            assert got.pop("keys") == want.pop("keys")
            assert_batches_equal(got, want)
        got = ds.wrong_captions(1, np.random.default_rng(2), r_val=6)
        want = jds.wrong_captions(1, np.random.default_rng(2), r_val=6)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_synthetic_dataset_and_grouping_match_jax():
    cfg, jcfg = Config(), JaxConfig()
    ds = synthetic.SyntheticDataset(cfg, size=8, n_words=30)
    jds = jax_synthetic.SyntheticDataset(jcfg, size=8, n_words=30)
    assert ds.ixtoword == jds.ixtoword and ds.wordtoix == jds.wordtoix
    got = list(pipeline.group_batches(
        pipeline.DataPipeline(ds, 2, seed=1).epoch(3), 3))
    want = list(jax_pipeline.group_batches(
        jax_pipeline.DataPipeline(jds, 2, seed=1).epoch(3), 3))
    assert [b["caps"].shape[0] for b in got] == [3, 1]
    for g, w in zip(got, want):
        assert_batches_equal(g, w)


def test_device_prefetch_passes_cpu_batches_through():
    batches = [{"caps": np.arange(3)}, {"caps": np.arange(4)}]
    out = list(pipeline.device_prefetch(iter(batches), "cpu"))
    assert len(out) == 2 and all(a is b for a, b in zip(out, batches))


def test_pipeline_refuses_what_jax_refuses():
    ds = synthetic.SyntheticDataset(Config(), size=8)
    with pytest.raises(ValueError):
        pipeline.DataPipeline(ds, 3, process_count=2)
    with pytest.raises(ValueError):
        pipeline.DataPipeline(ds, 2, process_count=2, drop_last=False)
    assert len(pipeline.DataPipeline(ds, 3, drop_last=False)) == 3


def test_text_and_image_dumps_match_jax(corpus, tmp_path):
    cfg, _ = configs(corpus)
    ds = datasets.TextImageDataset(cfg, "train")
    batch = next(pipeline.DataPipeline(ds, BATCH, seed=SEED).epoch(0))
    for mod, sub in ((images, "port"), (jax_images, "jax")):
        os.makedirs(tmp_path / sub)
        mod.save_text_results(batch["caps"], batch["cap_lens"], ds.ixtoword,
                              str(tmp_path / sub / "text.txt"),
                              batch["attrs"], batch["attr_lens"])
        mod.save_img_results([batch[f"img{s}"] for s in cfg.imsizes],
                             "sample", str(tmp_path / sub))
    names = ["text.txt"] + [f"sample_{s}.png" for s in cfg.imsizes]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(names)
    for name in names:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name,
                           shallow=False), name
