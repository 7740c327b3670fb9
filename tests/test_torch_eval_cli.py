"""The port's evaluation CLIs on the CPU (``python -m
eegan_tpu_torch.{test,fid_score,sample}`` as ``--device cpu``
subprocesses) on a one-epoch training run of a demo corpus
(``data/demo_corpus.py``) at tiny widths, and ``train --eval_overlap``.

* ``train --eval_overlap`` logs the overlapped evaluation's
  ``eval/r_precision`` for the epoch beside the training metrics.
* ``test`` sweeps the run's ``netG_1.pth``: the PNGs and an R-precision in
  [0, 1].
* ``fid_score --dataset_npz`` writes the test split's statistics, and the
  ``Epoch_1_0`` sweep against them gives a finite FID >= 0.
* ``sample --from_dataset --model_dir`` draws the JAX CLI's batch (its
  tokens equal to the JAX package's ``TextImageDataset`` draw for the same
  seed, JAX ``sample.py:122-125``) and writes the samples.
* Every new entry point's default ``--device cuda`` raises without a GPU.
"""

import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from eegan_tpu.config import apply_overrides as jax_apply_overrides
from eegan_tpu.config import fresh_config as jax_fresh_config
from eegan_tpu.data.datasets import TextImageDataset as JaxTextImageDataset
from eegan_tpu_torch.config import apply_overrides, fresh_config
from eegan_tpu_torch.data.datasets import TextImageDataset
from eegan_tpu_torch.data.demo_corpus import build_corpus

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "cfg", "bird.yml")
SEED = 5


def _overrides(data, save):
    sets = [f"DATA_DIR={data}", f"SAVE_DIR={save}", "GAN.GF_DIM=4",
            "GAN.DF_DIM=4", "TEXT.EMBEDDING_DIM=32",
            "TEXT.CAPTIONS_PER_IMAGE=2", "RUNTIME.DATA_WORKERS=0",
            "RUNTIME.COMPUTE_DTYPE=float32",
            "RUNTIME.ALLOW_RANDOM_ENCODERS=true"]
    return [a for s in sets for a in ("--set", s)]


def _run(module, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-m", module, "--device", "cpu",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One epoch (1 iteration) of the train CLI on the demo corpus, with
    the overlapped evaluation on."""
    from eegan_tpu_torch.train import main as train_main

    tmp = tmp_path_factory.mktemp("eval_cli")
    data = build_corpus(tmp / "data", n_files=12)
    save = str(tmp / "out")
    train_main(["--device", "cpu", "--cfg", CFG, "--output_dir", "run",
                "--batch_size", "2", "--max_epochs", "1", "--max_iters", "1",
                "--eval_overlap", "--eval_nums", "4",
                *_overrides(data, save)])
    return dict(data=data, save=save, model=os.path.join(save, "run",
                                                         "Model"))


def test_train_eval_overlap_logs_r_precision(run):
    path = os.path.join(run["save"], "run", "writer", "metrics.jsonl")
    with open(path) as f:
        records = [json.loads(line) for line in f]
    evals = [r for r in records if "eval/r_precision" in r]
    assert len(evals) == 1 and evals[0]["step"] == 1
    assert 0.0 <= evals[0]["eval/r_precision"] <= 1.0
    assert not any("eval/error" in r for r in records)


def test_test_cli_sweeps_the_run(run):
    out = _run("eegan_tpu_torch.test", "--cfg", CFG, "--model_dir",
               run["model"], "--select_epochs", "1", "--sampling_nums", "4",
               "--batch_size", "2", "--saving_image", "--compare_sim",
               "--output_dir", "eval", *_overrides(run["data"], run["save"]))
    folder = os.path.join(run["save"], "eval", "GenImage", "Epoch_1_0")
    assert len([f for f in os.listdir(folder) if f.endswith(".png")]) == 4
    r = float(re.search(r"'r_precision_mean': ([0-9.e-]+)", out).group(1))
    assert 0.0 <= r <= 1.0


def test_fid_score_cli(run):
    gen_root = os.path.join(run["save"], "fid", "GenImage")
    _run("eegan_tpu_torch.test", "--cfg", CFG, "--model_dir", run["model"],
         "--select_epochs", "1", "--sampling_nums", "4", "--batch_size", "2",
         "--saving_image", "--output_dir", "fid",
         *_overrides(run["data"], run["save"]))
    npz = os.path.join(run["save"], "test_stats.npz")
    _run("eegan_tpu_torch.fid_score", "--dataset_npz", npz, "--cfg", CFG,
         "--max_images", "6", "--batch_size", "3",
         *_overrides(run["data"], run["save"]))
    with np.load(npz) as f:
        assert f["mu"].shape == (2048,) and f["sigma"].shape == (2048, 2048)
    out = _run("eegan_tpu_torch.fid_score", "--eval_image_folder", gen_root,
               "--compared_path", npz, "--select_epochs", "1",
               "--batch_size", "4")
    fid = float(re.search(r"Epoch_1_0: FID = ([0-9.e+-]+)", out).group(1))
    assert math.isfinite(fid) and fid >= 0.0


def test_sample_from_dataset_with_model_dir(run):
    sets = [s for s in _overrides(run["data"], run["save"]) if s != "--set"]
    cfg = apply_overrides(fresh_config(CFG), sets)
    jcfg = jax_fresh_config(CFG)
    jax_apply_overrides(jcfg, sets)
    jds = JaxTextImageDataset(jcfg, split="test")
    rng = np.random.default_rng([SEED])
    idxs = rng.integers(0, len(jds), 3)
    want = [jds.sample(int(i), rng) for i in idxs]

    from eegan_tpu_torch.sample import dataset_batch

    got = dataset_batch(TextImageDataset(cfg, split="test"), 3, SEED)
    for k, g in zip(("caps", "cap_lens", "attrs", "attr_lens", "img256"),
                    got):
        np.testing.assert_array_equal(g, np.stack([s[k] for s in want]),
                                      err_msg=k)

    _run("eegan_tpu_torch.sample", "--cfg", CFG, "--from_dataset",
         "--model_dir", run["model"], "--epoch", "1", "--batch_size", "3",
         "--manualSeed", str(SEED), "--output_dir", "samples",
         *_overrides(run["data"], run["save"]))
    vis = os.path.join(run["save"], "samples")
    with open(os.path.join(vis, "dataset_example.txt")) as f:
        text = f.read()
    for i, s in enumerate(want):
        words = " ".join(jds.ixtoword[int(w)]
                         for w in s["caps"][:s["cap_lens"]])
        assert f"[{i}] {words}" in text
        for name in ("samples.png", "sample_0.png", "caption.txt"):
            assert os.path.isfile(os.path.join(vis, f"cap_{i}", name))
    assert os.path.isfile(os.path.join(vis, "real_images",
                                       "real_images.png"))


@pytest.mark.parametrize("module,args", [
    ("test", []), ("fid_score", ["--eval_image_folder", "."]),
    ("inception_score", ["--eval_image_folder", "."]),
    ("finetune_inception", ["--synthetic"])])
def test_entry_points_need_a_gpu_unless_told_cpu(module, args):
    if torch.cuda.is_available():
        return
    main = __import__(f"eegan_tpu_torch.{module}", fromlist=["main"]).main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)
