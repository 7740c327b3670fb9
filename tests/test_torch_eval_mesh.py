"""Evaluation over the mesh on CPU gloo ranks: the port's ``Tester`` and
IS fine-tune split over two ranks (``tests/_torch_parallel_worker.py``
subprocesses, tasks ``sweep`` and ``finetune``) against one process and
against the JAX package's sharded ``Tester``, and the ``test`` and
``finetune_inception`` CLIs with ``--set RUNTIME.MESH=data:2``.

* The sweep (demo corpus, GF_DIM 4, EMBEDDING_DIM 32, the full Inception
  image encoder, B=4, 10 images, R-precision over 6 captions in 2
  clusters, JAX's noise): against one process, the draws bit-equal, the
  hits, R-precision mean and std equal, the images and codes within 1e-5,
  the PNG folders equal file for file and pixel for pixel; against JAX's
  ``Tester`` over ``make_mesh("data:2")`` (the suite's 8 host devices),
  the draws bit-equal, the images within 1e-4, mean and std equal.
* The Inception's ``BatchNorm2d`` bound to the mesh against the same layer
  over the global batch: outputs and running statistics within 1e-6, the
  input and parameter gradients within 1e-5 relative L2.
* One IS fine-tune step at the global batch (B=2, one row per rank)
  against one process, at PERF.md §2's fine-tune bars: the loss rtol 1e-4,
  the running statistics within 1e-4 of each tensor's largest, the head's
  gradient (Adam's first moment) within 1e-3 relative L2 and the whole
  network's within twice the one-process float32 step's distance from
  float64. Any other order of a train-mode batch norm's sums moves a
  random-init Inception's whole gradient about as far as float64 does
  (4.4% against 4.3% at B=4, the mesh's sums against torch's own), so in
  float32 the ranks cannot be held closer than that yardstick. The same
  step in float64, on the ranks and in one process, is held to 1e-5
  relative L2 in both Adam moments, over the network and in every tensor
  (it reads about 1e-12; a gradient one branch does not average reads
  1e-2).
* The CLIs: ``test`` on two ranks prints the one-process R-precision and
  writes the same PNGs (a pixel within rounding of a quantisation step may
  land one level away); ``finetune_inception`` on two ranks saves a
  classifier within an Adam step (2 lr) of the one-process one, its
  running statistics within 1e-3 of each tensor's largest (the forward's
  rounding through the default-initialised Inception's batch norms reaches
  1.04e-4 there); both refuse a
  batch the ranks do not divide, with the JAX script's message.
"""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parallel_worker import record_sweep, sweep_tester
from eegan_tpu.config import Config as JaxConfig
from eegan_tpu.data.datasets import TextOnlyDataset as JaxTextOnlyDataset
from eegan_tpu.evaluation.tester import Tester as JaxTester
from eegan_tpu.models.factory import build_models as jax_build_models
from eegan_tpu.parallel.mesh import make_mesh
from eegan_tpu.training.state import FrozenEncoders as JaxFrozenEncoders
from eegan_tpu.utils import torch_convert
from eegan_tpu_torch.config import Config
from eegan_tpu_torch.data.datasets import TextOnlyDataset
from eegan_tpu_torch.data.demo_corpus import build_corpus
from eegan_tpu_torch.evaluation import inception_finetune
from eegan_tpu_torch.evaluation.async_eval import eval_bundle
from eegan_tpu_torch.models.factory import (
    build_models,
    randomize_,
    to_float64_,
)
from eegan_tpu_torch.models.inception import BatchNorm2d
from eegan_tpu_torch.training.checkpoint import CheckpointManager
from eegan_tpu_torch.training.state import create_train_state
from test_torch_parallel import ROOT, WORKER, _env, _free_port, _wait
from test_torch_tester import _sd, _template

torch.set_num_threads(1)

RANKS = 2
B, EMB, SEED, R_VAL, CLUSTERS, N_IMAGES = 4, 32, 3, 6, 2, 10
SWEEP_KW = dict(sampling_nums=N_IMAGES, seed=SEED, compute_r_precision=True,
                r_val=R_VAL, clusters=CLUSTERS)
CLASSES, FT_BATCH, LR = 5, 2, 1e-4
CLI_TIMEOUT_S = 240


def _start_ranks(task, inputs, tmp):
    """``task`` on RANKS gloo ranks, started; :func:`_results` waits."""
    in_path, out_path = str(tmp / f"{task}.pt"), str(tmp / f"{task}.out")
    torch.save(inputs, in_path)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, task, coord, str(RANKS), str(r), in_path,
         out_path], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    return procs, out_path


def _results(started):
    procs, out_path = started
    _wait(procs)
    return [torch.load(f"{out_path}.{r}", weights_only=False)
            for r in range(RANKS)]


def _pngs(folder):
    return {f: np.asarray(Image.open(os.path.join(folder, f)))
            for f in sorted(os.listdir(folder)) if f.endswith(".png")}


def _sweep_config(root, cfg):
    cfg.DATA_DIR = root
    cfg.TEXT.CAPTIONS_PER_IMAGE = 2
    cfg.TEXT.WORDS_NUM = 6  # shorter than the captions: padding draws
    cfg.TEXT.EMBEDDING_DIM = EMB
    cfg.GAN.GF_DIM = cfg.GAN.DF_DIM = 4
    cfg.TRAIN.BATCH_SIZE = B
    cfg.RUNTIME.COMPUTE_DTYPE = "float32"
    cfg.RUNTIME.PALLAS_AFFINE = True
    return cfg


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_mesh")
    root = build_corpus(tmp / "birds", n_files=12)
    cfg = _sweep_config(root, Config())
    jcfg = _sweep_config(root, JaxConfig())
    ds = TextOnlyDataset(cfg, split="test")
    models = build_models(cfg, ds.n_words, device="cpu")
    names = ("generator", "attr_enhance", "text_encoder", "image_encoder")
    for i, name in enumerate(names):
        randomize_(getattr(models, name), 10 + i)
    batches = -(-N_IMAGES // B)
    noise = [np.asarray(jax.random.normal(
        jax.random.PRNGKey(SEED * 100003 + i), (B, cfg.GAN.Z_DIM),
        jnp.float32)) for i in range(batches)]
    inputs = dict(config=cfg, noise=noise, out_dir=str(tmp / "mesh"),
                  kw=SWEEP_KW,
                  weights={n: getattr(models, n).state_dict() for n in names})
    started = _start_ranks("sweep", inputs, tmp)

    one = record_sweep(sweep_tester(inputs), str(tmp / "one"), noise,
                       **SWEEP_KW)

    t = cfg.TEXT
    jm = jax_build_models(jcfg, ds.n_words)
    z, s = jnp.zeros((B, jcfg.GAN.Z_DIM)), jnp.zeros((B, EMB))
    g_vars = torch_convert.convert_generator(
        _sd(models.generator), _template(jm.generator, z, s, s, train=True))
    a_vars = torch_convert.convert_attr_enhance(
        _sd(models.attr_enhance),
        _template(jm.attr_enhance, s, jnp.zeros((B, t.MAX_ATTR_NUM, EMB))))
    jfrozen = JaxFrozenEncoders(
        text_vars=torch_convert.convert_text_encoder(
            _sd(models.text_encoder),
            _template(jm.text_encoder, jnp.zeros((B, t.WORDS_NUM), jnp.int32),
                      jnp.ones((B,), jnp.int32))),
        image_vars=torch_convert.convert_image_encoder(
            _sd(models.image_encoder),
            _template(jm.image_encoder, jnp.zeros((1, 64, 64, 3)))))
    jax_t = JaxTester(jcfg, jm, jfrozen, JaxTextOnlyDataset(jcfg,
                                                            split="test"),
                      batch_size=B, mesh=make_mesh("data:2"))
    jrec = {"images": [], "sents": []}
    sample, encode = jax_t.sample_step, jax_t._encode_sents

    def jax_sample(*args):
        out = sample(*args)
        jrec["images"].append([np.asarray(o) for o in out])
        return out

    def jax_encode(variables, caps, lens):
        jrec["sents"].append((np.asarray(caps), np.asarray(lens)))
        return encode(variables, caps, lens)

    jax_t.sample_step, jax_t._encode_sents = jax_sample, jax_encode
    jrec["result"] = jax_t.generate(
        g_vars["params"], a_vars["params"], g_vars["batch_stats"],
        str(tmp / "jax"), saving_images=False, **SWEEP_KW)
    return dict(one=one, ranks=_results(started), jax=jrec, tmp=tmp,
                n_caps=ds.img_sum * ds.embeddings_num)


def test_sweep_ranks_draw_what_one_process_draws(sweep):
    one, ranks, n_caps = sweep["one"], sweep["ranks"], sweep["n_caps"]
    for rank in ranks:
        assert len(rank["sents"]) == len(one["sents"])
        for (caps, lens, _), (want_caps, want_lens, _) in zip(
                rank["sents"], one["sents"]):
            rows = len(want_caps)
            np.testing.assert_array_equal(caps[:rows], want_caps)
            np.testing.assert_array_equal(lens[:rows], want_lens)
            assert rows == n_caps or len(caps) == rows
        assert rank["result"] == one["result"]
        assert one["result"]["generated"] == float(N_IMAGES)
        for got, want in zip(rank["hits"], one["hits"]):
            np.testing.assert_array_equal(got, want)


def test_sweep_ranks_generate_one_process_rows(sweep):
    one, ranks = sweep["one"], sweep["ranks"]
    assert len(ranks[0]["images"]) == len(one["images"]) == -(-N_IMAGES // B)
    for batch, want in enumerate(one["images"]):
        for scale, w in enumerate(want):
            got = torch.cat([r["images"][batch][scale] for r in ranks])
            assert got.shape == w.shape
            torch.testing.assert_close(got, w, rtol=0, atol=1e-5)
    for rank in ranks:
        assert len(rank["sims"]) == len(one["sims"])
        for (code, sims), (want_code, want_sims) in zip(rank["sims"],
                                                        one["sims"]):
            np.testing.assert_allclose(
                code, want_code, rtol=0,
                atol=1e-5 * np.abs(want_code).max())
            np.testing.assert_allclose(sims, want_sims, rtol=0, atol=1e-5)


def test_sweep_ranks_write_the_one_process_folder(sweep):
    got = _pngs(sweep["tmp"] / "mesh")
    want = _pngs(sweep["tmp"] / "one")
    assert len(want) == N_IMAGES
    assert list(got) == list(want)
    for name, pixels in want.items():
        np.testing.assert_array_equal(got[name], pixels, err_msg=name)


def test_sweep_ranks_match_jax_mesh(sweep):
    ranks, jrec, n_caps = sweep["ranks"], sweep["jax"], sweep["n_caps"]
    assert jrec["result"] == ranks[0]["result"]
    assert len(jrec["images"]) == len(ranks[0]["images"])
    for batch, want in enumerate(jrec["images"]):
        for scale, w in enumerate(want):
            got = torch.cat([r["images"][batch][scale] for r in ranks])
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-4,
                                       atol=1e-4)
    port_calls = ranks[0]["sents"]
    assert len(port_calls) == len(jrec["sents"])
    for (caps, lens, _), (want_caps, want_lens) in zip(port_calls,
                                                       jrec["sents"]):
        rows = min(len(caps), len(want_caps), n_caps)
        np.testing.assert_array_equal(caps[:rows], want_caps[:rows])
        np.testing.assert_array_equal(lens[:rows], want_lens[:rows])


@pytest.fixture(scope="module")
def finetune(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("finetune_mesh")
    cfg = Config()
    cfg.TRAIN.CLASS_NUM = CLASSES - 1
    cfg.RUNTIME.COMPUTE_DTYPE = "float32"
    model = randomize_(inception_finetune.build_is_model(cfg, "cpu"), 4)
    rng = np.random.RandomState(5)
    batch = {"img256": rng.uniform(-1, 1, (FT_BATCH, 256, 256, 3)).astype(
                 np.float32),
             "class_ids": np.array([3, CLASSES - 1], np.int32)}
    bn = randomize_(BatchNorm2d(8, eps=1e-3), 6)
    x = torch.from_numpy(rng.randn(4, 8, 5, 3).astype(np.float32) * 2 + 1)
    dy = torch.from_numpy(rng.randn(4, 8, 5, 3).astype(np.float32))
    inputs = dict(config=cfg, model=model.state_dict(), batch=batch, lr=LR,
                  bn=bn.state_dict(), x=x, dy=dy)
    started = _start_ranks("finetune", inputs, tmp)

    bn.train()
    xg = x.clone().requires_grad_(True)
    y = bn(xg)
    (y * dy).sum().backward()
    one_bn = {"y": y.detach(), "dx": xg.grad, "dweight": bn.weight.grad,
              "dbias": bn.bias.grad, "state": bn.state_dict()}

    def step(module, batch):
        fn, init_opt = inception_finetune.make_finetune_step(cfg, module, LR)
        opt = init_opt(module)
        metrics = {k: float(v) for k, v in fn(opt, batch).items()}
        return metrics, {(n, key): opt.state[p][key].clone()
                         for n, p in module.named_parameters()
                         for key in ("exp_avg", "exp_avg_sq")}

    metrics, moments = step(model, batch)
    model64 = to_float64_(randomize_(
        inception_finetune.build_is_model(cfg, "cpu"), 4))
    metrics64, moments64 = step(model64, {
        k: v.astype(np.float64) if k == "img256" else v
        for k, v in batch.items()})
    return dict(ranks=_results(started), bn=one_bn, metrics=metrics,
                moments=moments, moments64=moments64, metrics64=metrics64,
                state=model.state_dict(), state64=model64.state_dict())


def _rel(got, want):
    a = torch.cat([g.double().reshape(-1) for g in got])
    b = torch.cat([w.double().reshape(-1) for w in want])
    return float((a - b).norm() / b.norm())


def test_inception_batchnorm_over_the_mesh(finetune):
    want = finetune["bn"]
    ranks = [r["bn"] for r in finetune["ranks"]]
    for key in ("y", "dx"):
        got = torch.cat([r[key] for r in ranks])
        if key == "y":
            torch.testing.assert_close(got, want[key], rtol=0, atol=1e-6)
        else:
            assert _rel([got], [want[key]]) <= 1e-5
    for key in ("dweight", "dbias"):
        assert _rel([sum(r[key] for r in ranks)], [want[key]]) <= 1e-5, key
    for r in ranks:
        for k, v in want["state"].items():
            torch.testing.assert_close(r["state"][k], v, rtol=1e-6,
                                       atol=1e-6, msg=k)


def test_finetune_step_over_the_mesh(finetune):
    want = finetune["moments"]
    heads = [k for k in want if k[0].startswith("fc.")]
    firsts = [k for k in want if k[1] == "exp_avg"]
    yardstick = _rel([want[k] for k in firsts],
                     [finetune["moments64"][k] for k in firsts])
    assert 0 < yardstick < 0.5
    for rank in finetune["ranks"]:
        got = rank["finetune"]
        for k, v in finetune["metrics"].items():
            assert math.isclose(got["metrics"][k], v, rel_tol=1e-4,
                                abs_tol=1e-6), k
        assert set(got["moments"]) == set(want)
        assert _rel([got["moments"][k] for k in heads
                     if k[1] == "exp_avg"],
                    [want[k] for k in heads if k[1] == "exp_avg"]) <= 1e-3
        assert _rel([got["moments"][k] for k in firsts],
                    [want[k] for k in firsts]) <= 2 * yardstick
        moved = 0
        for k, v in finetune["state"].items():
            if k.endswith("num_batches_tracked"):
                assert int(got["state"][k]) == 1, k
            elif "running_" in k:
                torch.testing.assert_close(
                    got["state"][k], v, rtol=0,
                    atol=1e-4 * float(v.abs().max()), msg=k)
                moved += 1
        assert moved > 100
    ranks = finetune["ranks"]
    assert ranks[0]["finetune"]["metrics"] == ranks[1]["finetune"]["metrics"]
    for k, v in ranks[0]["finetune"]["state"].items():
        torch.testing.assert_close(ranks[1]["finetune"]["state"][k], v,
                                   rtol=0, atol=0, msg=k)


def test_finetune_step_over_the_mesh_float64(finetune):
    """The same step in float64 on the ranks and in one process: rounding
    no longer hides a fault, so the ranks are held to PERF.md §2's 1e-5
    relative L2 in every tensor's Adam moments."""
    for rank in finetune["ranks"]:
        got = rank["finetune64"]
        for k, v in finetune["metrics64"].items():
            assert math.isclose(got["metrics"][k], v, rel_tol=1e-9,
                                abs_tol=1e-12), k
        want = finetune["moments64"]
        assert set(got["moments"]) == set(want)
        for moment in ("exp_avg", "exp_avg_sq"):
            keys = [k for k in want if k[1] == moment]
            assert _rel([got["moments"][k] for k in keys],
                        [want[k] for k in keys]) <= 1e-5, moment
            for k in keys:
                assert _rel([got["moments"][k]], [want[k]]) <= 1e-5, k
        for k, v in finetune["state64"].items():
            if "running_" in k:
                torch.testing.assert_close(
                    got["state"][k], v, rtol=0,
                    atol=1e-9 * float(v.abs().max()), msg=k)


def _cli(module, args, cwd):
    return subprocess.Popen(
        [sys.executable, "-m", f"eegan_tpu_torch.{module}", "--device",
         "cpu", *args], cwd=str(cwd), env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _finish(procs):
    try:
        outs = [p.communicate(timeout=CLI_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_clis_over_the_mesh(tmp_path):
    root = build_corpus(tmp_path / "birds", n_files=12)
    cfg = _sweep_config(root, Config())
    ds = TextOnlyDataset(cfg, split="test")
    torch.manual_seed(SEED)
    models = eval_bundle(build_models(cfg, ds.n_words, device="cpu"))
    randomize_(models.generator, 20)
    state, _ = create_train_state(cfg, models)
    model_dir = tmp_path / "Model"
    CheckpointManager(str(model_dir)).save_generator(1, state)
    common = ["--cfg", os.path.join(ROOT, "cfg", "bird.yml"),
              "--set", f"SAVE_DIR={tmp_path}", "--set", f"DATA_DIR={root}",
              "--set", "TEXT.CAPTIONS_PER_IMAGE=2",
              "--set", f"TEXT.EMBEDDING_DIM={EMB}", "--set", "GAN.GF_DIM=4",
              "--set", "GAN.DF_DIM=4", "--set", "RUNTIME.DATA_WORKERS=0",
              "--set", "RUNTIME.COMPUTE_DTYPE=float32"]
    sweep_args = common + ["--debug", "--model_dir", str(model_dir),
                           "--select_epochs", "1", "--sampling_nums", "6",
                           "--compare_sim", "--saving_image"]
    tune_args = common + ["--synthetic", "--epochs", "1", "--max_iters", "1",
                          "--set", f"TRAIN.CLASS_NUM={CLASSES - 1}"]
    procs = [
        _cli("test", sweep_args + ["--batch_size", "4", "--debug_output_dir",
                                   run, "--set", f"RUNTIME.MESH={mesh}"],
             tmp_path) for run, mesh in (("one", "data:1"),
                                         ("mesh", "data:2"))]
    procs += [
        _cli("finetune_inception", tune_args + [
            "--batch_size", "2", "--output_dir", run,
            "--set", f"RUNTIME.MESH={mesh}"], tmp_path)
        for run, mesh in (("is_one", "data:1"), ("is_mesh", "data:2"))]
    procs += [_cli("test", sweep_args + ["--batch_size", "3", "--set",
                                         "RUNTIME.MESH=data:2"], tmp_path),
              _cli("finetune_inception", tune_args + [
                  "--batch_size", "3", "--set", "RUNTIME.MESH=data:2"],
                  tmp_path)]
    outs = _finish(procs)
    for p, out in zip(procs[:4], outs):
        assert p.returncode == 0, out
    for p, out in zip(procs[4:], outs[4:]):
        assert p.returncode != 0
        assert "batch size 3 not divisible by 2 devices" in out, out

    def result_lines(out):
        return [ln for ln in out.splitlines() if ln.startswith("Epoch_1_0")]

    one, mesh = result_lines(outs[0]), result_lines(outs[1])
    assert len(one) == 2 and "r_precision_mean" in one[-1]
    assert mesh == one
    folders = [_pngs(tmp_path / run / "GenImage" / "Epoch_1_0")
               for run in ("one", "mesh")]
    assert len(folders[0]) == 6 and list(folders[1]) == list(folders[0])
    # Images within rounding of each other: a pixel whose value lies that
    # near a quantisation step's edge may land one level away.
    for name, pixels in folders[0].items():
        diff = np.abs(folders[1][name].astype(int) - pixels)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, name

    got, want = (torch.load(tmp_path / run / "is_inception.pt")
                 for run in ("is_mesh", "is_one"))
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(v) == 1, k
        elif "running_" in k:  # rounding, grown through 94 batch norms
            torch.testing.assert_close(got[k], v, rtol=0,
                                       atol=1e-3 * float(v.abs().max()),
                                       msg=k)
        else:  # one Adam step moves an entry by about lr
            assert float((got[k] - v).abs().max()) <= 2 * LR + 1e-6, k
