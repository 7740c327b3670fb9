"""The port's DAMSM pretraining (``training/damsm_trainer.py``), its AttnGAN
``.pth`` loader (``utils/convert.load_damsm_encoders``) and the two CLIs
(``eegan_tpu_torch.pretrain_damsm``, ``eegan_tpu_torch.train``) on the CPU.

* One DAMSM step against the JAX package's ``make_damsm_train_step`` from
  the same weights and batch, dropout 0 on both sides (the JAX text
  encoder through ``clone(drop_prob=0.0)``): metrics rtol 1e-4; the
  gradients each Adam took, read from its moments (the first moment is
  (1 - b1)·g after the clip, the second (1 - b2)·g²), within 1e-4
  relative L2 of JAX's over each encoder and 1e-2 per tensor (the
  Inception stem's convs read up to 2.4e-3: their gradients come back
  through the whole trunk; the encoders as a whole 3e-6 and 8e-6), and
  the text side's global norm at
  RNN_GRAD_CLIP on both sides (the clip bites in this batch); the updated
  parameters within 2·ENCODER_LR with at most 1% of the entries beyond
  ENCODER_LR/100 (PERF.md §2's bar for an Adam step: its first step
  moves an entry by about lr·sign(g), whatever g's size), and every tensor
  the step trains has moved.
* The float32 step against the same step in float64 (``factory.
  to_float64_``), from the same start: the gradients each Adam took lie
  1.65e-4 (relative L2) from float64's over the Inception trunk, 5.4e-3 at
  its worst tensor (Mixed_7c.branch3x3_1), and 3e-6 / 5e-6 over the text
  encoder and the image heads; held to 1e-3, 5e-2 and 1e-4. This is the
  yardstick ``chip_smoke.py`` phase 15 holds the card's trunk gradients
  to: float32 rounding moves them by about 1e-4 of their norm, where
  cuDNN's float32 conv forward moves them by a few per cent.
* ``load_damsm_encoders`` against the JAX package's loader on random
  AttnGAN-keyed ``.pth`` files (the image side from
  ``tests/torch_inception_ref.py``): encoder outputs within 1e-4 of the
  largest magnitude.
* Both CLIs exit non-zero without a GPU unless given ``--device cpu``; a
  pretraining run's encoders load into the trainer through the directory
  branch.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eegan_tpu.config import Config as JaxConfig
from eegan_tpu.models.factory import build_models as jax_build_models
from eegan_tpu.training.damsm_trainer import (
    make_damsm_train_step as jax_make_damsm_train_step,
)
from eegan_tpu.training.state import FrozenEncoders as JaxFrozenEncoders
from eegan_tpu.utils import torch_convert
from eegan_tpu_torch.config import Config
from eegan_tpu_torch.data.synthetic import synthetic_batch
from eegan_tpu_torch.models.factory import (
    build_models,
    randomize_,
    to_float64_,
)
from eegan_tpu_torch.training.damsm_trainer import make_damsm_train_step
from eegan_tpu_torch.training.state import FrozenEncoders
from eegan_tpu_torch.utils.convert import (
    from_jax_image_encoder,
    from_jax_text_encoder,
    load_damsm_encoders,
)

from torch_inception_ref import RefCNNEncoder, randomize

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N_WORDS, EMB = 4, 40, 32
CLASS_IDS = np.array([1, 2, 1, 3], np.int32)  # 0 and 2 share a class


def configs():
    out = []
    for c in (Config(), JaxConfig()):
        c.GAN.GF_DIM = c.GAN.DF_DIM = 4
        c.TEXT.EMBEDDING_DIM = EMB
        c.TRAIN.CLASS_NUM = 5
        c.RUNTIME.COMPUTE_DTYPE = "float32"
        out.append(c)
    return out


def _np(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def _template(module, *args, **kw):
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                              **kw))


def jax_encoder_vars(jm, text_sd, image_sd, words_num):
    text_vars = torch_convert.convert_text_encoder(text_sd, _template(
        jm.text_encoder, jnp.zeros((2, words_num), jnp.int32),
        jnp.ones((2,), jnp.int32)))
    image_vars = torch_convert.convert_image_encoder(
        image_sd, _template(jm.image_encoder, jnp.zeros((2, 64, 64, 3))))
    return text_vars, image_vars


@pytest.fixture(scope="module")
def damsm_step():
    cfg, jcfg = configs()
    models = build_models(cfg, N_WORDS, device="cpu")
    randomize_(models.text_encoder, 1)
    randomize_(models.image_encoder, 2)
    models.text_encoder.drop.p = 0.0
    jm = jax_build_models(jcfg, N_WORDS)
    jm = dataclasses.replace(
        jm, text_encoder=jm.text_encoder.clone(drop_prob=0.0))
    text_vars, image_vars = jax_encoder_vars(
        jm, _np(models.text_encoder), _np(models.image_encoder),
        cfg.TEXT.WORDS_NUM)
    batch = synthetic_batch(cfg, B, seed=4, n_words=N_WORDS)
    batch["class_ids"] = CLASS_IDS

    before = {"text": _np(models.text_encoder),
              "image": _np(models.image_encoder)}
    step, init_opt = make_damsm_train_step(cfg, models)
    opts = init_opt(models.text_encoder, models.image_encoder)
    metrics = step(opts, batch)

    jstep, jinit = jax_make_damsm_train_step(jcfg, jm)
    new_text, new_image, jopts, jmetrics = jstep(
        text_vars, image_vars, jinit(text_vars, image_vars), batch,
        jax.random.PRNGKey(0))
    return dict(cfg=cfg, models=models, before=before, metrics=metrics,
                jmetrics=jmetrics, new_text=new_text, new_image=new_image,
                opts=opts, jopts=jopts)


def test_damsm_step_metrics_match_jax(damsm_step):
    got, want = damsm_step["metrics"], damsm_step["jmetrics"]
    assert set(got) == set(want) == {"damsm/s_loss", "damsm/w_loss",
                                     "damsm/total"}
    for k in want:
        assert np.isfinite(float(got[k]))
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)


def _jax_adam(opt_state):
    """The one ``ScaleByAdamState`` in an optax state (``adam`` alone or
    chained after the clip)."""
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam)
             if is_adam(s)]
    assert len(found) == 1
    return found[0]


def test_damsm_step_gradients_match_jax(damsm_step):
    """Adam's moments after one step hold the (clipped) gradient: compared
    by relative L2 per tensor, they catch a wrong loss backward or clip
    that the parameters, moved by about lr·sign(g), cannot show."""
    cfg = damsm_step["cfg"]
    b1, clip = 0.5, cfg.TRAIN.RNN_GRAD_CLIP
    models = damsm_step["models"]
    norms = {}
    for name, module, opt, jopt, convert in (
            ("text", models.text_encoder, damsm_step["opts"][0],
             damsm_step["jopts"][0], from_jax_text_encoder),
            ("image", models.image_encoder, damsm_step["opts"][1],
             damsm_step["jopts"][1], from_jax_image_encoder)):
        jadam = _jax_adam(jopt)
        assert int(jadam.count) == 1
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            want = convert({"params": getattr(jadam, moment)})
            gs, ws = [], []
            for k, p in module.named_parameters():
                g = opt.state[p][key].numpy().astype(np.float64)
                w = want[k].numpy().astype(np.float64)
                assert g.shape == w.shape, (name, k)
                assert np.linalg.norm(w) > 0, (name, moment, k)
                rel = np.linalg.norm(g - w) / np.linalg.norm(w)
                assert rel <= 1e-2, (name, moment, k, rel)
                gs.append(g.ravel())
                ws.append(w.ravel())
            g, w = np.concatenate(gs), np.concatenate(ws)
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel <= 1e-4, (name, moment, rel)
            if moment == "mu":
                norms[name] = {"port": np.linalg.norm(g) / (1 - b1),
                               "jax": np.linalg.norm(w) / (1 - b1)}
    # The clip bites: both text sides stepped with a gradient of norm CLIP.
    for side, n in norms["text"].items():
        assert abs(n - clip) <= 1e-5 * clip, (side, n)
    # The image side is not clipped (and its gradient is larger here).
    assert norms["image"]["jax"] > clip


def test_damsm_step_parameters_match_jax(damsm_step):
    lr = damsm_step["cfg"].TRAIN.ENCODER_LR
    models, before = damsm_step["models"], damsm_step["before"]
    for name, module, want in (
            ("text", models.text_encoder,
             from_jax_text_encoder(damsm_step["new_text"])),
            ("image", models.image_encoder,
             from_jax_image_encoder(damsm_step["new_image"]))):
        got = _np(module)
        trained = {n for n, p in module.named_parameters()}
        assert trained <= set(want), name
        n = n_off = 0
        for k, w in want.items():
            err = np.abs(got[k] - w.numpy())
            if k in trained:
                assert err.max() <= 2 * lr + 1e-6, (name, k, err.max())
                assert not np.array_equal(got[k], before[name][k]), (name, k)
                n += err.size
                n_off += int((err > lr / 100).sum())
            elif not k.endswith("num_batches_tracked"):
                # BN running stats: eval mode, untouched on both sides
                np.testing.assert_array_equal(got[k], before[name][k], k)
                np.testing.assert_allclose(got[k], w.numpy(), rtol=1e-6,
                                           err_msg=k)
        assert n_off <= 0.01 * n, (name, n_off, n)


def test_damsm_step_float32_gradients_against_float64(damsm_step):
    cfg = damsm_step["cfg"]
    models = build_models(cfg, N_WORDS, device="cpu")
    for seed, module in ((1, models.text_encoder),
                         (2, models.image_encoder)):
        to_float64_(randomize_(module, seed))
    models.text_encoder.drop.p = 0.0
    batch = synthetic_batch(cfg, B, seed=4, n_words=N_WORDS)
    batch["class_ids"] = CLASS_IDS
    step, init_opt = make_damsm_train_step(cfg, models)
    opts64 = init_opt(models.text_encoder, models.image_encoder)
    step(opts64, batch)

    def moments(opts, module, j, select):
        return {k: opts[j].state[p]["exp_avg"].double()
                for k, p in module.named_parameters() if select(k)}

    for name, j, select, bar, worst_bar in (
            ("text", 0, lambda k: True, 1e-4, None),
            ("heads", 1, lambda k: k.startswith("emb_"), 1e-4, None),
            ("trunk", 1, lambda k: not k.startswith("emb_"), 1e-3, 5e-2)):
        enc = ("text_encoder", "image_encoder")[j]
        got = moments(damsm_step["opts"], getattr(damsm_step["models"], enc),
                      j, select)
        want = moments(opts64, getattr(models, enc), j, select)
        assert got and set(got) == set(want), name
        flat = [torch.cat([d[k].flatten() for k in want]) for d in (got, want)]
        rel = float((flat[0] - flat[1]).norm() / flat[1].norm())
        assert rel <= bar, (name, rel)
        if worst_bar is not None:
            worst = max(float((got[k] - want[k]).norm() / want[k].norm())
                        for k in want)
            assert worst <= worst_bar, (name, worst)


def test_text_dropout_follows_its_generator():
    cfg, _ = configs()
    enc = build_models(cfg, N_WORDS, device="cpu").text_encoder.train()
    caps = torch.randint(1, N_WORDS, (3, cfg.TEXT.WORDS_NUM),
                         generator=torch.Generator().manual_seed(0))
    lens = torch.tensor([cfg.TEXT.WORDS_NUM, 5, 1])
    run = lambda seed: enc(caps, lens, torch.Generator().manual_seed(seed))
    a, b, c = run(7), run(7), run(8)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[1], c[1])
    enc.eval()
    d, e = enc(caps, lens, torch.Generator().manual_seed(7)), enc(caps, lens)
    assert torch.equal(d[1], e[1]) and not torch.equal(d[1], a[1])


def test_load_damsm_encoders_matches_jax(tmp_path, capsys):
    """AttnGAN .pth files (RNN_ENCODER keys, torchvision Inception keys)
    through both loaders: same encoder outputs."""
    cfg, jcfg = configs()
    text_src = build_models(cfg, N_WORDS, device="cpu").text_encoder
    randomize_(text_src, 5)
    image_src = RefCNNEncoder(nef=EMB)
    randomize(image_src, 6)
    text_pth = str(tmp_path / "text_encoder200.pth")
    torch.save({k: v for k, v in text_src.state_dict().items()}, text_pth)
    torch.save({k: v for k, v in image_src.state_dict().items()
                if not k.endswith("num_batches_tracked")},
               str(tmp_path / "image_encoder200.pth"))

    models = build_models(cfg, N_WORDS, device="cpu")
    frozen = FrozenEncoders(models.text_encoder.eval(),
                            models.image_encoder.eval())
    assert load_damsm_encoders(text_pth, frozen) is frozen
    jm = jax_build_models(jcfg, N_WORDS)
    init_text, init_image = jax_encoder_vars(
        jm, _np(text_src), _np(image_src), cfg.TEXT.WORDS_NUM)
    jfrozen = torch_convert.load_damsm_encoders(
        text_pth, jm, JaxFrozenEncoders(text_vars=init_text,
                                        image_vars=init_image))

    rng = np.random.RandomState(7)
    caps = rng.randint(1, N_WORDS, (3, cfg.TEXT.WORDS_NUM)).astype(np.int32)
    lens = np.array([cfg.TEXT.WORDS_NUM, 6, 1], np.int32)
    img = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = (*frozen.text_encoder(torch.from_numpy(caps),
                                    torch.from_numpy(lens)),
               *frozen.image_encoder(torch.from_numpy(img)))
    want = (*jm.text_encoder.apply(jfrozen.text_vars, caps, lens),
            *jm.image_encoder.apply(jfrozen.image_vars, img, train=False))
    for name, g, w in zip(("words", "sent", "region", "code"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)

    # Without the image file the image encoder keeps its weights.
    os.remove(tmp_path / "image_encoder200.pth")
    keep = _np(models.image_encoder)
    load_damsm_encoders(text_pth, frozen)
    assert "image_encoder200.pth not found" in capsys.readouterr().out
    for k, v in _np(models.image_encoder).items():
        np.testing.assert_array_equal(v, keep[k])
    # A text state dict without the LSTM is refused.
    torch.save({"encoder.weight": text_src.encoder.weight}, text_pth)
    with pytest.raises(KeyError):
        load_damsm_encoders(text_pth, frozen)


@pytest.mark.parametrize("module", ["eegan_tpu_torch.train",
                                    "eegan_tpu_torch.pretrain_damsm"])
def test_cli_needs_a_gpu_unless_told_cpu(module):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", module, "--synthetic"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("flags", [["--mesh", "fsdp:2,data:2"],
                                   ["--distributed", "--mesh",
                                    "data:2,tensor:2"],
                                   ["--mesh", "data:1,model:2"]])
def test_train_cli_refuses_what_is_not_ported(flags):
    from eegan_tpu_torch.train import main

    with pytest.raises(NotImplementedError, match="not ported"):
        main(["--device", "cpu", "--synthetic", *flags])


def tiny_flags(tmp_path):
    return ["--device", "cpu", "--synthetic", "--cfg",
            os.path.join(ROOT, "cfg", "bird.yml"),
            "--set", f"SAVE_DIR={tmp_path}", "--set", "GAN.GF_DIM=4",
            "--set", "GAN.DF_DIM=4", "--set", f"TEXT.EMBEDDING_DIM={EMB}",
            "--set", "TRAIN.CLASS_NUM=5", "--set", "RUNTIME.DATA_WORKERS=0",
            "--set", "RUNTIME.COMPUTE_DTYPE=float32"]


def test_pretrain_then_train_clis_on_cpu(tmp_path, capsys):
    """pretrain_damsm writes the encoders; train --synthetic with
    TEXT.DAMSM_NAME at its Model dir loads them (the directory branch) and
    trains, checkpoints and logs."""
    from eegan_tpu_torch.pretrain_damsm import main as pretrain_main
    from eegan_tpu_torch.train import main as train_main

    pretrain_main(tiny_flags(tmp_path) + [
        "--epochs", "1", "--max_iters", "1", "--batch_size", "2",
        "--output_dir", "damsm"])
    frozen_dir = tmp_path / "damsm" / "Model" / "frozen_encoders"
    assert sorted(os.listdir(frozen_dir)) == ["image_encoder.pth",
                                              "text_encoder.pth"]
    assert (tmp_path / "damsm" / "writer_damsm" / "metrics.jsonl").is_file()

    train_main(tiny_flags(tmp_path) + [
        "--max_epochs", "1", "--max_iters", "1", "--batch_size", "2",
        "--output_dir", "run", "--gpu", "3",
        "--set", f"TEXT.DAMSM_NAME={tmp_path / 'damsm' / 'Model'}"])
    out = capsys.readouterr().out
    assert f"loading DAMSM encoders from directory {frozen_dir}" in out
    run = tmp_path / "run"
    for rel in ("Model/state/1.pt", "Model/netG_1.pth",
                "Model/attr_enhance_1.pth", "Image/epoch_1_256.png",
                "writer/metrics.jsonl"):
        assert (run / rel).is_file(), rel
