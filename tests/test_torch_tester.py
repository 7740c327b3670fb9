"""The port's evaluation sweep (``eegan_tpu_torch.evaluation.tester``) and
overlapped evaluation (``evaluation.async_eval``) against the JAX
package's, on a demo corpus (``data/demo_corpus.py``) at tiny widths
(GF_DIM 4, EMBEDDING_DIM 32) with the full Inception image encoder, on the
CPU.

* Same seed, same draws: the batches, the caption cache's padded tokens
  and ``_sample_wrong_indices`` bit for bit equal to JAX's.
* ``generate`` with JAX's noise (``jax.random.normal(PRNGKey(seed *
  100003 + batch_idx))``) and the same weights (random, converted by the
  JAX package's converters): images within 1e-4, image codes and
  similarities within 1e-4 relative, the R-precision mean and std equal.
* ``saving_images=False`` writes nothing; ``sweep`` skips an epoch without
  a snapshot; ``AsyncEvaluator`` returns ``eval/r_precision`` and records
  ``eval/error`` for a snapshot that does not load.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegan_tpu.config import Config as JaxConfig
from eegan_tpu.data.datasets import TextOnlyDataset as JaxTextOnlyDataset
from eegan_tpu.evaluation.tester import Tester as JaxTester
from eegan_tpu.models.factory import build_models as jax_build_models
from eegan_tpu.training.state import FrozenEncoders as JaxFrozenEncoders
from eegan_tpu.utils import torch_convert
from eegan_tpu_torch.config import Config
from eegan_tpu_torch.data.datasets import TextOnlyDataset
from eegan_tpu_torch.data.demo_corpus import build_corpus
from eegan_tpu_torch.evaluation.async_eval import AsyncEvaluator, eval_bundle
from eegan_tpu_torch.evaluation.tester import Tester
from eegan_tpu_torch.models.factory import build_models, randomize_
from eegan_tpu_torch.training.checkpoint import CheckpointManager
from eegan_tpu_torch.training.state import create_train_state

torch.set_num_threads(1)

B, EMB, SEED, R_VAL = 2, 32, 3, 6


def _sd(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _template(module, *args, **kw):
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                              **kw))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = build_corpus(tmp_path_factory.mktemp("birds"), n_files=12)
    cfg, jcfg = Config(), JaxConfig()
    for c in (cfg, jcfg):
        c.DATA_DIR = root
        c.TEXT.CAPTIONS_PER_IMAGE = 2
        # Shorter than the demo captions, so padding one draws a random
        # subset from the Generator: the order of the draws shows.
        c.TEXT.WORDS_NUM = 6
        c.TEXT.EMBEDDING_DIM = EMB
        c.GAN.GF_DIM = c.GAN.DF_DIM = 4
        c.TRAIN.BATCH_SIZE = B
        c.RUNTIME.COMPUTE_DTYPE = "float32"
        c.RUNTIME.PALLAS_AFFINE = True
    ds = TextOnlyDataset(cfg, split="test")
    models = build_models(cfg, ds.n_words, device="cpu")
    for i, m in enumerate((models.generator, models.attr_enhance,
                           models.text_encoder, models.image_encoder)):
        randomize_(m, 10 + i)
    _, frozen = create_train_state(cfg, models)

    t = cfg.TEXT
    jm = jax_build_models(jcfg, ds.n_words)
    z, s = jnp.zeros((B, jcfg.GAN.Z_DIM)), jnp.zeros((B, EMB))
    g_vars = torch_convert.convert_generator(
        _sd(models.generator),
        _template(jm.generator, z, s, s, train=True))
    a_vars = torch_convert.convert_attr_enhance(
        _sd(models.attr_enhance),
        _template(jm.attr_enhance, s, jnp.zeros((B, t.MAX_ATTR_NUM, EMB))))
    t_vars = torch_convert.convert_text_encoder(
        _sd(models.text_encoder),
        _template(jm.text_encoder, jnp.zeros((B, t.WORDS_NUM), jnp.int32),
                  jnp.ones((B,), jnp.int32)))
    i_vars = torch_convert.convert_image_encoder(
        _sd(models.image_encoder),
        _template(jm.image_encoder, jnp.zeros((1, 64, 64, 3))))
    jfrozen = JaxFrozenEncoders(text_vars=t_vars, image_vars=i_vars)
    jds = JaxTextOnlyDataset(jcfg, split="test")
    return dict(cfg=cfg, ds=ds, models=models, frozen=frozen, jcfg=jcfg,
                jm=jm, jds=jds, jfrozen=jfrozen,
                jweights=(g_vars["params"], a_vars["params"],
                          g_vars["batch_stats"]))


def _recorder(fn, calls):
    def call(*args):
        out = fn(*args)
        calls.append((args, out))
        return out
    return call


def test_draws_equal_jax(setup):
    """The batches, the cache's caption tokens (in the order JAX draws
    them) and the wrong-caption indices, for the same seed."""
    port = Tester(setup["cfg"], setup["models"], setup["frozen"],
                  setup["ds"])
    jax_t = JaxTester(setup["jcfg"], setup["jm"], setup["jfrozen"],
                      setup["jds"], batch_size=B)
    port_calls, jax_calls = [], []
    port._encode_sents = _recorder(port._encode_sents, port_calls)
    jax_t._encode_sents = _recorder(jax_t._encode_sents, jax_calls)
    rngs = [np.random.default_rng([SEED]) for _ in range(2)]
    batches = [list(t._batches(2 * len(setup["ds"]) + 1, rng))
               for t, rng in zip((port, jax_t), rngs)]
    assert len(batches[0]) == len(batches[1]) == len(setup["ds"]) + 1
    for got, want in zip(*batches):
        assert sorted(got) == sorted(want)
        for k in want:
            if k == "keys":
                assert got[k] == want[k]
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    port._caption_cache(rngs[0])
    jax_t._caption_cache(rngs[1])
    n_caps = setup["ds"].img_sum * setup["ds"].embeddings_num
    got_caps = np.concatenate([c[0][0] for c in port_calls])
    got_lens = np.concatenate([c[0][1] for c in port_calls])
    want_caps = np.concatenate([np.asarray(c[0][1]) for c in jax_calls])
    want_lens = np.concatenate([np.asarray(c[0][2]) for c in jax_calls])
    assert len(got_caps) == n_caps
    np.testing.assert_array_equal(got_caps, want_caps[:n_caps])
    np.testing.assert_array_equal(got_lens, want_lens[:n_caps])
    cls = np.asarray(batches[0][0]["class_ids"])
    for _ in range(3):
        got = port._sample_wrong_indices(cls, rngs[0], R_VAL - 1)
        want = jax_t._sample_wrong_indices(cls, rngs[1], R_VAL - 1)
        np.testing.assert_array_equal(got, want)
    assert rngs[0].bit_generator.state == rngs[1].bit_generator.state


def test_generate_matches_jax_with_jax_noise(setup, tmp_path):
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    port = Tester(cfg, setup["models"], setup["frozen"], setup["ds"])
    jax_t = JaxTester(jcfg, setup["jm"], setup["jfrozen"], setup["jds"],
                      batch_size=B)
    z_dim = cfg.GAN.Z_DIM

    def jax_noise(batch_idx, b):
        return torch.from_numpy(np.asarray(jax.random.normal(
            jax.random.PRNGKey(SEED * 100003 + batch_idx), (b, z_dim),
            jnp.float32)))

    port_imgs, jax_imgs, port_sims, jax_codes, jax_sents = [], [], [], [], []
    port.sample_step = _recorder(port.sample_step, port_imgs)
    jax_t.sample_step = _recorder(jax_t.sample_step, jax_imgs)
    port._similarities = _recorder(port._similarities, port_sims)
    jax_t._encode_image = _recorder(jax_t._encode_image, jax_codes)
    jax_t._encode_sents = _recorder(jax_t._encode_sents, jax_sents)
    wrong = []
    jax_t._sample_wrong_indices = _recorder(jax_t._sample_wrong_indices,
                                            wrong)
    kw = dict(sampling_nums=5, seed=SEED, compute_r_precision=True,
              r_val=R_VAL, clusters=2, saving_images=False)
    got = port.generate(str(tmp_path / "port"), noise_fn=jax_noise, **kw)
    want = jax_t.generate(*setup["jweights"], str(tmp_path / "jax"), **kw)
    assert got == want
    assert got["generated"] == 5.0 and len(port_imgs) == 3

    for (_, g), (_, w) in zip(port_imgs, jax_imgs):
        for gi, wi in zip(g, w):
            np.testing.assert_allclose(gi.numpy(), np.asarray(wi),
                                       rtol=1e-4, atol=1e-4)
    cache = jax_t._cap_cache
    true_sents = [np.asarray(out) for _, out in jax_sents[-3:]]
    assert len(port_sims) == len(jax_codes) == len(wrong) == 3
    for (_, (code, sims)), (_, jcode), true, (_, idx) in zip(
            port_sims, jax_codes, true_sents, wrong):
        jcode = np.asarray(jcode)
        np.testing.assert_allclose(code, jcode, rtol=1e-4,
                                   atol=1e-4 * np.abs(jcode).max())
        sent = np.concatenate([true[:, None], cache[idx]], axis=1)
        want_sims = np.einsum("bd,brd->br", jcode, sent) / np.maximum(
            np.linalg.norm(jcode, axis=-1, keepdims=True)
            * np.linalg.norm(sent, axis=-1), 1e-8)
        np.testing.assert_allclose(sims, want_sims, rtol=1e-4,
                                   atol=1e-4 * np.abs(want_sims).max())


def test_saving_images(setup, tmp_path):
    port = Tester(setup["cfg"], setup["models"], setup["frozen"],
                  setup["ds"])
    out = tmp_path / "none"
    res = port.generate(str(out), sampling_nums=3, seed=1,
                        saving_images=False)
    assert res == {"generated": 3.0} and not out.exists()
    out = tmp_path / "pngs"
    port.generate(str(out), sampling_nums=3, seed=1)
    assert len([f for f in os.listdir(out) if f.endswith(".png")]) == 3


def test_sweep_skips_a_missing_epoch(setup, tmp_path, capsys):
    cfg = setup["cfg"]
    models = eval_bundle(setup["models"])
    state, _ = create_train_state(cfg, models)
    ckpt = CheckpointManager(str(tmp_path / "Model"))
    ckpt.save_generator(2, state)
    port = Tester(cfg, models, setup["frozen"], setup["ds"])
    results = port.sweep(ckpt, [1, 2], 1, str(tmp_path / "GenImage"),
                         sampling_nums=2, compute_r_precision=True)
    assert list(results) == [(2, 0)]
    assert 0.0 <= results[(2, 0)]["r_precision_mean"] <= 1.0
    assert "epoch 1: no checkpoint" in capsys.readouterr().out
    assert len(os.listdir(tmp_path / "GenImage" / "Epoch_2_0")) == 2


def test_async_evaluator(setup):
    models = setup["models"]
    evaluator = AsyncEvaluator(
        Tester(setup["cfg"], eval_bundle(models), setup["frozen"],
               setup["ds"]), eval_nums=4, compute_r_precision=True)
    params = dict(models.generator.named_parameters())
    stats = dict(models.generator.named_buffers())
    attr = dict(models.attr_enhance.named_parameters())
    assert evaluator.submit(1, params, attr, stats)
    bad = dict(params)
    bad.pop(next(iter(bad)))  # a snapshot without one tensor does not load
    evaluator.close()
    assert 0.0 <= evaluator.results[1]["eval/r_precision"] <= 1.0
    failing = AsyncEvaluator(evaluator.tester, eval_nums=4)
    assert failing.submit(2, bad, attr, stats)
    failing.close()
    assert failing.results == {2: {"eval/error": 1.0}}
