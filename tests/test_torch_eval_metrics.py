"""The port's evaluation metrics (``eegan_tpu_torch.evaluation.fid``,
``inception_score`` and ``inception_finetune``) against the JAX package's.

* The host math (``frechet_distance``, ``activation_statistics``,
  ``inception_score_from_probs``) on seeded numpy inputs: equal to JAX's
  within 1e-10 relative; the ``.npz`` statistics round trip.
* The networks at Inception's full widths at 299², B=2, random weights and
  BN running stats (``randomize_``) reaching the JAX trees through the JAX
  package's own converter: ``FIDExtractor.features`` within 1e-4 of the
  largest feature, ``InceptionScorer.probs`` within 1e-5.
* One IS fine-tune step against JAX's ``make_finetune_step`` from the same
  weights and batch: the loss at rtol 1e-4, the BN running statistics
  within 1e-4 of each tensor's largest magnitude, and the gradient Adam took (its first moment over 1 - b1;
  PERF.md §2: Adam's first update is about lr·sign(g), so only the moments
  show the gradient): the classifier head's within 1e-3 relative L2, the
  whole network's within twice the distance of the port's float32 step
  from the same step in float64. Batch norm in train mode amplifies the
  gradient layer by layer from random weights, and the rounding with it:
  that float32 step lies per cents from float64 here, with random or
  default weights and B=2 or 4, so no tighter bar holds for the whole
  network, while a wrong gradient lies many such distances away.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eegan_tpu.config import Config as JaxConfig
from eegan_tpu.evaluation import fid as jax_fid
from eegan_tpu.evaluation import inception_finetune as jax_finetune
from eegan_tpu.evaluation import inception_score as jax_is
from eegan_tpu.models.inception import InceptionV3 as JaxInceptionV3
from eegan_tpu.utils.torch_convert import convert_image_encoder
from eegan_tpu_torch.config import Config
from eegan_tpu_torch.evaluation import fid, inception_finetune
from eegan_tpu_torch.evaluation import inception_score as port_is
from eegan_tpu_torch.models.factory import randomize_, to_float64_
from eegan_tpu_torch.models.inception import InceptionV3
from eegan_tpu_torch.utils.convert import from_jax_image_encoder

torch.set_num_threads(1)

CLASSES = 11  # 10 classes + the background class


def _sd(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _jax_vars(port, num_classes, train=False):
    jnet = JaxInceptionV3(num_classes=num_classes)
    template = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 299, 299, 3)), train=train))
    return convert_image_encoder(_sd(port), template)


def _images(seed, n=2, size=64):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("seed,n,d", [(0, 500, 8), (1, 64, 32), (2, 40, 3)])
def test_frechet_and_statistics_match_jax(seed, n, d):
    rng = np.random.RandomState(seed)
    a = rng.randn(n, d)
    b = 0.7 * rng.randn(n, d) @ rng.randn(d, d) + rng.randn(d)
    stats = [fid.activation_statistics(x) for x in (a, b)]
    for (mu, sigma), x in zip(stats, (a, b)):
        want_mu, want_sigma = jax_fid.activation_statistics(x)
        np.testing.assert_allclose(mu, want_mu, rtol=1e-10, atol=0)
        np.testing.assert_allclose(sigma, want_sigma, rtol=1e-10, atol=0)
    got = fid.frechet_distance(*stats[0], *stats[1])
    want = jax_fid.frechet_distance(*stats[0], *stats[1])
    assert abs(got - want) <= 1e-10 * abs(want)
    assert abs(fid.frechet_distance(*stats[0], *stats[0])) < 1e-6


@pytest.mark.parametrize("seed,n,k,splits", [(0, 100, 51, 10), (1, 37, 5, 3),
                                             (2, 20, 20, 1)])
def test_inception_score_from_probs_matches_jax(seed, n, k, splits):
    probs = np.random.RandomState(seed).dirichlet(np.full(k, 0.3), size=n)
    got = port_is.inception_score_from_probs(probs, splits)
    want = jax_is.inception_score_from_probs(probs, splits)
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-10 * max(abs(w), 1e-30)


def test_npz_stats_round_trip(tmp_path):
    rng = np.random.RandomState(3)
    mu, sigma = rng.randn(16), rng.randn(16, 16)
    path = str(tmp_path / "stats.npz")
    fid.save_npz_stats(path, mu, sigma)
    for load in (fid.load_npz_stats, jax_fid.load_npz_stats):
        got_mu, got_sigma = load(path)
        np.testing.assert_array_equal(got_mu, mu)
        np.testing.assert_array_equal(got_sigma, sigma)
    measure = fid.MeasureFID(fid.FIDExtractor(device="cpu"))
    np.testing.assert_array_equal(measure.stats_for(path)[1], sigma)


def test_fid_features_match_jax():
    port = randomize_(InceptionV3(num_classes=0), 0)
    variables = _jax_vars(port, 0)
    images = _images(1)
    got = fid.FIDExtractor(port, batch_size=2, device="cpu").features(images)
    want = jax_fid.FIDExtractor(variables, batch_size=2).features(images)
    assert got.shape == want.shape == (2, 2048)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_inception_score_probs_match_jax():
    port = randomize_(InceptionV3(num_classes=CLASSES), 2)
    variables = _jax_vars(port, CLASSES)
    images = _images(3, n=3)
    scorer = port_is.InceptionScorer(port, num_classes=CLASSES, batch_size=2,
                                     device="cpu")
    assert scorer.finetuned
    got = scorer.probs(images)
    want = jax_is.InceptionScorer(variables, num_classes=CLASSES,
                                  batch_size=2).probs(images)
    assert got.shape == want.shape == (3, CLASSES - 1)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_finetune_step_matches_jax():
    cfg, jcfg = Config(), JaxConfig()
    for c in (cfg, jcfg):
        c.TRAIN.CLASS_NUM = CLASSES - 1
        c.RUNTIME.COMPUTE_DTYPE = "float32"
    lr = 1e-4
    model = inception_finetune.build_is_model(cfg, "cpu")
    assert model.fc.out_features == CLASSES
    randomize_(model, 4)
    variables = _jax_vars(model, CLASSES, train=True)
    img_key = f"img{cfg.imsizes[-1]}"
    rng = np.random.RandomState(5)
    batch = {img_key: rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32),
             "class_ids": np.array([3, CLASSES - 1], np.int32)}

    def port_step(module, batch):
        step, init_opt = inception_finetune.make_finetune_step(cfg, module,
                                                               lr)
        opt = init_opt(module)
        metrics = {k: float(v) for k, v in step(opt, batch).items()}
        return metrics, {n: opt.state[p]["exp_avg"].double().numpy() / 0.1
                         for n, p in module.named_parameters()}

    model64 = to_float64_(randomize_(
        inception_finetune.build_is_model(cfg, "cpu"), 4))
    _, grads64 = port_step(model64, {
        k: v.astype(np.float64) if k == img_key else v
        for k, v in batch.items()})
    metrics, grads = port_step(model, batch)

    jstep, _ = jax_finetune.make_finetune_step(
        jcfg, jax_finetune.build_is_model(jcfg), None, lr)
    jopt = optax.adam(lr).init(variables["params"])
    new_vars, jopt, jmetrics = jstep(variables, jopt,
                                     {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                                     jax.random.PRNGKey(0))
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)

    adam = jopt[0]
    assert int(adam.count) == 1
    want = {k: v.numpy().astype(np.float64) / 0.1 for k, v in
            from_jax_image_encoder({"params": adam.mu}).items()}
    assert set(want) == set(grads)

    def rel(names, ref):
        a = np.concatenate([grads[k].ravel() for k in names])
        b = np.concatenate([ref[k].ravel() for k in names])
        assert np.linalg.norm(b) > 0
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert rel(["fc.weight", "fc.bias"], want) <= 1e-3
    assert rel(list(want), want) <= 2 * rel(list(want), grads64)

    stats = from_jax_image_encoder(
        {"batch_stats": new_vars["batch_stats"]})
    sd = model.state_dict()
    moved = 0
    for k, v in stats.items():
        if k.endswith("num_batches_tracked"):
            assert int(sd[k]) == 1, k
            continue
        want_stat = v.numpy()
        np.testing.assert_allclose(
            sd[k].numpy(), want_stat, rtol=1e-4,
            atol=1e-4 * float(np.abs(want_stat).max()), err_msg=k)
        moved += 1
    assert moved == 2 * sum(1 for k in sd if k.endswith("running_mean"))
