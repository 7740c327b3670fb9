"""Port parity: one float32 train step of ``eegan_tpu_torch`` against
``eegan_tpu.training.steps.make_train_step`` on the CPU (DENSE_D on,
MAGP_CHUNKS=1; ``test_torch_train_step_chunked.py`` runs DENSE_D off with
MAGP_CHUNKS=2, and ``test_torch_train_step_ablate.py`` the ablations).

Both sides start from the same weights: the port's modules get random
weights (``randomize_``), the JAX package's converters turn them into JAX
trees, and ``utils/convert.from_jax_*`` loads those trees back into fresh
port modules. Same synthetic batch, same noise (drawn with the JAX step's
own key). The JAX step takes the XLA words loss and the plain affine path on
the CPU; the port takes the plain versions of its kernels (CPU tensors),
which ``test_torch_damsm.py`` and ``test_torch_affine_grad.py`` hold against
the Pallas kernels.

Tolerances:
* metrics: rtol 1e-4, atol 1e-5 (the MAGP values, ~1e-4, at atol 1e-7);
* generator BN running stats: 1e-5 (forward only);
* parameters after the step: Adam's first update moves an entry by about
  lr * sign(g), so an entry whose gradient is near 0 may land up to 2 * lr
  away: all entries within 2 * lr (+1e-6), and at least 99% of them within
  lr / 100 of the JAX value. The discriminators' second (MAGP) update
  depends on the gradients' size, not only their sign.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegan_tpu.config import Config as JaxConfig
from eegan_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from eegan_tpu.models.factory import build_models as jax_build_models
from eegan_tpu.training import state as jax_state
from eegan_tpu.training.steps import make_train_step as jax_make_train_step
from eegan_tpu.utils import torch_convert
from eegan_tpu_torch.config import Config
from eegan_tpu_torch.data.synthetic import synthetic_batch
from eegan_tpu_torch.models.factory import build_models, randomize_
from eegan_tpu_torch.training.state import create_train_state
from eegan_tpu_torch.training.steps import make_train_step
from eegan_tpu_torch.utils.convert import (
    from_jax_attr_enhance,
    from_jax_discriminator,
    from_jax_generator,
    from_jax_image_encoder,
    from_jax_text_encoder,
)

torch.set_num_threads(1)

B, N_WORDS, WIDTH, CLASS_NUM = 4, 40, 4, 10
# Samples 0 and 2 share a class: the DAMSM losses mask that pair.
CLASS_IDS = np.array([1, 2, 1, 3], np.int32)


def configs(dense_d: bool, magp_chunks: int, runtime=None, **train):
    """The same settings as the port's Config and the JAX package's
    (``runtime``: more RUNTIME keys; ``train``: TRAIN keys)."""
    out = []
    for cfg in (Config(), JaxConfig()):
        cfg.GAN.GF_DIM = cfg.GAN.DF_DIM = WIDTH
        cfg.TRAIN.CLASS_NUM = CLASS_NUM
        cfg.RUNTIME.COMPUTE_DTYPE = "float32"
        cfg.RUNTIME.PALLAS_AFFINE = True
        cfg.RUNTIME.DENSE_D = dense_d
        cfg.RUNTIME.MAGP_CHUNKS = magp_chunks
        for k, v in (runtime or {}).items():
            setattr(cfg.RUNTIME, k, v)
        for k, v in train.items():
            setattr(cfg.TRAIN, k, v)
        out.append(cfg)
    return out


def _sd(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def _template(module, *args, **kw):
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                              **kw))


def shared_start(cfg, jcfg, seed=0):
    """Port models and the JAX (state, frozen) with the same weights."""
    models = build_models(cfg, N_WORDS, device="cpu")
    for i, m in enumerate((models.generator, models.attr_enhance,
                           models.text_encoder, models.image_encoder,
                           *models.discriminators)):
        randomize_(m, seed + i)
    jm = jax_build_models(jcfg, N_WORDS)
    z, s = jnp.zeros((2, jcfg.GAN.Z_DIM)), jnp.zeros((2, 256))
    g_vars = torch_convert.convert_generator(
        _sd(models.generator), _template(jm.generator, z, s, s, train=True))
    attr_vars = torch_convert.convert_attr_enhance(
        _sd(models.attr_enhance),
        _template(jm.attr_enhance, s, jnp.zeros((2, 3, 256))))
    d_vars = [torch_convert.convert_discriminator(
        _sd(d), _template(jd, jnp.zeros((2, sc, sc, 3)), s))
        for d, jd, sc in zip(models.discriminators, jm.discriminators,
                             jm.scales)]
    caps = jnp.zeros((2, jcfg.TEXT.WORDS_NUM), jnp.int32)
    text_vars = torch_convert.convert_text_encoder(
        _sd(models.text_encoder),
        _template(jm.text_encoder, caps, jnp.ones((2,), jnp.int32)))
    image_vars = torch_convert.convert_image_encoder(
        _sd(models.image_encoder),
        _template(jm.image_encoder, jnp.zeros((2, 64, 64, 3))))

    # Fresh port modules, loaded back from the JAX trees.
    models = build_models(cfg, N_WORDS, device="cpu")
    models.generator.load_state_dict(from_jax_generator(g_vars))
    models.attr_enhance.load_state_dict(from_jax_attr_enhance(attr_vars))
    for d, dv in zip(models.discriminators, d_vars):
        d.load_state_dict(from_jax_discriminator(dv))
    models.text_encoder.load_state_dict(from_jax_text_encoder(text_vars))
    models.image_encoder.load_state_dict(from_jax_image_encoder(image_vars))

    g_tx, d_tx = jax_state.make_optimizers(jcfg)
    use_ema = jcfg.TRAIN.G_EMA_DECAY > 0
    jstate = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32),
        g_params=g_vars["params"], attr_params=attr_vars["params"],
        g_stats=g_vars["batch_stats"],
        g_opt=g_tx.init((g_vars["params"], attr_vars["params"])),
        d_params=tuple(dv["params"] for dv in d_vars),
        d_opts=tuple(d_tx.init(dv["params"]) for dv in d_vars),
        g_ema=g_vars["params"] if use_ema else None,
        attr_ema=attr_vars["params"] if use_ema else None)
    jfrozen = jax_state.FrozenEncoders(text_vars=text_vars,
                                       image_vars=image_vars)
    return models, jm, jstate, jfrozen


def run_both(dense_d, magp_chunks, uint8_images=False, ablate=frozenset(),
             runtime=None, **train):
    """One step of each package from the same start; ``uint8_images``
    ships the image leaves as uint8 [0, 255] (RUNTIME.UINT8_TRANSFER)."""
    cfg, jcfg = configs(dense_d, magp_chunks, runtime, **train)
    models, jm, jstate, jfrozen = shared_start(cfg, jcfg)
    batch = synthetic_batch(cfg, B, seed=3, n_words=N_WORDS)
    jbatch = jax_synthetic_batch(jcfg, B, seed=3, n_words=N_WORDS)
    batch["class_ids"] = jbatch["class_ids"] = CLASS_IDS
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k])
        if uint8_images and k.startswith("img"):
            batch[k] = jbatch[k] = np.round(
                (batch[k] + 1.0) * 127.5).astype(np.uint8)
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (B, jcfg.GAN.Z_DIM),
                                         jnp.float32))

    step = jax_make_train_step(jcfg, jm, donate=False, ablate=ablate)
    jnew, jmetrics = step(jstate, jfrozen, jbatch, key)
    state, frozen = create_train_state(cfg, models)
    state, metrics = make_train_step(cfg, models, ablate)(state, frozen,
                                                           batch, noise)
    return dict(cfg=cfg, state=state, metrics=metrics, jstate=jnew,
                jmetrics=jmetrics)


def check_metrics(run):
    got, want = run["metrics"], run["jmetrics"]
    assert set(got) == set(want)
    for k in want:
        atol = 1e-7 if k.endswith("d_loss_gp") else 1e-5
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=atol, err_msg=k)
        assert np.isfinite(float(got[k]))


def _close_after_adam(got_sd, want_sd, lr, what):
    assert set(got_sd) == set(want_sd), what
    n = n_off = 0
    for k, want in want_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        err = np.abs(got_sd[k].numpy() - want.numpy())
        assert err.max() <= 2 * lr + 1e-6, (what, k, float(err.max()))
        n += err.size
        n_off += int((err > lr / 100).sum())
    assert n_off <= 0.01 * n, (what, n_off, n)


def check_generator(run):
    cfg, state, jnew = run["cfg"], run["state"], run["jstate"]
    want = from_jax_generator({"params": jnew.g_params,
                               "batch_stats": jnew.g_stats})
    got = state.generator.state_dict()
    stats = {k for k in want if "running_" in k}
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    _close_after_adam({k: v for k, v in got.items() if k not in stats},
                      {k: v for k, v in want.items() if k not in stats},
                      cfg.TRAIN.GENERATOR_LR, "generator")
    _close_after_adam(state.attr_enhance.state_dict(),
                      from_jax_attr_enhance({"params": jnew.attr_params}),
                      cfg.TRAIN.GENERATOR_LR, "attr_enhance")


def check_discriminators(run):
    cfg, state, jnew = run["cfg"], run["state"], run["jstate"]
    assert len(state.discriminators) == len(jnew.d_params) == 3
    for i, (d, p) in enumerate(zip(state.discriminators, jnew.d_params)):
        _close_after_adam(d.state_dict(),
                          from_jax_discriminator({"params": p}),
                          cfg.TRAIN.DISCRIMINATOR_LR, f"disc_{i}")


@pytest.fixture(scope="module")
def run():
    return run_both(dense_d=True, magp_chunks=1)


def test_metrics_match_jax(run):
    check_metrics(run)


def test_generator_matches_jax(run):
    check_generator(run)


def test_discriminators_match_jax(run):
    check_discriminators(run)


def test_state_moved(run):
    assert run["state"].step == 1
    for opt in (run["state"].g_opt, *run["state"].d_opts):
        assert all(opt.state[p]["step"] >= 1
                   for g in opt.param_groups for p in g["params"])
