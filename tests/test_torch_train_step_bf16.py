"""Port parity in bfloat16: one train step of ``eegan_tpu_torch`` with
``RUNTIME.COMPUTE_DTYPE=bfloat16`` (``BF16_IMAGES`` at the configs' default,
off) against the JAX package's bf16 step, on the CPU.

The JAX package's bf16 step is itself some distance from its float32 step:
bf16 keeps 8 bits of mantissa. That distance, from the same start, is the
yardstick. The port's bf16 step must lie no farther from JAX's bf16 step
than JAX's float32 step does, plus a small absolute floor; if the port cast
to bf16 where JAX does not (or the other way), its rounding would differ
from JAX's by about as much as bf16 differs from float32, and this fails.

Both packages start from the same converted weights, batch and noise, at
the widths of ``test_torch_train_step.py`` (``shared_start``). Compared:
* every metric: |port - JAX bf16| <= |JAX float32 - JAX bf16| + 1e-3
  (1 + |JAX bf16|);
* the Adam first moments of G (with AttrEnhance) and of each D, the
  gradients each Adam took (B1 = 0, so the moment is the last gradient,
  for a D the MAGP step's): over each optimizer, ||port - JAX bf16|| <=
  ||JAX float32 - JAX bf16|| + 1e-3 ||JAX bf16||;
* and per weight tensor (two or more dims), ||port - JAX bf16|| <= 2
  ||JAX float32 - JAX bf16|| + 1e-3 ||JAX bf16||. Over a whole optimizer a
  wrong small tensor hides; alone, a tensor that is pure bf16 noise lands
  anywhere up to about 1.1 times the yardstick (found: 1.095), and a wrong
  one far beyond: PyTorch's own double backward of conv2d put the MAGP
  gradients of the D's stride-1 3x3 convs 12-16 yardsticks away (relative
  error about 1; ``layers.TwiceDifferentiableConv``). The scalar residual
  gates (``gamma``) are left to the first two bars: each is one sum over a
  whole branch, whose bf16 rounding the two frameworks take at other
  points (up to 4.6 yardsticks apart, 6% of the gate's gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eegan_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from eegan_tpu.models.factory import build_models as jax_build_models
from eegan_tpu.training.steps import make_train_step as jax_make_train_step
from eegan_tpu_torch.data.synthetic import synthetic_batch
from eegan_tpu_torch.training.state import create_train_state
from eegan_tpu_torch.training.steps import make_train_step
from eegan_tpu_torch.utils.convert import (
    from_jax_attr_enhance,
    from_jax_discriminator,
    from_jax_generator,
)

from test_torch_train_step import B, CLASS_IDS, N_WORDS, configs, shared_start

torch.set_num_threads(1)

METRIC_FLOOR = 1e-3
MOMENT_FLOOR = 1e-3


def _adam(opt_state):
    """The one ``ScaleByAdamState`` in an optax state."""
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam)
             if is_adam(s)]
    assert len(found) == 1
    return found[0]


def _jax_moments(jstate):
    """Per optimizer ("g", "d0".."d2"): port parameter name -> JAX's first
    moment, float64."""
    g_mu, attr_mu = _adam(jstate.g_opt).mu
    out = {"g": {**{f"generator.{k}": v for k, v in
                    from_jax_generator({"params": g_mu}).items()},
                 **{f"attr_enhance.{k}": v for k, v in
                    from_jax_attr_enhance({"params": attr_mu}).items()}}}
    for i, d_opt in enumerate(jstate.d_opts):
        out[f"d{i}"] = from_jax_discriminator({"params": _adam(d_opt).mu})
    return {name: {k: v.numpy().astype(np.float64) for k, v in m.items()}
            for name, m in out.items()}


def _port_moments(state):
    mods = {"g": (("generator.", state.generator),
                  ("attr_enhance.", state.attr_enhance))}
    for i, d in enumerate(state.discriminators):
        mods[f"d{i}"] = (("", d),)
    out = {}
    for name, parts in mods.items():
        opt = state.g_opt if name == "g" else state.d_opts[int(name[1:])]
        out[name] = {prefix + k: opt.state[p]["exp_avg"].numpy().astype(
                         np.float64)
                     for prefix, module in parts
                     for k, p in module.named_parameters()}
    return out


@pytest.fixture(scope="module")
def steps():
    """One bf16 step of the port, one bf16 and one float32 step of JAX,
    from the same start."""
    cfg, jcfg = configs(dense_d=True, magp_chunks=1)
    cfg.RUNTIME.COMPUTE_DTYPE = jcfg.RUNTIME.COMPUTE_DTYPE = "bfloat16"
    _, jcfg32 = configs(dense_d=True, magp_chunks=1)
    models, jm, jstate, jfrozen = shared_start(cfg, jcfg)
    jm32 = jax_build_models(jcfg32, N_WORDS)
    batch = synthetic_batch(cfg, B, seed=3, n_words=N_WORDS)
    jbatch = jax_synthetic_batch(jcfg, B, seed=3, n_words=N_WORDS)
    batch["class_ids"] = jbatch["class_ids"] = CLASS_IDS
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (B, jcfg.GAN.Z_DIM),
                                         jnp.float32))
    out = {}
    for name, c, m in (("jax_bf16", jcfg, jm), ("jax_f32", jcfg32, jm32)):
        new, metrics = jax_make_train_step(c, m, donate=False)(
            jstate, jfrozen, jbatch, key)
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     _jax_moments(new))
    state, frozen = create_train_state(cfg, models)
    state, metrics = make_train_step(cfg, models)(state, frozen, batch,
                                                   noise)
    out["port_bf16"] = ({k: float(v) for k, v in metrics.items()},
                        _port_moments(state))
    return out


def test_bf16_metrics_match_jax_bf16(steps):
    port, jax16, jax32 = (steps[k][0] for k in
                          ("port_bf16", "jax_bf16", "jax_f32"))
    assert set(port) == set(jax16) == set(jax32)
    for k, want in jax16.items():
        assert np.isfinite(port[k]), k
        gap, bf16_gap = abs(port[k] - want), abs(jax32[k] - want)
        assert gap <= bf16_gap + METRIC_FLOOR * (1 + abs(want)), (
            k, port[k], want, jax32[k])


@pytest.mark.parametrize("opt", ["g", "d0", "d1", "d2"])
def test_bf16_adam_moments_match_jax_bf16(steps, opt):
    port, jax16, jax32 = (steps[k][1][opt] for k in
                          ("port_bf16", "jax_bf16", "jax_f32"))
    assert set(port) == set(jax16) == set(jax32), opt
    keys = sorted(jax16)
    flat = {name: np.concatenate([m[k].ravel() for k in keys])
            for name, m in (("port", port), ("jax16", jax16),
                            ("jax32", jax32))}
    ref = np.linalg.norm(flat["jax16"])
    assert ref > 0, opt
    gap = np.linalg.norm(flat["port"] - flat["jax16"])
    bf16_gap = np.linalg.norm(flat["jax32"] - flat["jax16"])
    assert gap <= bf16_gap + MOMENT_FLOOR * ref, (opt, gap / ref,
                                                  bf16_gap / ref)


@pytest.mark.parametrize("opt", ["g", "d0", "d1", "d2"])
def test_bf16_adam_moments_per_weight_match_jax_bf16(steps, opt):
    port, jax16, jax32 = (steps[k][1][opt] for k in
                          ("port_bf16", "jax_bf16", "jax_f32"))
    weights = [k for k, v in jax16.items() if v.ndim >= 2]
    assert weights, opt
    for k in weights:
        ref = np.linalg.norm(jax16[k])
        gap = np.linalg.norm(port[k] - jax16[k])
        bf16_gap = np.linalg.norm(jax32[k] - jax16[k])
        assert gap <= 2 * bf16_gap + MOMENT_FLOOR * ref, (
            opt, k, gap / ref, bf16_gap / ref)
