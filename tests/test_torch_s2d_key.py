"""RUNTIME.S2D_CONVS in the port: the key is ignored, and this holds the
port to the JAX package's claim that the space-to-depth form keeps the
"identical math + param tree" (``eegan_tpu/models/discriminator.py:43``).

With the key on, the JAX factory builds the generator's and the
discriminators' narrow 3x3 convs as ``ops/s2d_conv.py``'s ``Conv3x3S2D``
(a 4x4 stride-2 conv on a packed kernel, ``models/layers.py:54-56``); the
port's factory builds its plain convs. Each pair starts from the same
weights (the port's random weights through the JAX package's converter,
which needs the S2D trees to have the port's keys) and gives the same
outputs within the sampling bar, 1e-4: the generator's three images in
eval mode, each discriminator's features and logits. The port's state-dict
keys do not change with the key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegan_tpu.config import Config as JaxConfig
from eegan_tpu.models.factory import build_models as jax_build_models
from eegan_tpu.utils.torch_convert import (
    convert_discriminator,
    convert_generator,
)
from eegan_tpu_torch.config import Config
from eegan_tpu_torch.models.factory import build_models, randomize_

torch.set_num_threads(1)

B, WIDTH, CLASS_NUM, N_WORDS = 2, 4, 7, 40
TOL = dict(rtol=1e-4, atol=1e-4)
# The padding of the packed stride-2 conv (ops/s2d_conv.py); no other conv
# of either network pads so.
S2D_PADDING = "padding=((1, 2), (1, 2))"


def _configs(s2d: bool):
    out = []
    for cfg in (Config(), JaxConfig()):
        cfg.GAN.GF_DIM = cfg.GAN.DF_DIM = WIDTH
        cfg.TRAIN.CLASS_NUM = CLASS_NUM
        cfg.RUNTIME.COMPUTE_DTYPE = "float32"
        cfg.RUNTIME.S2D_CONVS = s2d
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def bundles():
    cfg, jcfg = _configs(True)
    models = build_models(cfg, N_WORDS, device="cpu")
    randomize_(models.generator, 0)
    for i, d in enumerate(models.discriminators):
        randomize_(d, 1 + i)
    return models, jax_build_models(jcfg, N_WORDS)


def _sd(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def test_port_keys_do_not_change_with_the_key():
    keys = []
    for s2d in (False, True):
        models = build_models(_configs(s2d)[0], N_WORDS, device="cpu")
        keys.append({name: {k: tuple(v.shape)
                            for k, v in m.state_dict().items()}
                     for name, m in (("generator", models.generator),
                                     ("attr_enhance", models.attr_enhance),
                                     *((f"disc_{i}", d) for i, d in
                                       enumerate(models.discriminators)))})
    assert keys[0] == keys[1]


def test_generator_matches_jax_s2d(bundles):
    models, jm = bundles
    assert jm.generator.s2d
    rng = np.random.RandomState(0)
    z = rng.randn(B, 100).astype(np.float32)
    s = rng.randn(B, 256).astype(np.float32)
    a = rng.randn(B, 256).astype(np.float32)
    template = jax.eval_shape(lambda: jm.generator.init(
        jax.random.PRNGKey(0), z, s, a, train=True))
    variables = convert_generator(_sd(models.generator), template)

    def apply(v):
        return jm.generator.apply(v, z, s, a, train=False)

    assert S2D_PADDING in str(jax.make_jaxpr(apply)(variables))
    want = jax.jit(apply)(variables)
    port = models.generator.eval()
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (z, s, a)))
    for scale, g, w in zip((64, 128, 256), got, want):
        assert tuple(g.shape) == (B, scale, scale, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"img{scale}")


@pytest.mark.parametrize("index", [0, 1, 2])
def test_discriminator_matches_jax_s2d(bundles, index):
    models, jm = bundles
    port, jdisc = models.discriminators[index], jm.discriminators[index]
    scale = jm.scales[index]
    assert jdisc.s2d
    rng = np.random.RandomState(1 + index)
    img = rng.uniform(-1, 1, (B, scale, scale, 3)).astype(np.float32)
    sent = rng.randn(B, 256).astype(np.float32)
    template = jax.eval_shape(lambda: jdisc.init(jax.random.PRNGKey(0),
                                                 img, sent))
    variables = convert_discriminator(_sd(port), template)

    def apply(v):
        feat = jdisc.apply(v, img, method="features")
        return feat, jdisc.apply(v, feat, sent, method="head")

    assert S2D_PADDING in str(jax.make_jaxpr(apply)(variables))
    want_feat, want = jax.jit(apply)(variables)
    with torch.no_grad():
        feat = port.features(torch.from_numpy(img))
        got = port.head(feat, torch.from_numpy(sent))
    np.testing.assert_allclose(feat.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_feat), **TOL)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == (2 if index == 2 else 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(jnp.asarray(w)),
                                   **TOL)
