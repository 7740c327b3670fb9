"""Port parity: ``eegan_tpu_torch.models.discriminator`` and
``losses/gan.py`` against the JAX package (float32, ndf=4, B=2).

The port's towers get random weights (``randomize_``, so the zero-init
residual gates matter too) and reach the JAX tree through the JAX package's
own converter (``torch_convert.convert_discriminator``), which also shows
that the port's keys are the reference's. Tolerances: features, logits and
losses at 1e-5; the MAGP penalty and its input gradients (a double
backward) at rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegan_tpu.losses import gan as jgan
from eegan_tpu.models.discriminator import Discriminator as JaxDiscriminator
from eegan_tpu.utils.torch_convert import convert_discriminator
from eegan_tpu_torch.losses import gan
from eegan_tpu_torch.models.discriminator import Discriminator, channel_ladder
from eegan_tpu_torch.models.factory import randomize_

torch.set_num_threads(1)

B, NDF, NEF, CLASSES = 2, 4, 256, 7
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(scale, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.uniform(-1, 1, (B, scale, scale, 3)).astype(np.float32)
    sent = rng.randn(B, NEF).astype(np.float32)
    return img, sent


def _pair(scale, disc_class, seed=0):
    """The port's tower and the JAX tower's variables, same weights."""
    port = randomize_(Discriminator(NDF, scale, disc_class, CLASSES, NEF),
                      seed)
    port = port.to(memory_format=torch.channels_last)
    jdisc = JaxDiscriminator(NDF, scale, disc_class, CLASSES)
    img, sent = _inputs(scale)
    template = jax.eval_shape(lambda: jdisc.init(jax.random.PRNGKey(0),
                                                 img, sent))
    sd = {k: v.detach().numpy().copy() for k, v in port.state_dict().items()}
    return port, jdisc, convert_discriminator(sd, template)


@pytest.mark.parametrize("scale,disc_class", [(64, False), (128, False),
                                              (256, False), (256, True)])
def test_discriminator_matches_jax(scale, disc_class):
    port, jdisc, variables = _pair(scale, disc_class)
    img, sent = _inputs(scale, seed=1)
    want_feat = jdisc.apply(variables, img, method="features")
    want = jdisc.apply(variables, want_feat, sent, method="head")
    feat = port.features(torch.from_numpy(img))
    got = port.head(feat, torch.from_numpy(sent))
    assert tuple(feat.shape) == (B, channel_ladder(NDF, scale)[-1], 4, 4)
    np.testing.assert_allclose(feat.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_feat), **TOL)
    if disc_class:
        assert tuple(got[0].shape) == (B,) and tuple(got[1].shape) == (
            B, CLASSES)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       **TOL)
    else:
        assert tuple(got.shape) == (B,)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)


@pytest.mark.parametrize("disc_class", [False, True])
def test_magp_matches_jax(disc_class):
    """The MA gradient penalty: input gradients of sum(D(img, sent)) with
    create_graph, then the penalty's gradient into D's parameters."""
    scale = 64 if not disc_class else 256
    port, jdisc, variables = _pair(scale, disc_class, seed=2)
    img, sent = _inputs(scale, seed=3)

    def jax_gp(params):
        def pair_sum(x, s):
            out = jdisc.apply({"params": params}, x, s)
            return (out[0] if disc_class else out).sum()

        gi, gs = jax.grad(pair_sum, argnums=(0, 1))(img, sent)
        return jgan.magp_from_grads(gi, gs)

    want, want_grads = jax.value_and_grad(jax_gp)(variables["params"])

    x = torch.from_numpy(img).requires_grad_(True)
    s = torch.from_numpy(sent).requires_grad_(True)
    out = port(x, s)
    out = out[0] if disc_class else out
    gi, gs = torch.autograd.grad(out.sum(), (x, s), create_graph=True)
    got = gan.magp_from_grads(gi, gs)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4,
                               atol=1e-9)
    gamma = dict(port.named_parameters())["block0.gamma"].grad
    np.testing.assert_allclose(
        gamma.numpy(), np.asarray(want_grads["block0"]["gamma"]), rtol=1e-4,
        atol=1e-9 + 1e-4 * float(np.abs(want_grads["block0"]["gamma"]).max()))


def test_gan_losses_match_jax():
    rng = np.random.RandomState(4)
    out = rng.randn(8).astype(np.float32) * 2
    logits = rng.randn(8, 5).astype(np.float32) * 3
    ids = np.array([1, 5, 3, 0, 6, 2, 2, 4], np.int32)  # 0, 6: outside 1..5
    labels = gan.one_hot_class_labels(torch.from_numpy(ids), 5)
    jlabels = jgan.one_hot_class_labels(jnp.asarray(ids), 5)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    t_out, t_logits = torch.from_numpy(out), torch.from_numpy(logits)
    pairs = [
        (gan.hinge_real(t_out), jgan.hinge_real(out)),
        (gan.hinge_fake(t_out), jgan.hinge_fake(out)),
        (gan.bce_with_logits(t_logits, labels),
         jgan.bce_with_logits(logits, jlabels)),
        (gan.d_hinge_total(*map(torch.tensor, (0.5, 1.5, 2.0))),
         jgan.d_hinge_total(0.5, 1.5, 2.0)),
        (gan.magp_from_grads(t_logits, t_out[:, None]),
         jgan.magp_from_grads(logits, out[:, None])),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), **TOL)


def test_bf16_tower_computes_in_bf16():
    port = randomize_(Discriminator(NDF, 64, compute_dtype=torch.bfloat16), 5)
    img, sent = _inputs(64)
    feat = port.features(torch.from_numpy(img))
    assert feat.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert bool(torch.isfinite(port.head(feat, torch.from_numpy(sent))).all())
