"""Port parity: ``eegan_tpu_torch.models.inception`` and ``image_encoder``
against the JAX package's Inception-v3 trunk and DAMSM image encoder
(float32, eval-mode batch norm, full Inception widths, B=1-2).

The port's modules get random weights and BN running stats
(``randomize_``) and reach the JAX trees through the JAX package's own
converter (``torch_convert.convert_image_encoder``), which also shows that
the port's keys are torchvision's / AttnGAN's. The JAX side runs jitted.
Tolerances, relative to each output's largest magnitude: the taps and the
encoder's outputs at 1e-4; the image gradient (the G phase trains the
generator through the frozen encoder) at a relative L2 error of 5e-3 and
every element within 1e-2 (see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegan_tpu.models.image_encoder import ImageEncoder as JaxImageEncoder
from eegan_tpu.models.inception import InceptionV3 as JaxInceptionV3
from eegan_tpu.utils.torch_convert import convert_image_encoder
from eegan_tpu_torch.config import Config
from eegan_tpu_torch.models.factory import build_models, randomize_
from eegan_tpu_torch.models.image_encoder import ImageEncoder
from eegan_tpu_torch.models.inception import InceptionV3
from eegan_tpu_torch.training.state import create_train_state

torch.set_num_threads(1)


def _sd(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _assert_close(got, want, rel=1e-4, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale,
                               err_msg=what)


def test_inception_taps_match_jax():
    port = randomize_(InceptionV3(num_classes=10), 0).eval()
    port = port.to(memory_format=torch.channels_last)
    x = np.random.RandomState(1).uniform(-1, 1, (1, 299, 299, 3)).astype(
        np.float32)
    jnet = JaxInceptionV3(num_classes=10)
    template = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), x))
    variables = convert_image_encoder(_sd(port), template)
    want = jax.jit(lambda v, a: jnet.apply(v, a, False))(variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(want) == ["logits", "mixed_6e", "pool3"]
    assert tuple(got["mixed_6e"].shape) == (1, 768, 17, 17)
    assert tuple(got["pool3"].shape) == (1, 2048)
    _assert_close(got["mixed_6e"].permute(0, 2, 3, 1).numpy(),
                  want["mixed_6e"], what="mixed_6e")
    for k in ("pool3", "logits"):
        assert got[k].dtype == torch.float32
        _assert_close(got[k].numpy(), want[k], what=k)


@pytest.fixture(scope="module")
def encoders():
    port = randomize_(ImageEncoder(nef=32), 2).eval()
    port = port.to(memory_format=torch.channels_last)
    jenc = JaxImageEncoder(nef=32)
    template = jax.eval_shape(lambda: jenc.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    return port, jenc, convert_image_encoder(_sd(port), template)


def test_image_encoder_matches_jax(encoders):
    """Outputs and the gradient that reaches the image."""
    port, jenc, variables = encoders
    rng = np.random.RandomState(3)
    img = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    w_region = rng.randn(2, 17, 17, 32).astype(np.float32)
    w_code = rng.randn(2, 32).astype(np.float32)

    def loss(v, x):
        region, code = jenc.apply(v, x, train=False)
        return jnp.sum(region * w_region) + jnp.sum(code * w_code), (region,
                                                                     code)

    (_, (want_region, want_code)), want_grad = jax.jit(jax.value_and_grad(
        loss, argnums=1, has_aux=True))(variables, img)

    x = torch.from_numpy(img).requires_grad_(True)
    region, code = port(x)
    assert tuple(region.shape) == (2, 17, 17, 32)
    assert tuple(code.shape) == (2, 32)
    assert region.dtype == code.dtype == torch.float32
    (torch.sum(region * torch.from_numpy(w_region))
     + torch.sum(code * torch.from_numpy(w_code))).backward()
    _assert_close(region.detach().numpy(), want_region, what="region")
    _assert_close(code.detach().numpy(), want_code, what="code")
    # The gradient crosses ~50 conv/BN/ReLU layers with random weights and
    # is sensitive to rounding: here the JAX package's own float32 gradient
    # lies 9e-4 (relative L2) from its float64 one, and a pre-activation
    # within an fp32 rounding of 0 may take the other side of a ReLU gate.
    # So: relative L2 error 5e-3, and every element within 1e-2 of the
    # largest.
    got, want = x.grad.numpy(), np.asarray(want_grad)
    assert np.linalg.norm(got - want) <= 5e-3 * np.linalg.norm(want)
    _assert_close(got, want, rel=1e-2, what="d image")


def test_frozen_encoder_passes_gradients_only_to_the_image():
    config = Config()
    config.GAN.GF_DIM = config.GAN.DF_DIM = 4
    models = build_models(config, 20, device="cpu")
    _, frozen = create_train_state(config, models)
    enc = frozen.image_encoder
    assert enc is models.image_encoder and not enc.training
    assert not any(p.requires_grad for p in enc.parameters())
    x = torch.from_numpy(np.random.RandomState(4).uniform(
        -1, 1, (1, 64, 64, 3)).astype(np.float32)).requires_grad_(True)
    region, code = enc(x)
    (region.sum() + code.sum()).backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    assert float(x.grad.abs().sum()) > 0
    assert all(p.grad is None for p in enc.parameters())
