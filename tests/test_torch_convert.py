"""The port's weights and the JAX package's trees are one and the same.

A JAX tree goes into the port (``eegan_tpu_torch.utils.convert.from_jax_*``
then ``load_state_dict(strict=True)``), comes back out as the port's
``state_dict()`` and through the JAX package's converters
(``torch_convert.convert_generator`` / ``convert_attr_enhance`` /
``convert_text_encoder`` / ``convert_discriminator`` /
``convert_image_encoder``) to the original tree, exactly. Those converters
read reference EE-GAN / AttnGAN keys, so this proves the port's key names
and layouts are the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegan_tpu.models.attr_enhance import AttrEnhance as JaxAttrEnhance
from eegan_tpu.models.discriminator import Discriminator as JaxDiscriminator
from eegan_tpu.models.generator import Generator as JaxGenerator
from eegan_tpu.models.image_encoder import ImageEncoder as JaxImageEncoder
from eegan_tpu.models.text_encoder import TextEncoder as JaxTextEncoder
from eegan_tpu.utils import torch_convert
from eegan_tpu_torch.models.attr_enhance import AttrEnhance
from eegan_tpu_torch.models.discriminator import Discriminator
from eegan_tpu_torch.models.factory import randomize_
from eegan_tpu_torch.models.generator import Generator
from eegan_tpu_torch.models.image_encoder import ImageEncoder
from eegan_tpu_torch.models.text_encoder import TextEncoder
from eegan_tpu_torch.utils.convert import (
    from_jax_attr_enhance,
    from_jax_discriminator,
    from_jax_generator,
    from_jax_image_encoder,
    from_jax_text_encoder,
    load_state_dict,
)

torch.set_num_threads(1)


def _random_tree(template, seed):
    """Random float32 numpy leaves in the template's shapes."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda leaf: rng.randn(*leaf.shape).astype(np.float32), template)


def _sd(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def _assert_trees_equal(got, want):
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)


def _gen_template(ngf=4):
    z, s = jnp.zeros((2, 100)), jnp.zeros((2, 256))
    return jax.eval_shape(lambda: JaxGenerator(ngf=ngf, up_fused=True).init(
        jax.random.PRNGKey(0), z, s, s, train=True))


@pytest.mark.parametrize("up_fused", [True, False])
def test_generator_round_trip(up_fused):
    tree = _random_tree(_gen_template(), 0)
    port = Generator(ngf=4, up_fused=up_fused, pallas_affine=True)
    port.load_state_dict(from_jax_generator(tree))  # strict
    _assert_trees_equal(torch_convert.convert_generator(_sd(port), tree), tree)


def test_generator_port_to_jax_and_back():
    port = randomize_(Generator(ngf=4), 3)
    tree = torch_convert.convert_generator(_sd(port), _gen_template())
    back = from_jax_generator(tree)
    want = _sd(port)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k].numpy(), want[k], err_msg=k)


def test_attr_enhance_round_trip():
    template = jax.eval_shape(lambda: JaxAttrEnhance(ntf=16).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 16)), jnp.zeros((2, 3, 16))))
    tree = _random_tree(template, 1)
    port = AttrEnhance(ntf=16)
    port.load_state_dict(from_jax_attr_enhance(tree))
    _assert_trees_equal(
        torch_convert.convert_attr_enhance(_sd(port), tree), tree)


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_text_encoder_round_trip(rnn_type):
    template = jax.eval_shape(lambda: JaxTextEncoder(
        ntoken=30, ninput=12, nhidden=16, rnn_type=rnn_type).init(
            jax.random.PRNGKey(0), jnp.ones((2, 5), jnp.int32),
            jnp.ones((2,), jnp.int32)))
    tree = _random_tree(template, 2)
    port = TextEncoder(30, ninput=12, nhidden=16, rnn_type=rnn_type)
    port.load_state_dict(from_jax_text_encoder(tree))
    consumed = set()
    got = torch_convert.convert_text_encoder(_sd(port), tree, consumed)
    _assert_trees_equal(got, tree)
    assert consumed == set(port.state_dict())  # no key left unread


@pytest.mark.parametrize("scale,disc_class", [(64, False), (256, True)])
def test_discriminator_round_trip(scale, disc_class):
    template = jax.eval_shape(lambda: JaxDiscriminator(
        4, scale, disc_class, 7).init(
            jax.random.PRNGKey(0), jnp.zeros((2, scale, scale, 3)),
            jnp.zeros((2, 256))))
    tree = _random_tree(template, 5)
    port = Discriminator(4, scale, disc_class, 7, 256)
    port.load_state_dict(from_jax_discriminator(tree))
    _assert_trees_equal(
        torch_convert.convert_discriminator(_sd(port), tree), tree)


def test_image_encoder_round_trip():
    template = jax.eval_shape(lambda: JaxImageEncoder(nef=16).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    tree = _random_tree(template, 6)
    port = ImageEncoder(nef=16)
    port.load_state_dict(from_jax_image_encoder(tree))
    consumed = set()
    got = torch_convert.convert_image_encoder(_sd(port), tree, consumed)
    _assert_trees_equal(got, tree)
    assert consumed == {k for k in port.state_dict()
                        if not k.endswith("num_batches_tracked")}


def test_load_state_dict_strips_module_prefix(tmp_path):
    port = randomize_(AttrEnhance(ntf=8), 4)
    path = str(tmp_path / "attr_enhance_1.pth")
    torch.save({f"module.{k}": v for k, v in port.state_dict().items()}, path)
    loaded = load_state_dict(path)
    assert sorted(loaded) == sorted(port.state_dict())
    fresh = AttrEnhance(ntf=8)
    fresh.load_state_dict(loaded)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, port.state_dict()[k], rtol=0, atol=0)
