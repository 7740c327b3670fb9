"""Port parity of the fused affine op's gradients: ``ops/affine`` on CPU
tensors (its plain version, whose autograd is the plain backward of
kernel 2) against the JAX Pallas kernel's custom VJP in interpret mode
(``affine_mask_relu(..., interpret=True)``), and the generator trained
through it (``pallas_affine=True``, train mode) against the JAX generator.

The CUDA kernel pair (``AffineMaskReLU``: kernel 1 forward, kernel 2
backward) is held against the same plain version on the card by
``chip_smoke.py``. Tolerances: all six gradients at 1e-5 in float32 (the bar
of ``tests/test_affine_pallas.py``), 2e-2 with bfloat16 inputs; the
generator's images and updated BN running stats at 1e-4 and its parameter
gradients at a relative L2 error of 5e-3 overall and 2e-2 per parameter
(see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegan_tpu.models.generator import Generator as JaxGenerator
from eegan_tpu.ops.affine_pallas import affine_mask_relu as jax_affine
from eegan_tpu.utils.torch_convert import convert_generator
from eegan_tpu_torch.models.factory import randomize_
from eegan_tpu_torch.models.generator import Generator
from eegan_tpu_torch.ops.affine import (
    affine_mask_relu,
    affine_mask_relu_backward,
)

torch.set_num_threads(1)
NAMES = ("x", "mean", "var", "gamma", "beta", "mask")


def _operands(up, B=2, h=4, w=8, C=16, seed=3):
    """The shapes and draws of ``test_affine_pallas.py``, NHWC numpy."""
    rng = np.random.RandomState(seed)
    H, W = (2 * h, 2 * w) if up else (h, w)
    x = rng.randn(B, h, w, C).astype(np.float32)
    mean = rng.randn(C).astype(np.float32) * 0.1
    var = (rng.rand(C).astype(np.float32) + 0.5)
    gamma = rng.randn(B, C).astype(np.float32) * 0.3
    beta = rng.randn(B, C).astype(np.float32) * 0.3
    mask = rng.rand(B, H, W, 1).astype(np.float32)
    cot = np.random.RandomState(9).randn(B, H, W, C).astype(np.float32)
    return (x, mean, var, gamma, beta, mask), cot


def _port_leaves(ops, dtype):
    x, mean, var, gamma, beta, mask = (torch.from_numpy(a) for a in ops)
    leaves = (x.permute(0, 3, 1, 2).to(dtype), mean, var, gamma.to(dtype),
              beta.to(dtype), mask.permute(0, 3, 1, 2).to(dtype))
    return [t.detach().requires_grad_(True) for t in leaves]


def _nhwc_grad(name, g):
    g = g.float()
    return (g.permute(0, 2, 3, 1) if name in ("x", "mask") else g).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("up", [False, True])
def test_grads_match_jax_kernel_vjp(up, dtype):
    ops, cot = _operands(up)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jops = [jnp.asarray(a, jdt) if i in (0, 3, 4, 5) else jnp.asarray(a)
            for i, a in enumerate(ops)]

    def f_kernel(*a):
        out = jax_affine(*a, up, 1e-5, jnp.float32, True)
        return jnp.sum(out * cot)

    want = jax.grad(f_kernel, argnums=tuple(range(6)))(*jops)
    leaves = _port_leaves(ops, tdt)
    out = affine_mask_relu(*leaves, up, 1e-5, torch.float32)
    got = torch.autograd.grad(
        out, leaves, torch.from_numpy(cot).permute(0, 3, 1, 2))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, g, w, leaf in zip(NAMES, got, want, leaves):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, name
        np.testing.assert_allclose(
            _nhwc_grad(name, g), np.asarray(w, np.float32), rtol=tol,
            atol=tol, err_msg=f"d{name} (up={up}, {dtype})")


def test_backward_kernel_refuses_cpu_tensors():
    ops, cot = _operands(False)
    leaves = [t.detach() for t in _port_leaves(ops, torch.float32)]
    dy = torch.from_numpy(cot).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        affine_mask_relu_backward(*leaves, dy)


@pytest.fixture(scope="module", params=[True, False], ids=["fused", "unfused"])
def generator_pair(request):
    """The port's and the JAX generator (ngf=4, B=2, pallas_affine, train
    mode) from the same weights: images, updated stats, parameter grads of
    sum(img * cotangent)."""
    up_fused = request.param
    rng = np.random.RandomState(0)
    z, s, a = (rng.randn(2, n).astype(np.float32) for n in (100, 256, 256))
    cots = [rng.randn(2, r, r, 3).astype(np.float32) for r in (64, 128, 256)]
    port = randomize_(Generator(ngf=4, up_fused=up_fused,
                                pallas_affine=True), 1)
    port = port.to(memory_format=torch.channels_last).train()
    jgen = JaxGenerator(ngf=4, up_fused=up_fused, pallas_affine=True)
    template = jax.eval_shape(
        lambda: jgen.init(jax.random.PRNGKey(0), z, s, a, train=True))
    sd = {k: v.detach().numpy().copy() for k, v in port.state_dict().items()}
    variables = convert_generator(sd, template)

    def loss(params):
        imgs, upd = jgen.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               z, s, a, train=True, mutable=["batch_stats"])
        return sum(jnp.sum(i * c) for i, c in zip(imgs, cots)), (imgs, upd)

    (_, (want_imgs, want_upd)), want_grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])

    imgs = port(*map(torch.from_numpy, (z, s, a)))
    sum(torch.sum(i * torch.from_numpy(c)) for i, c in zip(imgs, cots)
        ).backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             .numpy() for k, p in port.named_parameters()}
    buffers = {k: v.numpy() for k, v in port.state_dict().items()}
    got_tree = convert_generator({**buffers, **grads}, template)
    return dict(imgs=[i.detach().numpy() for i in imgs], want_imgs=want_imgs,
                stats=got_tree["batch_stats"],
                want_stats=want_upd["batch_stats"],
                grads=got_tree["params"], want_grads=want_grads)


def test_generator_images_and_stats_match_jax(generator_pair):
    r = generator_pair
    for scale, g, w in zip((64, 128, 256), r["imgs"], r["want_imgs"]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=f"img{scale}")
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=1e-4, atol=1e-4),
        r["stats"], r["want_stats"])


def test_generator_param_grads_match_jax(generator_pair):
    """The gradients cross about 3M ReLU gates at random weights, and a gate
    whose pre-activation lies within an fp32 rounding of 0 may take either
    side: with these seeds, block5.affine2 (128x128) has one at |z| =
    1.2e-7, and that one gate moves the whole gradient by 1.8e-3 (relative
    L2), and the scalar block5.gamma by 1.2e-2. The port and the JAX
    package, each in float32, land on either side of it depending on the
    summation order; where the port lands on the side of the JAX
    package's float64 gradient, the two agree within 3e-6. So: a relative
    L2 error of 5e-3 over all gradients, and of 2e-2 in each parameter."""
    r = generator_pair
    flat_want = jax.tree_util.tree_flatten_with_path(r["want_grads"])[0]
    flat_got = jax.tree_util.tree_leaves(r["grads"])
    assert len(flat_want) == len(flat_got)
    err2 = norm2 = 0.0
    for (path, w), g in zip(flat_want, flat_got):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        e = np.linalg.norm(g - w)
        assert e <= 2e-2 * np.linalg.norm(w) + 1e-8, \
            (jax.tree_util.keystr(path), e, np.linalg.norm(w))
        err2 += e ** 2
        norm2 += np.linalg.norm(w) ** 2
    assert np.sqrt(err2) <= 5e-3 * np.sqrt(norm2)
