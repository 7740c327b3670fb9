"""Port parity: ``eegan_tpu_torch.models.layers`` and ``ops.upconv`` against
their JAX counterparts (float32, tolerance 1e-5).

Inputs come from numpy with a seed; JAX arrays are NHWC, the port's tensors
NCHW in channels_last memory format (the same bytes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eegan_tpu.models import layers as jl
from eegan_tpu.ops.upconv import pack_kernel_upconv as jax_pack
from eegan_tpu.ops.upconv import upconv3x3_apply
from eegan_tpu_torch.models import layers as tl
from eegan_tpu_torch.models.factory import randomize_
from eegan_tpu_torch.ops.upconv import Conv3x3UpFused, pack_kernel_upconv

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("train,n_override", [(True, None), (True, 4 * 2 * 5 * 6),
                                              (False, None)])
def test_batchnorm_matches_jax(train, n_override):
    x = _randn(2, 5, 6, 8) * 3 + 1
    bn = randomize_(tl.TorchBatchNorm(8), 1).train(train)
    scale, bias = bn.weight.detach().numpy(), bn.bias.detach().numpy()
    stats = {"mean": bn.running_mean.numpy().copy(),
             "var": bn.running_var.numpy().copy()}
    jbn = jl.batch_norm(train, n_override=n_override)
    want, upd = jbn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": stats}, x, mutable=["batch_stats"])
    got = bn(_nchw(x), n_override=n_override)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), **TOL)
    assert int(bn.num_batches_tracked) == int(train)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_return_stats_matches_jax(train):
    x = _randn(2, 4, 4, 6, seed=3) + 0.5
    bn = randomize_(tl.TorchBatchNorm(6, affine=False), 2).train(train)
    stats = {"mean": bn.running_mean.numpy().copy(),
             "var": bn.running_var.numpy().copy()}
    (mean, var), _ = jl.batch_norm(train, affine=False, return_stats=True).apply(
        {"batch_stats": stats}, x, mutable=["batch_stats"])
    got_mean, got_var = bn(_nchw(x), return_stats=True)
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(mean), **TOL)
    np.testing.assert_allclose(got_var.numpy(), np.asarray(var), **TOL)


@pytest.mark.parametrize("src,dst", [((4, 4), (8, 8)), ((4, 4), (32, 32)),
                                     ((3, 5), (7, 9)), ((6, 6), (6, 6))])
def test_resize_bilinear_align_corners_matches_jax(src, dst):
    x = _randn(2, *src, 1, seed=4)
    want = jl.resize_bilinear_align_corners(jnp.asarray(x), dst)
    got = tl.resize_bilinear_align_corners(_nchw(x), dst)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("src,dst", [((256, 256), (299, 299)),
                                     ((5, 7), (11, 9)), ((12, 9), (5, 4)),
                                     ((6, 6), (6, 6))])
def test_resize_bilinear_half_pixel_matches_jax(src, dst):
    """Up (the image encoder's 256 -> 299), down (antialiased, as
    jax.image.resize) and the identity."""
    x = _randn(1, *src, 3, seed=11)
    want = jl.resize_bilinear_half_pixel(jnp.asarray(x), dst)
    got = tl.resize_bilinear_half_pixel(_nchw(x), dst)
    assert tuple(got.shape) == (1, 3, *dst)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_resize_bilinear_half_pixel_is_not_interpolate_when_shrinking():
    """Shrinking, jax.image.resize antialiases and F.interpolate does not:
    the port follows JAX."""
    x = _randn(1, 12, 12, 1, seed=12)
    plain = torch.nn.functional.interpolate(_nchw(x), size=(5, 5),
                                            mode="bilinear",
                                            align_corners=False)
    got = tl.resize_bilinear_half_pixel(_nchw(x), (5, 5))
    assert float((got - plain).abs().max()) > 1e-2


@pytest.mark.parametrize("kind", ["conv4x4_down", "conv1x1_bias"])
def test_discriminator_convs_match_jax(kind):
    x = _randn(2, 8, 6, 5, seed=13)
    if kind == "conv4x4_down":
        port, jmod = tl.conv4x4_down(5, 7), jl.conv4x4_down(7)
    else:
        port, jmod = tl.conv1x1(5, 7, bias=True), jl.conv1x1(7, use_bias=True)
    randomize_(port, 14)
    params = {"kernel": port.weight.detach().numpy().transpose(2, 3, 1, 0)}
    if port.bias is not None:
        params["bias"] = port.bias.detach().numpy()
    want = jmod.apply({"params": params}, x)
    got = port(_nchw(x).contiguous(memory_format=torch.channels_last))
    assert _nhwc(got).shape == want.shape
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_leaky_relu_and_avg_pool_match_jax():
    x = _randn(2, 6, 4, 3, seed=15)
    np.testing.assert_allclose(_nhwc(tl.leaky_relu(_nchw(x), 0.2)),
                               np.asarray(jl.leaky_relu(jnp.asarray(x), 0.2)),
                               **TOL)
    np.testing.assert_allclose(_nhwc(tl.avg_pool_2x(_nchw(x))),
                               np.asarray(jl.avg_pool_2x(jnp.asarray(x))),
                               **TOL)


def test_upsample_nearest_matches_jax():
    x = _randn(2, 3, 5, 4, seed=5)
    np.testing.assert_array_equal(
        _nhwc(tl.upsample_nearest_2x(_nchw(x))),
        np.asarray(jl.upsample_nearest_2x(jnp.asarray(x))))


UPCONV_SHAPES = [
    (2, 4, 4, 8, 8),
    (2, 16, 16, 64, 32),
    (1, 6, 10, 16, 8),
    (2, 8, 8, 16, 3),
]


@pytest.mark.parametrize("b,h,w,cin,cout", UPCONV_SHAPES)
def test_upconv_fused_matches_jax(b, h, w, cin, cout):
    """Pins the packing order: the port packs for F.pixel_shuffle
    (k*4 + dh*2 + dw), the JAX package for its own depth-to-space
    ((dh*2+dw)*Cout + k)."""
    x = _randn(b, h, w, cin, seed=6)
    kernel = _randn(3, 3, cin, cout, seed=7) * 0.1
    want = upconv3x3_apply(jnp.asarray(x), jnp.asarray(kernel))
    conv = Conv3x3UpFused(cin, cout)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        got = conv(_nchw(x).contiguous(memory_format=torch.channels_last))
    assert tuple(got.shape) == (b, cout, 2 * h, 2 * w)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_pack_kernel_is_a_permutation_of_jax_packing():
    kernel = _randn(3, 3, 4, 6, seed=8)
    want = np.asarray(jax_pack(jnp.asarray(kernel)))  # (3,3,Cin,(dh*2+dw)*Cout+k)
    got = pack_kernel_upconv(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    got = got.numpy().reshape(6, 4, 4, 3, 3)  # (k, parity, Cin, u, v)
    want = want.reshape(3, 3, 4, 4, 6).transpose(4, 3, 2, 0, 1)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("head", ["mask", "image"])
def test_heads_match_jax(head, train):
    x = _randn(2, 8, 8, 6, seed=9)
    if head == "mask":
        port, jmod, jkeys = tl.MaskHead(6), jl.MaskHead(), ("conv1", "bn", "conv2")
        tkeys = ("0", "1", "3")
    else:
        port, jmod, jkeys = tl.ToImage(6), jl.ToImage(), ("bn", "conv")
        tkeys = ("0", "2")
    randomize_(port, 10).train(train)
    sd = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    params, stats = {}, {}
    for jk, tk in zip(jkeys, tkeys):
        w = sd[f"{tk}.weight"]
        if w.ndim == 4:
            params[jk] = {"kernel": w.transpose(2, 3, 1, 0)}
        else:
            params[jk] = {"scale": w, "bias": sd[f"{tk}.bias"]}
            stats[jk] = {"mean": sd[f"{tk}.running_mean"],
                         "var": sd[f"{tk}.running_var"]}
    want, upd = jmod.apply({"params": params, "batch_stats": stats}, x, train,
                           mutable=["batch_stats"])
    got = port(_nchw(x).contiguous(memory_format=torch.channels_last))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    jk, tk = [(j, t) for j, t in zip(jkeys, tkeys) if j == "bn"][0]
    np.testing.assert_allclose(port.state_dict()[f"{tk}.running_var"].numpy(),
                               np.asarray(upd["batch_stats"][jk]["var"]), **TOL)


def test_compute_dtype_casts_at_use():
    conv = tl.conv3x3(4, 8, compute_dtype=torch.bfloat16)
    lin = tl.Linear(4, 8, compute_dtype=torch.bfloat16)
    assert conv.weight.dtype == lin.weight.dtype == torch.float32
    assert conv(torch.randn(1, 4, 5, 5)).dtype == torch.bfloat16
    assert lin(torch.randn(2, 4)).dtype == torch.bfloat16
    jconv = jl.conv3x3(8, dtype=jnp.bfloat16)
    v = jconv.init(jax.random.PRNGKey(0), jnp.zeros((1, 5, 5, 4)))
    assert v["params"]["kernel"].dtype == jnp.float32


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (4, 2, 1), (1, 1, 0),
                                          (4, 1, 0)])
def test_twice_differentiable_conv_matches_conv2d(k, stride, pad):
    """The discriminators' conv (``layers.TwiceDifferentiableConv``): the
    forward and the first-order gradients of ``F.conv2d`` (float32, 1e-5
    relative L2), and the MAGP's term d/dw <d/dx <conv(x, w), dy>, ddx>
    within 1e-5 of float64 in float32 and 1e-2 (bf16's rounding) in
    bfloat16. PyTorch's own double backward of conv2d misses the last by
    about 100% at (3, 1, 1) in bfloat16 on the CPU."""
    rng = np.random.RandomState(k + stride)
    x = torch.from_numpy(rng.randn(2, 6, 13, 13)).contiguous(
        memory_format=torch.channels_last)
    w = torch.from_numpy(0.2 * rng.randn(8, 6, k, k))
    b = torch.from_numpy(0.1 * rng.randn(8))
    geometry = ((stride, stride), (pad, pad))
    y = F.conv2d(x, w, b, *geometry)
    dy = torch.from_numpy(rng.randn(*y.shape))
    ddx = torch.from_numpy(rng.randn(*x.shape))
    rel = lambda a, c: float((a.detach().double() - c).norm() / c.norm())

    def run(conv, dtype):
        leaves = [t.to(dtype).requires_grad_(True) for t in (x, w, b)]
        out = conv(*leaves)
        first = torch.autograd.grad((out.double() * dy).sum(), leaves,
                                    create_graph=True)
        second = torch.autograd.grad((first[0].double() * ddx).sum(),
                                     leaves[1])[0]
        return (out, *first, second)

    native = lambda xx, ww, bb: F.conv2d(xx, ww, bb, *geometry)
    twice = lambda xx, ww, bb: tl.TwiceDifferentiableConv.apply(
        xx, ww, bb, *geometry)
    want = run(native, torch.float64)
    got32 = run(twice, torch.float32)
    for name, g, r in zip(("y", "dx", "dw", "db", "ddw"), got32, want):
        assert rel(g, r.detach()) <= 1e-5, name
    assert rel(run(twice, torch.bfloat16)[-1], want[-1]) <= 1e-2
