"""Activation rematerialisation (RUNTIME.REMAT, REMAT_BLOCKS, REMAT_D,
REMAT_IMAGE_ENCODER) in the port.

* The generator (every block, and a selection of blocks with the Cum
  blocks), a discriminator (through the MAGP's double backward) and the
  image encoder give the same outputs and gradients with and without
  checkpointing, as ``tests/test_models.py`` holds the JAX modules: 1e-6.
* Batch-norm running stats move once per forward even though the
  checkpointed forward runs again in the backward.
* One REMAT train step (REMAT_D and REMAT_IMAGE_ENCODER on) against the
  JAX package's REMAT step, at ``test_torch_train_step.py``'s bars.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn as nn

from eegan_tpu_torch.models.discriminator import Discriminator
from eegan_tpu_torch.models.factory import randomize_
from eegan_tpu_torch.models.generator import Generator
from eegan_tpu_torch.models.image_encoder import ImageEncoder
from eegan_tpu_torch.models.layers import TorchBatchNorm, checkpointed
from eegan_tpu_torch.training.steps import _gradient_penalty
from test_torch_train_step import (
    check_discriminators,
    check_generator,
    check_metrics,
    run_both,
)

torch.set_num_threads(1)

NGF, B, COND = 4, 2, 256


def _twins(module):
    """``module`` with random weights and BN stats, and a copy that
    checkpoints (``remat`` set on the copy)."""
    randomize_(module, 0)
    twin = copy.deepcopy(module)
    twin.remat = True
    return module, twin


def _grads(module):
    return {n: p.grad.clone() for n, p in module.named_parameters()
            if p.grad is not None}


def _assert_same(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-6,
                                   msg=lambda m: f"{what} {k}: {m}")


@pytest.mark.parametrize("remat_blocks", ["", "4,5,6,cum", "0,2"])
def test_generator_remat_matches_plain(remat_blocks):
    plain, remat = _twins(Generator(ngf=NGF, pallas_affine=True,
                                    up_fused=True))
    remat.remat_blocks = remat_blocks
    g = torch.Generator().manual_seed(1)
    z = torch.randn(B, 100, generator=g)
    sent = torch.randn(B, COND, generator=g)
    attrs = torch.randn(B, COND, generator=g)
    weights = [torch.randn(B, s, s, 3, generator=g) for s in (64, 128, 256)]
    outs = {}
    for name, gen in (("plain", plain), ("remat", remat)):
        gen.train()
        imgs = gen(z, sent, attrs)
        sum((w * im).sum() for w, im in zip(weights, imgs)).backward()
        outs[name] = (imgs, _grads(gen), gen.state_dict())
    for a, b in zip(outs["plain"][0], outs["remat"][0]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    _assert_same(outs["plain"][1], outs["remat"][1], "generator grad")
    assert len(outs["remat"][1]) == len(list(remat.parameters()))
    # Running stats moved once, as without remat.
    _assert_same({k: v.float() for k, v in outs["plain"][2].items()},
                 {k: v.float() for k, v in outs["remat"][2].items()},
                 "generator state")
    tracked = [v for k, v in outs["remat"][2].items()
               if k.endswith("num_batches_tracked")]
    assert tracked and all(int(v) == 1 for v in tracked)


def test_generator_remat_wanted_keys():
    gen = Generator(ngf=NGF, remat=True, remat_blocks=" 4, cum")
    assert [gen._remat_wanted(k) for k in (0, 4, 5, "cum")] == [
        False, True, False, True]
    gen.remat_blocks = ""
    assert all(gen._remat_wanted(k) for k in (0, 6, "cum"))
    gen.remat = False
    assert not any(gen._remat_wanted(k) for k in (0, 6, "cum"))


@pytest.mark.parametrize("disc_class", [False, True])
def test_discriminator_remat_matches_plain_through_magp(disc_class):
    plain, remat = _twins(Discriminator(ndf=NGF, scale=64,
                                        disc_class=disc_class, class_nums=5))
    g = torch.Generator().manual_seed(2)
    img = torch.rand(B, 64, 64, 3, generator=g) * 2 - 1
    sent = torch.randn(B, COND, generator=g)
    results = {}
    for name, d in (("plain", plain), ("remat", remat)):
        out = d(img, sent)
        out = out[0] if disc_class else out
        out.sum().backward()
        first = _grads(d)
        d.zero_grad(set_to_none=True)
        gp = _gradient_penalty(d, img, sent, disc_class)
        gp.backward()
        results[name] = (out.detach(), first, gp.detach(), _grads(d))
    p, r = results["plain"], results["remat"]
    torch.testing.assert_close(p[0], r[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(p[2], r[2], rtol=1e-6, atol=1e-9)
    _assert_same(p[1], r[1], "hinge grad")
    _assert_same(p[3], r[3], "MAGP grad")


def test_image_encoder_remat_matches_plain():
    plain, remat = _twins(ImageEncoder(nef=32))
    for enc in (plain, remat):
        enc.eval()
        enc.requires_grad_(False)
    g = torch.Generator().manual_seed(3)
    img = torch.rand(B, 64, 64, 3, generator=g) * 2 - 1
    results = {}
    for name, enc in (("plain", plain), ("remat", remat)):
        x = img.clone().requires_grad_(True)
        region, code = enc(x)
        (region.square().sum() + code.sum()).backward()
        results[name] = (region.detach(), code.detach(), x.grad)
    for a, b in zip(results["plain"], results["remat"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


class _TwoNorms(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 6, 3, padding=1)
        self.bn1 = TorchBatchNorm(6)
        self.bn2 = TorchBatchNorm(6, affine=False)

    def forward(self, x):
        return self.bn2(torch.tanh(self.bn1(self.conv(x))))


def test_batchnorm_running_stats_move_once_under_checkpoint():
    torch.manual_seed(0)
    plain = _TwoNorms()
    ckpt = copy.deepcopy(plain)
    x = torch.randn(4, 3, 5, 5)
    plain(x).square().sum().backward()
    checkpointed(ckpt, x).square().sum().backward()
    for name in ("bn1", "bn2"):
        a, b = getattr(plain, name), getattr(ckpt, name)
        assert int(b.num_batches_tracked) == 1
        assert not b.recomputing
        torch.testing.assert_close(a.running_mean, b.running_mean)
        torch.testing.assert_close(a.running_var, b.running_var)
    torch.testing.assert_close(plain.conv.weight.grad, ckpt.conv.weight.grad)
    # Without autograd recording, a plain call.
    with torch.no_grad():
        checkpointed(ckpt, x)
    assert int(ckpt.bn1.num_batches_tracked) == 2


@pytest.fixture(scope="module")
def run():
    return run_both(dense_d=True, magp_chunks=1,
                    runtime=dict(REMAT=True, REMAT_D=True,
                                 REMAT_IMAGE_ENCODER=True))


def test_remat_step_metrics_match_jax(run):
    check_metrics(run)


def test_remat_step_generator_matches_jax(run):
    check_generator(run)
    tracked = [v for k, v in run["state"].generator.state_dict().items()
               if k.endswith("num_batches_tracked")]
    assert tracked and all(int(v) == 1 for v in tracked)


def test_remat_step_discriminators_match_jax(run):
    check_discriminators(run)
    assert all(d.remat for d in run["state"].discriminators)
    assert run["state"].generator.remat
    assert np.isfinite(float(run["metrics"]["errG/total"]))
