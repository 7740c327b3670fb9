"""The autograd Function of kernels 1-2 (``ops/affine.py:AffineMaskReLU``)
inside a network's backward, on the CPU.

On a CPU tensor ``affine_mask_relu`` takes the plain version, so no other
CPU test runs the Function that carries kernel 2's six gradients (dx,
dmean, dvar, dgamma, dbeta, dmask) back into ``TorchBatchNorm.batch_stats``
and the mask heads. Here the Function's two launch points are patched:
``_forward_kernel`` to the plain forward and ``affine_mask_relu_backward``
to autograd of the plain version, and the generator calls
``AffineMaskReLU.apply`` itself. A tiny generator in train mode, from the
same weights and inputs, with FUSED_UPSAMPLE on and off:

* through the Function against RUNTIME.PALLAS_AFFINE on without it (the
  plain version's own autograd, the same forward): every parameter's
  gradient and the gradient of every batch norm's input (through dmean
  and dvar) within 1e-5 relative L2 per tensor;
* through the Function against RUNTIME.PALLAS_AFFINE off (the module
  path): the images and the running statistics within 1e-6, the whole
  gradient within 1e-5 relative L2 and each tensor within 1e-3. The
  Function's output lies in channels_last memory, so the next convs sum
  in another order; where a mask head's batch-norm output lies within
  that rounding of 0, its ReLU gate flips and moves one channel of the
  head's gradients (one flip at these weights: 2.8e-4 in
  ``blocks.4.conv_mask.1.bias``, every other tensor within 1e-5).

A tensor whose gradient the math makes about 0 (a bias before a batch
norm) is measured against 1e-3 of its share of the whole gradient's norm
instead of its own (``chip_smoke.py``'s rule for the card's moments).
"""

import math

import pytest
import torch

from eegan_tpu_torch.models import generator as generator_module
from eegan_tpu_torch.models.generator import AffineSSA, Generator
from eegan_tpu_torch.models.layers import TorchBatchNorm
from eegan_tpu_torch.ops import affine

torch.set_num_threads(1)
SEED = 11
B = 4
NGF = 4
COND = 32
AFFINE_SITES = 14  # two per SAGB block, seven blocks


def _plain_backward(x, mean, var, gamma, beta, mask, dy, up, eps):
    leaves = [t.detach().requires_grad_(True)
              for t in (x, mean, var, gamma, beta, mask)]
    with torch.enable_grad():
        out = affine.affine_mask_relu_reference(*leaves, up, eps, dy.dtype)
    return torch.autograd.grad(out, leaves, dy)


def _run(pallas: bool, up_fused: bool):
    """Images, running stats, parameter gradients and batch-norm input
    gradients of one weighted-sum backward through a tiny generator."""
    torch.manual_seed(SEED)
    g = Generator(ngf=NGF, nz=100, cond_dim=COND, up_fused=up_fused,
                  pallas_affine=pallas).train()
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():  # the affine heads' zero-initialised layers too
        for p in g.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    z, sent, attrs = (torch.randn((B, n), generator=gen)
                      for n in (100, COND, COND))
    norm_inputs = []

    def keep_input(module, args):
        if torch.is_grad_enabled() and args[0].requires_grad:
            args[0].retain_grad()
            norm_inputs.append(args[0])

    hooks = [m.register_forward_pre_hook(keep_input)
             for m in g.modules() if isinstance(m, TorchBatchNorm)]
    out = g(z, sent, attrs)
    for h in hooks:
        h.remove()
    weights = [torch.randn(o.shape, generator=gen) for o in out]
    sum((o * w).sum() for o, w in zip(out, weights)).backward()
    return dict(
        images=[o.detach() for o in out],
        buffers={n: b.clone() for n, b in g.named_buffers()
                 if b.dtype.is_floating_point},
        grads={n: p.grad.clone() for n, p in g.named_parameters()},
        norm_input_grads=[x.grad.clone() for x in norm_inputs],
        sites=sum(isinstance(m, AffineSSA) for m in g.modules()))


def _gaps(got, want):
    """Relative L2 distance per tensor; a tensor's scale is the larger of
    its own norm and 1e-3 of its share of the whole set's norm."""
    total = math.sqrt(sum(float(w.square().sum()) for w in want))
    n = sum(w.numel() for w in want)
    return [float((g - w).norm())
            / max(float(w.norm()), 1e-3 * total * math.sqrt(w.numel() / n),
                  1e-30)
            for g, w in zip(got, want)]


def _global_gap(got, want):
    diff = math.sqrt(sum(float((g - w).square().sum())
                         for g, w in zip(got, want)))
    return diff / math.sqrt(sum(float(w.square().sum()) for w in want))


@pytest.fixture(scope="module", params=[False, True],
                ids=["upsample", "fused_upsample"])
def runs(request):
    """The generator's results with PALLAS_AFFINE off, on (the plain
    version's autograd) and on through the Function."""
    up_fused = request.param
    out = {"off": _run(False, up_fused), "plain": _run(True, up_fused)}
    calls = {"forward": 0, "backward": 0}

    def forward(*args):
        calls["forward"] += 1
        return affine.affine_mask_relu_reference(*args)

    def backward(*args):
        calls["backward"] += 1
        return _plain_backward(*args)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(affine, "_forward_kernel", forward)
        patch.setattr(affine, "affine_mask_relu_backward", backward)
        patch.setattr(generator_module, "affine_mask_relu",
                      affine.AffineMaskReLU.apply)
        out["function"] = _run(True, up_fused)
    out["calls"] = calls
    return out


def test_function_runs_at_every_site(runs):
    assert runs["function"]["sites"] == AFFINE_SITES
    assert runs["calls"] == {"forward": AFFINE_SITES,
                             "backward": AFFINE_SITES}


def test_function_matches_the_plain_autograd(runs):
    got, want = runs["function"], runs["plain"]
    names = list(want["grads"])
    gaps = _gaps([got["grads"][n] for n in names],
                 [want["grads"][n] for n in names])
    assert max(gaps) <= 1e-5, max(zip(gaps, names))
    assert len(want["norm_input_grads"]) >= AFFINE_SITES
    gaps = _gaps(got["norm_input_grads"], want["norm_input_grads"])
    assert len(gaps) == len(want["norm_input_grads"])
    assert max(gaps) <= 1e-5, gaps


def test_function_matches_the_module_path(runs):
    got, want = runs["function"], runs["off"]
    for a, b in zip(want["images"], got["images"]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6)
    for name, a in want["buffers"].items():
        torch.testing.assert_close(got["buffers"][name], a, rtol=1e-6,
                                   atol=1e-6, msg=name)
    for key in ("grads", "norm_input_grads"):
        g, w = got[key], want[key]
        if isinstance(w, dict):
            g, w = [g[n] for n in w], list(w.values())
        assert len(g) == len(w)
        assert _global_gap(g, w) <= 1e-5, key
        gaps = _gaps(g, w)
        assert max(gaps) <= 1e-3, (key, max(gaps))
