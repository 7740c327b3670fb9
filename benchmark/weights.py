"""Weights from the seed, made on the device in two large draws.

The names and shapes come from the benchmark's own reference networks
(``reference/eegan.py``), which carry the program's parameter names, so
one dict of tensors loads into both sides (``load_state_dict`` with
``strict=True``: a renamed or reshaped parameter in the program fails the
run instead of leaving a tensor at its default).

Every tensor is drawn so that activations keep their scale through the
networks (the program's own initialisation shrinks them layer by layer,
and a random Inception then passes almost nothing to the DAMSM losses):

* weights of two or more dimensions: U(+-sqrt(6 / fan_in)), variance
  2 / fan_in (He's, for ReLU networks);
* batch-norm scales 1 + 0.1 N(0, 1), other vectors 0.1 N(0, 1) (so the
  zero-initialised residual gates and biases move the output too);
* running means 0.1 N(0, 1), running variances U(0.5, 1.5).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn


def spec(net: nn.Module) -> List[Tuple[str, torch.Size, str]]:
    """(name, shape, kind) of every floating tensor of ``net``'s state."""
    bn_scales = {f"{m}.weight" if m else "weight"
                 for m, mod in net.named_modules()
                 if isinstance(mod, nn.modules.batchnorm._BatchNorm)
                 and mod.affine}
    out = []
    for name, t in net.state_dict().items():
        if not t.is_floating_point():
            continue
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("running_mean", "running_var"):
            kind = leaf
        elif t.dim() >= 2:
            kind = "fan_in"
        elif name in bn_scales:
            kind = "bn_scale"
        else:
            kind = "vector"
        out.append((name, t.shape, kind))
    return out


def make(nets: Dict[str, nn.Module], seed: int, device
         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per network, its state dict drawn from ``seed`` on ``device``: one
    uniform and one normal draw over all tensors, cut in the order of the
    networks' names and their state dicts'."""
    specs = {key: spec(nets[key]) for key in sorted(nets)}
    total = sum(math.prod(shape) for s in specs.values() for _, shape, _ in s)
    gen = torch.Generator(device=device).manual_seed(seed)
    uni = torch.rand(total, generator=gen, device=device)
    nrm = torch.randn(total, generator=gen, device=device)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    at = 0
    for key, items in specs.items():
        state = {}
        for name, shape, kind in items:
            n = math.prod(shape)
            u, z = uni[at:at + n].view(shape), nrm[at:at + n].view(shape)
            at += n
            if kind == "fan_in":
                bound = math.sqrt(6.0 / (n // shape[0]))
                t = (2.0 * u - 1.0) * bound
            elif kind == "bn_scale":
                t = 1.0 + 0.1 * z
            elif kind == "running_var":
                t = 0.5 + u
            else:
                t = 0.1 * z
            state[name] = t.clone()
        out[key] = state
    return out


@torch.no_grad()
def load(net: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy ``state`` into ``net``'s floating tensors; the integer
    counters (``num_batches_tracked``) keep their values. Every floating
    tensor of ``net`` must be in ``state`` and nothing else."""
    own = {k: v for k, v in net.state_dict().items() if v.is_floating_point()}
    if set(own) != set(state):
        missing, extra = sorted(set(own) - set(state)), sorted(
            set(state) - set(own))
        raise KeyError(f"weights do not fit {type(net).__name__}: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")
    for name, t in own.items():
        if t.shape != state[name].shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} in the network, "
                             f"{tuple(state[name].shape)} drawn")
        t.copy_(state[name])
