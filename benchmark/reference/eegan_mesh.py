"""What the processes of a data mesh exchange, so that together they
compute the reference's iteration (``reference/steps.py``) over one
global batch of which each holds its rows.

R processes of one ``torch.distributed`` group each hold B rows of a
global batch of R·B. Handed to ``steps.train``, ``steps.first_g_grads``
and ``steps.magp_grads`` as their ``exchange``, an :class:`Exchange`
makes each process's part of the step the global batch's:

* the generator's batch norms (:meth:`Exchange.bind`) normalise by the
  global batch's mean and biased variance: each norm sums its channels
  over its rows, the processes add the sums (a differentiable
  all-reduce, whose backward adds the processes' gradients), first of
  the rows, then of their squared deviations from the global mean;
* the DAMSM sentence, words and attribute losses contrast the whole
  batch (:meth:`Exchange.rows`): every process gathers every process's
  image regions and codes and attribute codes (a differentiable
  all-gather: each process's rows get the sum of the processes'
  gradients), sentence and word codes, caption lengths and classes, and
  computes the whole (R·B)² grid, the same on every process;
* every gradient is averaged over the processes before each Adam update
  (:meth:`Exchange.average_`): each process's hinge, class and MAGP
  terms are means over its rows, so their average is the global mean,
  and the DAMSM losses, computed whole on every process, send each row
  R times its gradient, which the average divides out;
* the losses reported are the mean over the processes (:meth:`Exchange.mean`).

Written from those semantics, not from the program: it imports nothing
of the port, and the collectives are its own.

``fault`` plants what a mesh can get wrong, for the readings that set
the limits: ``local_bn`` (each process's batch norms by its own rows),
``local_grads`` (the gradients not averaged: each process updates with
its own), ``local_damsm`` (the DAMSM grid over each process's rows
only).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

FAULTS = ("local_bn", "local_grads", "local_damsm")


class _Sum(torch.autograd.Function):
    """The sum over the processes; its gradient is the sum of theirs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        g = dy.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Gather(torch.autograd.Function):
    """The processes' rows (dim 0, equal counts) in rank order; each
    process's rows get the sum of the processes' gradients of them."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank, ctx.rows = dist.get_rank(group), x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, dy):
        g = dy.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        lo = ctx.rank * ctx.rows
        return g[lo:lo + ctx.rows], None


class Exchange:
    """The exchanges of one global step over ``group`` (None: the default
    group), with ``fault`` (one of :data:`FAULTS`) left out."""

    def __init__(self, group=None, fault: Optional[str] = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"no mesh fault {fault!r}: {', '.join(FAULTS)}")
        self.group, self.fault = group, fault
        self.size = dist.get_world_size(group)
        # The generator's batch norms' first batch moments by name (on the
        # host): (mean, unbiased variance) per channel.
        self.moments: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def bind(self, nets: Dict[str, nn.Module]) -> Dict[str, nn.Module]:
        """Point the generator's batch norms at the global batch (at each
        process's rows with ``local_bn``)."""
        for name, m in nets["generator"].named_modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.forward = functools.partial(self.batch_norm, m,
                                              f"generator.{name}")
        return nets

    def batch_norm(self, bn, name, x):
        """``bn`` in train mode over the global batch; in eval mode by its
        running statistics. Its first train-mode call keeps the batch's
        mean and unbiased variance per channel in :attr:`moments` under
        ``name``."""
        if not bn.training:
            return F.batch_norm(x, bn.running_mean, bn.running_var,
                                bn.weight, bn.bias, False, 0.0, bn.eps)
        dims = (0, 2, 3)
        local = self.fault == "local_bn"

        def total(t):
            return t if local else _Sum.apply(t, self.group)

        count = x.numel() // x.shape[1] * (1 if local else self.size)
        mean = total(x.sum(dims)) / count
        dev = x - mean[None, :, None, None]
        var = total(dev.square().sum(dims)) / count
        if name not in self.moments:
            self.moments[name] = (mean.detach().cpu(), var.detach().cpu()
                                  * (count / max(count - 1, 1)))
        y = dev * torch.rsqrt(var + bn.eps)[None, :, None, None]
        if bn.affine:
            y = y * bn.weight[None, :, None, None] \
                + bn.bias[None, :, None, None]
        return y

    def rows(self, *tensors):
        """Every process's rows of each tensor, in rank order."""
        if self.fault == "local_damsm":
            return tensors
        return tuple(_Gather.apply(t, self.group) for t in tensors)

    @torch.no_grad()
    def average_(self, named: Dict[str, torch.Tensor]) -> None:
        """Each tensor's gradient (zeros where it has none) replaced by
        its mean over the processes (one all-reduce)."""
        params = list(named.values())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.fault == "local_grads" or not params:
            return
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.size)
        for p, part in zip(params, flat.split([p.numel() for p in params])):
            p.grad.copy_(part.view_as(p.grad))

    @torch.no_grad()
    def mean(self, values: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """Each 0-d value's mean over the processes."""
        flat = torch.stack([v.float() for v in values.values()])
        dist.all_reduce(flat, group=self.group)
        return dict(zip(values, (flat / self.size).unbind()))
