"""FSDP: the train state's large leaves sharded over the mesh's ``fsdp``
axis (counterpart of ``eegan_tpu/parallel/fsdp.py``).

The JAX package hands a sharding rule to ``jax.jit`` and GSPMD places the
collectives. The port applies the same rule by hand, one process per
device (``parallel/mesh.py``: ranks laid out data-major, rank d·F + f, each
fsdp group F consecutive ranks):

* :func:`fsdp_spec` is the JAX rule: shard the largest dim that the axis
  size divides (the first of equal dims); leaves under
  :data:`MIN_SHARD_ELEMS` and leaves with no divisible dim stay
  replicated. The port runs it on its own shapes (OIHW convs, (out, in)
  linears), so with equal dims it may pick another dim than JAX's HWIO /
  (in, out) leaf does; which leaves shard, and how many elements each rank
  keeps, is the same. Only parameters are candidates: BN running stats,
  step counts and ``TrainState.step`` stay replicated, as in JAX at every
  width the configs use (the widest BN has 512 channels).
* :class:`ShardedModule` keeps, at rest, only the rank's slice ``[lo, hi)``
  of each sharded parameter (a leaf tensor that Adam updates; Adam is
  elementwise, so a slice's update is the full tensor's), and leaves the
  module's own parameter empty. :meth:`ShardedModule.gather` puts the full
  parameters back into the module for a phase of the step,
  :meth:`ShardedModule.take_grads` keeps the rank's slice of the full
  gradients (already averaged over every rank by
  ``Mesh.average_gradients_``) and :meth:`ShardedModule.release` empties
  the module again. Adam's moments and the EMA copies live on the slices.

A gather is one all-reduce per dtype over the rank's fsdp group, of a
buffer that holds the rank's slices and -0.0 elsewhere: IEEE addition of
-0.0 returns its other operand unchanged, so every rank gets bitwise the
owners' values, whatever order the backend sums in. gloo has no
all-gather or reduce-scatter for CUDA tensors and NCCL refuses two ranks
on one device, so, as for the mesh's batch gather, one code path serves
gloo and NCCL. Its cost against NCCL's native collectives, per gather of
P sharded bytes over F ranks: a ring all-reduce moves 2·P·(F-1)/F bytes
per rank where ``all_gather_into_tensor`` moves P·(F-1)/F. The gradients
take the data-parallel step's all-reduce over all D·F ranks
(2·G·(R-1)/R bytes per rank for G gradient bytes over R ranks) and each
rank keeps its slice, where ``reduce_scatter_tensor`` would move
G·(R-1)/R. Both native forms wait for a measurement across cards.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from eegan_tpu_torch.parallel.mesh import Mesh

# Leaves smaller than this stay replicated (the JAX package's floor): the
# big conv kernels, the generator's fc and their Adam/EMA copies shard,
# the 256x256 text MLPs and every bias stay whole.
MIN_SHARD_ELEMS = 2 ** 17
# Each parameter of a gather buffer starts at a multiple of this many
# elements, so the full parameters keep an allocation's alignment.
_ALIGN = 64


def has_fsdp_axis(mesh: Optional[Mesh]) -> bool:
    """True when the mesh carries an fsdp axis larger than 1."""
    return mesh is not None and mesh.fsdp > 1


def fsdp_spec(shape: Sequence[int], axis_size: int,
              min_shard_elems: int = MIN_SHARD_ELEMS) -> Optional[int]:
    """The dim of a leaf of ``shape`` that the rule shards over an fsdp
    axis of ``axis_size``, or None: it stays replicated."""
    if not shape or int(np.prod(shape)) < min_shard_elems:
        return None
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % axis_size == 0:
            return d
    return None


def shard_range(dim_size: int, index: int, axis_size: int
                ) -> Tuple[int, int]:
    """The slice ``[lo, hi)`` of a sharded dim that fsdp index ``index``
    keeps."""
    if dim_size % axis_size:
        raise ValueError(f"dim of {dim_size} not divisible by an fsdp axis "
                         f"of {axis_size}")
    n = dim_size // axis_size
    return index * n, (index + 1) * n


def _dense_stride(p: torch.Tensor) -> Tuple[int, ...]:
    """``p``'s strides, which must describe a dense layout (contiguous or
    channels_last), so a full copy can live in a slice of a flat buffer."""
    if p.is_contiguous():
        return tuple(p.stride())
    if p.dim() == 4 and p.is_contiguous(memory_format=torch.channels_last):
        return tuple(p.stride())
    raise ValueError(f"parameter of shape {tuple(p.shape)} and strides "
                     f"{tuple(p.stride())} is not dense")


class ShardedModule:
    """One module's parameters as one rank of an fsdp group holds them.

    ``owned[j]`` is what the rank keeps of parameter j at rest and what its
    optimizer updates: the rank's slice of a sharded parameter (a new leaf
    tensor), or the module's parameter itself when the rule replicates it.
    The module's sharded parameters are empty except between
    :meth:`gather` (or :meth:`materialize`) and :meth:`release`.
    """

    def __init__(self, module: nn.Module, mesh: Mesh,
                 min_shard_elems: int = MIN_SHARD_ELEMS):
        self.module = module
        self.mesh = mesh
        named = list(module.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.shapes = [tuple(p.shape) for p in self.params]
        self.strides = [_dense_stride(p) for p in self.params]
        self.dims = [fsdp_spec(s, mesh.fsdp, min_shard_elems)
                     for s in self.shapes]
        self.owned: List[torch.Tensor] = [
            p if d is None else nn.Parameter(self.shard(j, p.detach()),
                                             requires_grad=p.requires_grad)
            for j, (p, d) in enumerate(zip(self.params, self.dims))]
        self._empty = {j: p.new_empty(0) for j, p in self.sharded()}
        self.release()

    def sharded(self) -> Iterator[Tuple[int, torch.Tensor]]:
        """(index, module parameter) of each sharded parameter."""
        return ((j, p) for j, p in enumerate(self.params)
                if self.dims[j] is not None)

    def shard(self, j: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full tensor of parameter j's shape (a
        contiguous copy)."""
        if tuple(full.shape) != self.shapes[j]:
            raise ValueError(f"{self.names[j]}: shape {tuple(full.shape)}, "
                             f"the parameter's {self.shapes[j]}")
        d = self.dims[j]
        lo, hi = shard_range(full.shape[d], self.mesh.fsdp_index,
                             self.mesh.fsdp)
        return full.narrow(d, lo, hi - lo).clone(
            memory_format=torch.contiguous_format)

    # -- collectives ------------------------------------------------------
    @torch.no_grad()
    def gather_tensors(self, shards: Dict[int, torch.Tensor]
                       ) -> Dict[int, torch.Tensor]:
        """The full tensors of the given shards (parameter index -> this
        rank's slice; any tensors of the parameters' shards, such as their
        values, moments or EMA copies), with the parameters' strides. Every
        rank of the fsdp group must call it with the same indices."""
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for j in sorted(shards):
            by_dtype.setdefault(shards[j].dtype, []).append(j)
        out: Dict[int, torch.Tensor] = {}
        for dtype, idx in by_dtype.items():
            offsets, total = [], 0
            for j in idx:
                offsets.append(total)
                n = int(np.prod(self.shapes[j]))
                total += -(-n // _ALIGN) * _ALIGN
            flat = torch.full((total,), -0.0, dtype=dtype,
                              device=shards[idx[0]].device)
            for j, off in zip(idx, offsets):
                full = flat.as_strided(self.shapes[j], self.strides[j], off)
                d = self.dims[j]
                lo, hi = shard_range(self.shapes[j][d], self.mesh.fsdp_index,
                                     self.mesh.fsdp)
                full.narrow(d, lo, hi - lo).copy_(shards[j])
                out[j] = full
            dist.all_reduce(flat, group=self.mesh.fsdp_group)
        return out

    def gather(self) -> None:
        """Put the full parameters, from every rank's current slices, into
        the module."""
        full = self.gather_tensors({j: self.owned[j].detach()
                                    for j, _ in self.sharded()})
        for j, p in self.sharded():
            p.data = full[j]

    # -- local ------------------------------------------------------------
    def materialize(self) -> None:
        """Full-size, uninitialised parameters in the module (for loading a
        full state dict without collectives; :meth:`reshard` keeps the
        slices)."""
        for j, p in self.sharded():
            p.data = torch.empty_strided(self.shapes[j], self.strides[j],
                                         dtype=p.dtype, device=p.device)

    @torch.no_grad()
    def reshard(self) -> None:
        """Copy this rank's slice of the module's full parameters into the
        owned slices."""
        for j, p in self.sharded():
            self.owned[j].copy_(self.shard(j, p))

    def release(self) -> None:
        """Empty the module's sharded parameters and their gradients."""
        for j, p in self.sharded():
            p.data = self._empty[j]
            p.grad = None

    @torch.no_grad()
    def take_grads(self) -> None:
        """Each owned slice's gradient from the module's full gradient (the
        ranks' average); the full gradients are freed."""
        for j, p in self.sharded():
            self.owned[j].grad = self.shard(j, p.grad)
            p.grad = None

    def unsharded_copy(self) -> nn.Module:
        """A copy of the module with full-size, uninitialised parameters (a
        module to load full state dicts into, such as an evaluator's)."""
        clone = copy.deepcopy(self.module)
        for j, (_, p) in enumerate(clone.named_parameters()):
            if self.dims[j] is not None:
                p.data = torch.empty_strided(self.shapes[j], self.strides[j],
                                             dtype=p.dtype, device=p.device)
        return clone


@dataclasses.dataclass
class FsdpShards:
    """The train state's sharded modules: the generator and AttrEnhance
    (one optimizer over both, in that order) and each discriminator."""

    generator: ShardedModule
    attr_enhance: ShardedModule
    discriminators: Tuple[ShardedModule, ...]

    def modules(self) -> Tuple[ShardedModule, ...]:
        return (self.generator, self.attr_enhance, *self.discriminators)

    def gather(self) -> None:
        for m in self.modules():
            m.gather()

    def release(self) -> None:
        for m in self.modules():
            m.release()


def _optimizer_slots(modules: Sequence[ShardedModule]
                     ) -> List[Tuple[ShardedModule, int]]:
    """(module, parameter index) of each of an optimizer's parameters, in
    its order."""
    return [(m, j) for m in modules for j in range(len(m.params))]


MOMENT_KEYS = ("exp_avg", "exp_avg_sq")


def full_optimizer_state(opt: torch.optim.Optimizer,
                         modules: Sequence[ShardedModule]) -> Dict:
    """``opt.state_dict()`` in the unsharded layout: each sharded
    parameter's Adam moments gathered to full size. Collective."""
    sd = opt.state_dict()
    slots = _optimizer_slots(modules)
    state = {i: dict(s) for i, s in sd["state"].items()}
    for m in modules:
        for key in MOMENT_KEYS:
            shards = {j: state[i][key] for i, (mm, j) in enumerate(slots)
                      if mm is m and m.dims[j] is not None and i in state}
            full = m.gather_tensors(shards)
            for i, (mm, j) in enumerate(slots):
                if mm is m and j in full:
                    state[i][key] = full[j]
    return {"state": state, "param_groups": sd["param_groups"]}


def shard_optimizer_state(sd: Dict, modules: Sequence[ShardedModule]
                          ) -> Dict:
    """A full-layout optimizer state dict with each sharded parameter's
    moments cut to this rank's slice (for ``opt.load_state_dict``)."""
    slots = _optimizer_slots(modules)
    state = {}
    for i, s in sd["state"].items():
        m, j = slots[int(i)]
        state[i] = {k: (m.shard(j, v) if k in MOMENT_KEYS
                        and m.dims[j] is not None else v)
                    for k, v in s.items()}
    return {"state": state, "param_groups": sd["param_groups"]}
