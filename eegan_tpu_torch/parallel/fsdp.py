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
  :meth:`ShardedModule.reduce_scatter_grads` gives each owned slice its
  part of the ranks' mean gradient and frees the full gradients, and
  :meth:`ShardedModule.release` empties the module again. Adam's moments
  and the EMA copies live on the slices.

The collectives are the ones GSPMD places for the JAX package's rule. A
gather packs the rank's slices of a module's sharded tensors, per dtype,
into one chunk (each slice at a multiple of :data:`_ALIGN` elements, so
the chunk has one length on every rank), all-gathers the chunks over the
rank's fsdp group and copies each full tensor out of its F slices: only
copies, so every rank gets bitwise the owners' values. A module's sharded
gradients are packed the same way, F destination slices rank-major, and
reduce-scattered (summed) over the fsdp group straight into the rank's
slices; with more than one fsdp group (D > 1) the slices are then summed
over the rank's replica group (the D ranks with its fsdp index), and
divided by R = D·F. The replicated parameters' gradients take the
data-parallel all-reduce over all R ranks, as JAX's do. Per rank, a
gather of P sharded bytes moves P·(F-1)/F and a reduce-scatter of G
gradient bytes G·(F-1)/F (plus 2·(G/F)·(D-1)/D over the replica group),
where an all-reduce of the full gradients over every rank moves
2·G·(R-1)/R. gloo takes both calls for CPU and CUDA tensors, so gloo ranks
(on the CPU, or sharing a card) and NCCL ranks run one code path.
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
from eegan_tpu_torch.training.logging import span

# Leaves smaller than this stay replicated (the JAX package's floor): the
# big conv kernels, the generator's fc and their Adam/EMA copies shard,
# the 256x256 text MLPs and every bias stay whole.
MIN_SHARD_ELEMS = 2 ** 17
# Each slice in a rank's chunk of a gather or reduce-scatter starts at a
# multiple of this many elements, so the slices keep an allocation's
# alignment.
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

    def replicated(self) -> List[torch.Tensor]:
        """The module's parameters that the rule replicates."""
        return [p for j, p in enumerate(self.params) if self.dims[j] is None]

    def _slice_shape(self, j: int) -> Tuple[int, ...]:
        shape = list(self.shapes[j])
        shape[self.dims[j]] //= self.mesh.fsdp
        return tuple(shape)

    def _split(self, full: torch.Tensor, j: int) -> torch.Tensor:
        """A view of a full tensor of parameter j as its F slices along the
        shard dim, stacked along a new dim 0."""
        d = self.dims[j]
        return full.unflatten(d, (self.mesh.fsdp, -1)).movedim(d, 0)

    def _chunk_layout(self, tensors: Dict[int, torch.Tensor]
                      ) -> Dict[torch.dtype, Tuple[List, int]]:
        """{dtype: (parts, chunk length)} of a rank's chunks: per sharded
        parameter j of ``tensors`` (in index order), (j, lo, hi, slice
        shape) where its slice lies in the chunk of its dtype, each at a
        multiple of :data:`_ALIGN` elements."""
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for j in sorted(tensors):
            by_dtype.setdefault(tensors[j].dtype, []).append(j)
        layout = {}
        for dtype, idx in by_dtype.items():
            parts, total = [], 0
            for j in idx:
                shape = self._slice_shape(j)
                n = int(np.prod(shape))
                parts.append((j, total, total + n, shape))
                total += -(-n // _ALIGN) * _ALIGN
            layout[dtype] = (parts, total)
        return layout

    # -- collectives ------------------------------------------------------
    @torch.no_grad()
    def gather_tensors(self, shards: Dict[int, torch.Tensor]
                       ) -> Dict[int, torch.Tensor]:
        """The full tensors of the given shards (parameter index -> this
        rank's slice; any tensors of the parameters' shards, such as their
        values, moments or EMA copies), with the parameters' strides: one
        all-gather per dtype over the fsdp group. Every rank of the fsdp
        group must call it with the same indices."""
        F = self.mesh.fsdp
        out: Dict[int, torch.Tensor] = {}
        for dtype, (parts, chunk) in self._chunk_layout(shards).items():
            device = shards[parts[0][0]].device
            # The alignment gaps are never read.
            mine = torch.empty(chunk, dtype=dtype, device=device)
            for j, lo, hi, shape in parts:
                mine[lo:hi].view(shape).copy_(shards[j])
            every = self.mesh.all_gather_into(
                torch.empty((F, chunk), dtype=dtype, device=device), mine,
                self.mesh.fsdp_group)
            for j, lo, hi, shape in parts:
                full = torch.empty_strided(self.shapes[j], self.strides[j],
                                           dtype=dtype, device=device)
                self._split(full, j).copy_(every[:, lo:hi].view(F, *shape))
                out[j] = full
        return out

    @torch.no_grad()
    def reduce_scatter_grads(self) -> List[torch.Tensor]:
        """Give each owned slice its part of the mean over the mesh's R
        ranks of the module's full gradients, and free those: per dtype,
        one reduce-scatter (sum) over the fsdp group, with D > 1 one
        all-reduce of the slices over the replica group, then 1/R.
        Returns the owned slices. Every rank of the mesh must call it."""
        with span("fsdp.reduce_scatter"):
            mesh, F = self.mesh, self.mesh.fsdp
            grads = {j: p.grad for j, p in self.sharded()}
            for dtype, (parts, chunk) in self._chunk_layout(grads).items():
                device = grads[parts[0][0]].device
                every = torch.empty((F, chunk), dtype=dtype, device=device)
                for j, lo, hi, shape in parts:
                    every[:, lo:hi].view(F, *shape).copy_(
                        self._split(grads.pop(j), j))
                    self.params[j].grad = None
                mine = mesh.reduce_scatter_into(
                    torch.empty(chunk, dtype=dtype, device=device), every,
                    mesh.fsdp_group)
                del every
                if mesh.replica_group is not None:
                    dist.all_reduce(mine, group=mesh.replica_group)
                mine.div_(mesh.size)
                for j, lo, hi, shape in parts:
                    self.owned[j].grad = mine[lo:hi].view(shape)
            return [self.owned[j] for j, _ in self.sharded()]

    def gather(self) -> None:
        """Put the full parameters, from every rank's current slices, into
        the module."""
        with span("fsdp.gather"):
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
