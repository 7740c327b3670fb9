"""Data parallelism with global-batch semantics (counterpart of
``eegan_tpu/parallel/mesh.py``).

The JAX package runs one process over many devices: it shards the batch
over a ``data`` mesh axis and GSPMD inserts the psums, so batch-norm
statistics and the DAMSM losses are the global batch's. The port runs one
process per GPU instead (``parallel/distributed.py`` joins them), and does
the same math by hand:

* :class:`Mesh` holds the world size, this process's rank, its device and
  the process group, and slices a global batch into the rank's rows
  (:meth:`Mesh.rows`, :meth:`Mesh.shard_batch`, the counterpart of
  ``shard_batch``);
* its two collectives are differentiable, each its own
  ``torch.autograd.Function``: a sum all-reduce whose backward is an
  all-reduce (the batch norms' channel sums), and an all-gather along dim 0
  whose backward gives each rank its slice of the summed gradient (the
  DAMSM losses' rows and codes). The gather is an all-reduce over a
  zero-padded buffer: gloo on CUDA tensors has all-reduce but no
  all-gather, and NCCL refuses two ranks on one device, so the same code
  runs two gloo ranks on one card and NCCL ranks on many;
* :meth:`Mesh.average_gradients_` and :meth:`Mesh.average` average the
  gradients before each optimizer step, and the logged metrics, over the
  ranks.

The spec string is the JAX package's (``"data:8"``, ``"data:-1"`` for every
visible device, ``"data:4,fsdp:2"``). ``data:D,fsdp:F`` asks for D·F ranks,
laid out as the JAX package's ``make_mesh`` reshapes its devices: rank
d·F + f. The batch is split over all D·F ranks, so every rank still does
data-parallel work (the JAX package's ``batch_axes``), and each run of F
consecutive ranks is an fsdp group, over which ``parallel/fsdp.py`` shards
the train state. Any other axis larger than 1, or an fsdp axis written
before the data axis (another rank layout), raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"


def parse_mesh_spec(spec: str, n_devices: int
                    ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """Parse ``"data:8,fsdp:2"`` into axis names and sizes.

    A single ``-1`` size absorbs all remaining devices.
    """
    names, sizes = [], []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, size_s = part.split(":")
            size = int(size_s)
        else:
            name, size = part, -1
        names.append(name.strip())
        sizes.append(size)
    if sizes.count(-1) > 1:
        raise ValueError(f"at most one -1 axis allowed in mesh spec {spec!r}")
    fixed = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
    if -1 in sizes:
        if n_devices % fixed != 0:
            raise ValueError(
                f"mesh spec {spec!r}: {n_devices} devices not divisible by {fixed}"
            )
        sizes[sizes.index(-1)] = n_devices // fixed
    return tuple(names), tuple(sizes)


def check_axes(spec: str) -> None:
    """Refuse a spec with an axis other than ``data`` and ``fsdp`` that is
    not of size 1 (``-1`` included), and an fsdp axis larger than 1 written
    before the data axis."""
    names = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        name, _, size_s = part.partition(":")
        name = name.strip()
        size = int(size_s) if size_s else -1
        if name in (DATA_AXIS, FSDP_AXIS) or size == 1:
            names.append(name)
            continue
        raise NotImplementedError(
            f"mesh spec {spec!r}: axis {name!r} is not ported (the port's "
            "parallelism is the data and fsdp axes)")
    if FSDP_AXIS in names and DATA_AXIS in names \
            and names.index(FSDP_AXIS) < names.index(DATA_AXIS):
        raise NotImplementedError(
            f"mesh spec {spec!r}: an fsdp axis before the data axis is not "
            "ported (the port lays ranks out data-major, rank d*F + f)")


def mesh_shape(spec: str, n_devices: Optional[int]) -> Tuple[int, int]:
    """(D, F): the sizes of the spec's ``data`` and ``fsdp`` axes (1 where
    absent); the spec asks for D·F ranks. ``-1`` takes every one of
    ``n_devices`` (1 where that is None, the CPU). Raises for a spec that
    needs more devices than ``n_devices`` (it never shrinks) and for an
    axis that is not ported (:func:`check_axes`)."""
    check_axes(spec)
    names, sizes = parse_mesh_spec(spec, n_devices or 1)
    axes = dict(zip(names, sizes))
    data, fsdp = axes.get(DATA_AXIS, 1), axes.get(FSDP_AXIS, 1)
    if data < 1 or fsdp < 1:
        raise ValueError(f"mesh spec {spec!r}: axes of sizes {sizes}")
    if n_devices is not None and data * fsdp > n_devices:
        raise ValueError(f"mesh spec {spec!r} needs {data * fsdp} devices, "
                         f"have {n_devices}")
    return data, fsdp


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=mesh.group)
        return y

    @staticmethod
    def backward(ctx, dy):
        g = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.mesh.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        lo, hi = mesh.row_range(x.shape[0] * mesh.size)
        buf = x.new_zeros((x.shape[0] * mesh.size, *x.shape[1:]))
        buf[lo:hi] = x
        dist.all_reduce(buf, group=mesh.group)
        return buf

    @staticmethod
    def backward(ctx, dy):
        g = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.mesh.group)
        lo, hi = ctx.mesh.row_range(g.shape[0])
        return g[lo:hi], None


class Mesh:
    """The group as one process sees it: ``size`` ranks, this one's
    ``rank``, the ``device`` it computes on and the process ``group``
    (None: the default group). The batch is split over all ``size`` ranks.
    With ``fsdp`` > 1 the ranks form ``size // fsdp`` fsdp groups of
    ``fsdp`` consecutive ranks; ``fsdp_group`` is this rank's (a process
    group over those ranks) and ``fsdp_index`` its place in it."""

    def __init__(self, size: int, rank: int, device, group=None,
                 fsdp: int = 1, fsdp_group=None):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a mesh of {size}")
        if fsdp < 1 or size % fsdp:
            raise ValueError(f"an fsdp axis of {fsdp} does not divide "
                             f"{size} ranks")
        self.size = size
        self.rank = rank
        self.device = torch.device(device)
        self.group = group
        self.fsdp = fsdp
        self.fsdp_index = rank % fsdp
        self.fsdp_group = fsdp_group

    def fsdp_ranks(self, rank: Optional[int] = None) -> List[int]:
        """The ranks of ``rank``'s fsdp group (default: this rank's)."""
        first = (self.rank if rank is None else rank) // self.fsdp * self.fsdp
        return list(range(first, first + self.fsdp))

    @classmethod
    def current(cls, device, group=None, fsdp: int = 1) -> "Mesh":
        """The mesh of the process group this process has joined; with
        ``fsdp`` > 1 every rank creates every fsdp group, in the same
        order, as ``dist.new_group`` requires."""
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        mesh = cls(size, rank, device, group, fsdp)
        if fsdp > 1:
            ranks = (dist.get_process_group_ranks(group) if group is not None
                     else list(range(size)))
            for first in range(0, size, fsdp):
                members = mesh.fsdp_ranks(first)
                sub = dist.new_group([ranks[r] for r in members])
                if rank in members:
                    mesh.fsdp_group = sub
        return mesh

    def __deepcopy__(self, memo):
        # A module copy (the evaluator's) shares the group, not a copy.
        return self

    # -- the batch -------------------------------------------------------
    def row_range(self, global_rows: int) -> Tuple[int, int]:
        """This rank's rows [lo, hi) of a global batch."""
        if global_rows % self.size:
            raise ValueError(f"global batch {global_rows} not divisible by "
                             f"{self.size} ranks")
        local = global_rows // self.size
        return self.rank * local, (self.rank + 1) * local

    def rows(self, x):
        """This rank's rows of a global array or tensor (dim 0)."""
        lo, hi = self.row_range(len(x))
        return x[lo:hi]

    def shard_batch(self, batch: Dict) -> Dict:
        """Each leaf's rows for this rank (``DataPipeline(process_index,
        process_count)`` loads only these in a run)."""
        return {k: self.rows(v) for k, v in batch.items()}

    # -- differentiable collectives -------------------------------------
    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks; its gradient is the sum of the
        ranks' gradients."""
        return _AllReduceSum.apply(x, self)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` (equal shapes) stacked along dim 0 in rank
        order; each rank's gradient is its slice of the ranks' summed
        gradients. Integer tensors are gathered too (no gradient)."""
        return _AllGather.apply(x, self)

    # -- averaging -------------------------------------------------------
    @torch.no_grad()
    def average_gradients_(self, params: Iterable[torch.nn.Parameter]
                           ) -> None:
        """Replace each gradient by its mean over the ranks (one all-reduce
        per dtype). Every parameter must have a gradient."""
        grads = [p.grad for p in params]
        if any(g is None for g in grads):
            raise ValueError("every parameter needs a gradient before the "
                             "ranks average them")
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for group in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in group])
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.size)
            for g, part in zip(group, flat.split([g.numel() for g in group])):
                g.copy_(part.view_as(g))

    @torch.no_grad()
    def average(self, values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the ranks of each 0-d tensor (one all-reduce)."""
        flat = torch.stack([v.float() for v in values])
        dist.all_reduce(flat, group=self.group)
        return list((flat / self.size).unbind())
