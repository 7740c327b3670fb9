"""Train state and optimizers (counterpart of ``eegan_tpu/training/state.py``).

The reference keeps one Adam over G ∪ AttrEnhance (lr 1e-4) and one Adam per
discriminator (lr 4e-4), betas (0.0, 0.9) (reference `train.py:252-263`).
torch's Adam computes optax.adam's update, lr * m̂ / (sqrt(v̂) + eps), with
the same bias corrections. The JAX state is an immutable pytree that the
step returns anew; here the modules and optimizers are updated in place
(no second copy of the parameters), and the step returns the same state.

With an fsdp axis (``create_train_state(..., mesh)``, ``parallel/fsdp.py``)
the state keeps only this rank's slice of each large parameter, of its
Adam moments and of its EMA copy; the optimizers run over those slices
(``TrainState.shards``), and the modules hold full parameters only while
the step gathers them. :func:`full_state_dict` and
:func:`load_full_state_dict` read and write the state in the unsharded
layout either way, so a checkpoint does not depend on the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from eegan_tpu_torch.config import Config
from eegan_tpu_torch.models.factory import ModelBundle
from eegan_tpu_torch.parallel.fsdp import (
    MIN_SHARD_ELEMS,
    FsdpShards,
    ShardedModule,
    full_optimizer_state,
    has_fsdp_axis,
    shard_optimizer_state,
)
from eegan_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class FrozenEncoders:
    """The frozen DAMSM encoders (reference `train.py:233-248`): eval mode,
    no parameter requires grad."""

    text_encoder: nn.Module
    image_encoder: nn.Module


@dataclasses.dataclass
class TrainState:
    step: int
    generator: nn.Module  # parameters and batch-norm running stats
    attr_enhance: nn.Module
    discriminators: Tuple[nn.Module, ...]
    g_opt: torch.optim.Optimizer  # over generator ∪ attr_enhance
    d_opts: Tuple[torch.optim.Optimizer, ...]
    # Exponential moving averages of the generator and AttrEnhance
    # parameters (TRAIN.G_EMA_DECAY > 0), by parameter name; None when off.
    # Under FSDP a sharded parameter's entry is this rank's slice.
    g_ema: Optional[Dict[str, torch.Tensor]] = None
    attr_ema: Optional[Dict[str, torch.Tensor]] = None
    # The sharded modules under an fsdp axis; None without one.
    shards: Optional[FsdpShards] = None
    # The D phase captured as CUDA graphs (``training/d_graph.py``), once
    # a step has captured it; None before and off the card.
    d_graphs: Optional[Any] = None


def generator_params(state_or_models) -> List[nn.Parameter]:
    """The parameters the G step trains: the generator's, then
    AttrEnhance's."""
    return (list(state_or_models.generator.parameters())
            + list(state_or_models.attr_enhance.parameters()))


def make_optimizers(config: Config, models,
                    shards: Optional[FsdpShards] = None,
                    capturable: bool = False
                    ) -> Tuple[torch.optim.Optimizer,
                               Tuple[torch.optim.Optimizer, ...]]:
    """Adam(GENERATOR_LR) over G ∪ AttrEnhance and Adam(DISCRIMINATOR_LR)
    for each discriminator, betas (B1, B2), eps 1e-8 — over the modules'
    parameters, or with ``shards`` over the tensors each rank owns, in the
    same order. TRAIN.D_GRAD_CLIP is applied by the step
    (:func:`clip_by_global_norm_`) before each D update, as the JAX
    package's ``optax.chain`` does. ``capturable`` makes the D optimizers
    ``capturable`` (the step count on the device, so that a CUDA graph
    can hold their update: ``training/d_graph.py``); the same Adam."""
    t = config.TRAIN

    def adam(params, lr, capturable=False):
        return torch.optim.Adam(params, lr=lr, betas=(t.B1, t.B2), eps=1e-8,
                                capturable=capturable)

    if shards is None:
        g_params = generator_params(models)
        d_params = [list(d.parameters()) for d in models.discriminators]
    else:
        g_params = shards.generator.owned + shards.attr_enhance.owned
        d_params = [d.owned for d in shards.discriminators]
    g_opt = adam(g_params, t.GENERATOR_LR)
    d_opts = tuple(adam(p, t.DISCRIMINATOR_LR, capturable)
                   for p in d_params)
    return g_opt, d_opts


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[nn.Parameter], max_norm: float,
                         sharded: Sequence[torch.Tensor] = (), group=None
                         ) -> torch.Tensor:
    """Scale the gradients in place so their global L2 norm is at most
    ``max_norm`` (``optax.clip_by_global_norm``: untouched below the bound,
    g * max_norm / norm at or above it). Returns the norm before clipping.
    Under FSDP ``sharded`` holds tensors whose gradients are this rank's
    slices of gradients split over the ranks of ``group``: their sum of
    squares is all-reduced over ``group`` (one scalar) and added to that
    of ``params``, whose gradients every rank holds whole. The sums are
    float64, so the norm does not depend on how the gradients are split
    (to about 1e-16): the FSDP step clips by the float32 scale the
    data-parallel step clips by. No host synchronisation."""
    grads = [p.grad for p in params if p.grad is not None]
    slices = [t.grad for t in sharded if t.grad is not None]

    def sum_sq(gs):
        return sum(torch.linalg.vector_norm(g, dtype=torch.float64).square()
                   for g in gs)

    sq = sum_sq(grads)
    if slices:
        part = sum_sq(slices)
        dist.all_reduce(part, group=group)
        sq = sq + part
    norm = torch.sqrt(sq)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads + slices:
        g.mul_(scale.to(g.dtype))
    return norm.float()


def _freeze(module: nn.Module) -> nn.Module:
    module.eval()
    module.requires_grad_(False)
    return module


def create_train_state(config: Config, models: ModelBundle,
                       mesh: Optional[Mesh] = None,
                       min_shard_elems: int = MIN_SHARD_ELEMS
                       ) -> Tuple[TrainState, FrozenEncoders]:
    """The state over ``models``' trainable modules (their current
    weights), fresh optimizers, the EMA copies, and the frozen encoders.
    With an fsdp axis on ``mesh`` the trainable modules are sharded
    (``parallel/fsdp.py``; ``min_shard_elems`` lowers the rule's floor for
    tests at small widths) and their full parameters released."""
    shards = None
    if has_fsdp_axis(mesh):
        def shard(module):
            return ShardedModule(module, mesh, min_shard_elems)

        shards = FsdpShards(
            generator=shard(models.generator),
            attr_enhance=shard(models.attr_enhance),
            discriminators=tuple(shard(d) for d in models.discriminators))
    # The D phase can replay as CUDA graphs on a card without a mesh.
    g_opt, d_opts = make_optimizers(
        config, models, shards,
        capturable=mesh is None and torch.device(models.device).type
        == "cuda")
    use_ema = config.TRAIN.G_EMA_DECAY > 0

    def copy(module):
        return {name: p.detach().clone()
                for name, p in trained_tensors(module, shards)}

    state = TrainState(
        step=0,
        generator=models.generator,
        attr_enhance=models.attr_enhance,
        discriminators=tuple(models.discriminators),
        g_opt=g_opt,
        d_opts=d_opts,
        g_ema=copy(models.generator) if use_ema else None,
        attr_ema=copy(models.attr_enhance) if use_ema else None,
        shards=shards,
    )
    frozen = FrozenEncoders(text_encoder=_freeze(models.text_encoder),
                            image_encoder=_freeze(models.image_encoder))
    return state, frozen



def _sharded(module: nn.Module, shards: Optional[FsdpShards]
             ) -> Optional[ShardedModule]:
    if shards is None:
        return None
    return next(m for m in shards.modules() if m.module is module)


def trained_tensors(module: nn.Module, shards: Optional[FsdpShards] = None
                    ) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of what the optimizer updates for each of
    ``module``'s parameters: the parameter, or under FSDP the rank's
    slice of a sharded one."""
    sm = _sharded(module, shards)
    if sm is None:
        return list(module.named_parameters())
    return list(zip(sm.names, sm.owned))


def _full(module: nn.Module, shards: Optional[FsdpShards],
          tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``tensors`` (by parameter name, a sharded one's as this rank's
    slice) at full size. Collective under FSDP."""
    sm = _sharded(module, shards)
    if sm is None:
        return dict(tensors)
    full = sm.gather_tensors({j: tensors[sm.names[j]]
                              for j, _ in sm.sharded()})
    return {name: full.get(j, tensors[name])
            for j, name in enumerate(sm.names)}


def generator_weights(state: TrainState
                      ) -> Tuple[Dict[str, torch.Tensor],
                                 Dict[str, torch.Tensor]]:
    """The generator's and AttrEnhance's full parameters that sampling and
    evaluation take, by name: the EMA copies when G-EMA is on, else the
    live ones. Under FSDP every rank must call it (it gathers)."""
    out = []
    for module, ema in ((state.generator, state.g_ema),
                        (state.attr_enhance, state.attr_ema)):
        src = ema if ema is not None else {
            k: t.detach() for k, t in trained_tensors(module, state.shards)}
        out.append(_full(module, state.shards, src))
    return out[0], out[1]


def _module_state_dict(module: nn.Module, shards: Optional[FsdpShards]
                       ) -> Dict[str, torch.Tensor]:
    sd = module.state_dict()
    sd.update(_full(module, shards, {
        k: t.detach() for k, t in trained_tensors(module, shards)}))
    return sd


def full_state_dict(state: TrainState) -> Dict:
    """The whole train state in the unsharded layout (what
    ``CheckpointManager.save_state`` writes): the modules' state dicts,
    both optimizers' state dicts, the EMA dicts and ``step``. The tensors
    are the state's own where nothing is sharded. Under FSDP every rank
    must call it (it gathers)."""
    sh = state.shards
    ema = {name: (None if e is None else _full(module, sh, e))
           for name, module, e in (("g_ema", state.generator, state.g_ema),
                                   ("attr_ema", state.attr_enhance,
                                    state.attr_ema))}
    if sh is None:
        g_opt = state.g_opt.state_dict()
        d_opts = [o.state_dict() for o in state.d_opts]
    else:
        g_opt = full_optimizer_state(state.g_opt,
                                     (sh.generator, sh.attr_enhance))
        d_opts = [full_optimizer_state(o, (m,))
                  for o, m in zip(state.d_opts, sh.discriminators)]
    return {
        "step": int(state.step),
        "generator": _module_state_dict(state.generator, sh),
        "attr_enhance": _module_state_dict(state.attr_enhance, sh),
        "discriminators": [_module_state_dict(d, sh)
                           for d in state.discriminators],
        "g_opt": g_opt,
        "d_opts": d_opts,
        **ema,
    }


def _load_module(module: nn.Module, shards: Optional[FsdpShards],
                 sd: Dict[str, torch.Tensor]) -> None:
    sm = _sharded(module, shards)
    if sm is None:
        module.load_state_dict(sd)
        return
    sm.materialize()
    try:
        module.load_state_dict(sd)
        sm.reshard()
    finally:
        sm.release()


def _load_ema(ema: Dict[str, torch.Tensor], saved: Dict[str, torch.Tensor],
              module: nn.Module, shards: Optional[FsdpShards],
              what: str) -> None:
    if set(ema) != set(saved):
        raise KeyError(f"{what}: saved keys {sorted(saved)[:4]}... do not "
                       f"match the state's {sorted(ema)[:4]}...")
    sm = _sharded(module, shards)
    shapes = (dict(zip(sm.names, sm.shapes)) if sm is not None
              else {k: tuple(v.shape) for k, v in ema.items()})
    for k, v in saved.items():
        if tuple(v.shape) != shapes[k]:
            raise ValueError(f"{what}[{k}]: saved {tuple(v.shape)}, state "
                             f"{shapes[k]}")
    with torch.no_grad():
        for k, v in saved.items():
            j = None if sm is None else sm.names.index(k)
            if j is not None and sm.dims[j] is not None:
                v = sm.shard(j, v)
            ema[k].copy_(v)


def _load_optimizer(opt: torch.optim.Optimizer, sd: Dict) -> None:
    """``opt.load_state_dict(sd)``, keeping ``opt``'s own ``capturable``
    (torch takes the saved groups' flag): a checkpoint of a capturable
    Adam on a card loads into a CPU process, and the other way round. The
    step counts go where that flag keeps them: on the parameter's device,
    or on the host."""
    flags = [g.get("capturable", False) for g in opt.param_groups]
    opt.load_state_dict(sd)
    for g, flag in zip(opt.param_groups, flags):
        g["capturable"] = flag
        for p in g["params"]:
            st = opt.state.get(p)
            if st and "step" in st:
                st["step"] = st["step"].to(
                    device=p.device if flag else "cpu", dtype=torch.float32)


def load_full_state_dict(state: TrainState, saved: Dict) -> None:
    """Load a :func:`full_state_dict` (the unsharded layout) into
    ``state``, in place, whatever its mesh: under FSDP each rank keeps its
    slices (no collectives). A state dict without EMA seeds the state's
    EMA from the loaded parameters; a saved EMA that the state lacks
    raises, as do mismatched modules, optimizers and EMA dicts."""
    sh = state.shards
    if len(saved["discriminators"]) != len(state.discriminators):
        raise ValueError(f"checkpoint has {len(saved['discriminators'])} "
                         f"discriminators, the state "
                         f"{len(state.discriminators)}")
    seed_ema = state.g_ema is not None and saved["g_ema"] is None
    if state.g_ema is None and saved["g_ema"] is not None:
        raise KeyError("checkpoint holds an EMA but TRAIN.G_EMA_DECAY "
                       "is off")
    pairs = ((state.generator, state.g_ema, "g_ema"),
             (state.attr_enhance, state.attr_ema, "attr_ema"))
    if state.g_ema is not None and not seed_ema:
        for module, ema, name in pairs:
            _load_ema(ema, saved[name], module, sh, name)
    _load_module(state.generator, sh, saved["generator"])
    _load_module(state.attr_enhance, sh, saved["attr_enhance"])
    for d, sd in zip(state.discriminators, saved["discriminators"]):
        _load_module(d, sh, sd)
    if sh is None:
        _load_optimizer(state.g_opt, saved["g_opt"])
        for opt, sd in zip(state.d_opts, saved["d_opts"]):
            _load_optimizer(opt, sd)
    else:
        _load_optimizer(state.g_opt, shard_optimizer_state(
            saved["g_opt"], (sh.generator, sh.attr_enhance)))
        for opt, m, sd in zip(state.d_opts, sh.discriminators,
                              saved["d_opts"]):
            _load_optimizer(opt, shard_optimizer_state(sd, (m,)))
    if seed_ema:
        with torch.no_grad():
            for module, ema, _ in pairs:
                for name, t in trained_tensors(module, sh):
                    ema[name].copy_(t)
    state.step = int(saved["step"])
