"""Train state and optimizers (counterpart of ``eegan_tpu/training/state.py``).

The reference keeps one Adam over G ∪ AttrEnhance (lr 1e-4) and one Adam per
discriminator (lr 4e-4), betas (0.0, 0.9) (reference `train.py:252-263`).
torch's Adam computes optax.adam's update, lr * m̂ / (sqrt(v̂) + eps), with
the same bias corrections. The JAX state is an immutable pytree that the
step returns anew; here the modules and optimizers are updated in place
(no second copy of the parameters), and the step returns the same state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn as nn

from eegan_tpu_torch.config import Config
from eegan_tpu_torch.models.factory import ModelBundle


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
    g_ema: Optional[Dict[str, torch.Tensor]] = None
    attr_ema: Optional[Dict[str, torch.Tensor]] = None


def generator_params(state_or_models) -> List[nn.Parameter]:
    """The parameters the G step trains: the generator's, then
    AttrEnhance's."""
    return (list(state_or_models.generator.parameters())
            + list(state_or_models.attr_enhance.parameters()))


def make_optimizers(config: Config, models
                    ) -> Tuple[torch.optim.Optimizer,
                               Tuple[torch.optim.Optimizer, ...]]:
    """Adam(GENERATOR_LR) over G ∪ AttrEnhance and Adam(DISCRIMINATOR_LR)
    for each discriminator, betas (B1, B2), eps 1e-8. TRAIN.D_GRAD_CLIP is
    applied by the step (:func:`clip_by_global_norm_`) before each D
    update, as the JAX package's ``optax.chain`` does."""
    t = config.TRAIN

    def adam(params, lr):
        return torch.optim.Adam(params, lr=lr, betas=(t.B1, t.B2), eps=1e-8)

    g_opt = adam(generator_params(models), t.GENERATOR_LR)
    d_opts = tuple(adam(d.parameters(), t.DISCRIMINATOR_LR)
                   for d in models.discriminators)
    return g_opt, d_opts


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[nn.Parameter], max_norm: float
                         ) -> torch.Tensor:
    """Scale the gradients in place so their global L2 norm is at most
    ``max_norm`` (``optax.clip_by_global_norm``: untouched below the bound,
    g * max_norm / norm at or above it). Returns the norm before clipping.
    No host synchronisation."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def _freeze(module: nn.Module) -> nn.Module:
    module.eval()
    module.requires_grad_(False)
    return module


def create_train_state(config: Config, models: ModelBundle
                       ) -> Tuple[TrainState, FrozenEncoders]:
    """The state over ``models``' trainable modules (their current
    weights), fresh optimizers, the EMA copies, and the frozen encoders."""
    g_opt, d_opts = make_optimizers(config, models)
    use_ema = config.TRAIN.G_EMA_DECAY > 0

    def copy(module):
        return {k: p.detach().clone() for k, p in module.named_parameters()}

    state = TrainState(
        step=0,
        generator=models.generator,
        attr_enhance=models.attr_enhance,
        discriminators=tuple(models.discriminators),
        g_opt=g_opt,
        d_opts=d_opts,
        g_ema=copy(models.generator) if use_ema else None,
        attr_ema=copy(models.attr_enhance) if use_ema else None,
    )
    frozen = FrozenEncoders(text_encoder=_freeze(models.text_encoder),
                            image_encoder=_freeze(models.image_encoder))
    return state, frozen

