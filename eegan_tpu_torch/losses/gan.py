"""Adversarial losses: hinge, mismatch, class BCE and MAGP (counterpart of
``eegan_tpu/losses/gan.py``; reference `train.py:336-417`).

Only the arithmetic lives here; the discriminator passes are in the train
step. Every loss is computed in float32 whatever the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def hinge_real(out: torch.Tensor) -> torch.Tensor:
    """relu(1 - D(x)).mean(), the real-pair branch (reference train.py:342)."""
    return torch.relu(1.0 - out.float()).mean()


def hinge_fake(out: torch.Tensor) -> torch.Tensor:
    """relu(1 + D(x)).mean(), the fake and mismatched-pair branches."""
    return torch.relu(1.0 + out.float()).mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """torch F.binary_cross_entropy_with_logits (mean), in the JAX
    package's form: max(x, 0) - x*t + log1p(exp(-|x|))."""
    x = logits.float()
    loss = torch.clamp_min(x, 0.0) - x * targets + torch.log1p(
        torch.exp(-x.abs()))
    return loss.mean()


def d_hinge_total(err_real: torch.Tensor, err_fake: torch.Tensor,
                  err_unpair: torch.Tensor) -> torch.Tensor:
    """real + (fake + unpair) / 2 (reference train.py:450)."""
    return err_real + (err_fake + err_unpair) / 2.0


def magp_from_grads(grad_img: torch.Tensor, grad_sent: torch.Tensor
                    ) -> torch.Tensor:
    """Matching-aware gradient penalty from the input gradients (reference
    `MA_gradient_penalty`, train.py:378-402): the per-sample L2 norm of the
    flattened (image, sentence) gradients, 2 * mean(norm^6)."""
    b = grad_img.shape[0]
    g = torch.cat([grad_img.reshape(b, -1).float(),
                   grad_sent.reshape(b, -1).float()], dim=1)
    norm = torch.sqrt(torch.sum(g ** 2, dim=1))
    return 2.0 * torch.mean(norm ** 6)


def one_hot_class_labels(class_ids: torch.Tensor, class_num: int
                         ) -> torch.Tensor:
    """One-hot float32 targets of the 1-based class ids (reference
    prepare_class_labels, train.py:99-103). An id outside [1, class_num]
    gives a zero row, as ``jax.nn.one_hot`` does."""
    idx = class_ids.long() - 1
    valid = (idx >= 0) & (idx < class_num)
    out = F.one_hot(torch.where(valid, idx, 0), class_num).float()
    return out * valid[:, None]
