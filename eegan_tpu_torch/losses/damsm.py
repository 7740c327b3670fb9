"""DAMSM sentence and word matching losses (counterpart of
``eegan_tpu/losses/damsm.py``; reference `miscc/DAMSM_losses.py:17-343`).

Batched over the (image, text) grid as in the JAX package. Layout: words
(B, L, D) time-minor, regions (B, S, D) with S = 17*17 (or (B, 17, 17, D)).
Two quirks of the reference are kept on purpose:

* the double softmax of `func_attention`: softmax over words of the raw
  logits, then the *probabilities* times gamma1, softmax over regions
  (reference `DAMSM_losses.py:42-54`);
* the norms are clamped sums of squares, so an all-zero (padded) word gets
  an exactly zero gradient instead of NaN.

These are the plain versions of the DAMSM kernels: ``ops/damsm.py`` calls
:func:`word_region_log_sims` for CPU tensors.

With a ``mesh`` (``parallel/mesh.py``) each rank passes its own rows of the
batch and the losses are still the global batch's, as in the JAX step: the
text side is gathered from every rank, each rank computes its images' rows
of the grid against all texts, and the rows are gathered
(:func:`contrastive_losses`) before the two cross-entropies. The gathers are differentiable, so each rank's inputs get
the gradient of the global loss (as many times over as there are ranks,
which the ranks' gradient average then divides out).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e9


def cross_entropy_int(logits: torch.Tensor, labels: torch.Tensor
                      ) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels
    (torch nn.CrossEntropyLoss)."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return torch.mean(logz - ll)


def same_class_mask(class_ids: torch.Tensor) -> torch.Tensor:
    """mask[i, j] = True where j is a *different* sample of the same class
    (excluded from the contrastive denominator, reference
    `DAMSM_losses.py:237-245`)."""
    eq = class_ids[:, None] == class_ids[None, :]
    return eq & ~torch.eye(class_ids.shape[0], dtype=torch.bool,
                           device=class_ids.device)


def _masked(scores, class_ids):
    if class_ids is None:
        return scores
    return scores.masked_fill(same_class_mask(class_ids.to(scores.device)),
                              NEG_INF)


def contrastive_losses(sims: torch.Tensor,
                       class_ids: Optional[torch.Tensor], mesh=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(image->text, text->image) cross-entropies with diagonal targets over
    the (B_img, B_txt) grid, same-class pairs off the diagonal masked out.
    Under a ``mesh``, ``sims`` holds this rank's image rows against every
    text, and ``class_ids`` this rank's classes: both are gathered first."""
    if mesh is not None:
        sims = mesh.all_gather(sims)
        if class_ids is not None:
            class_ids = mesh.all_gather(class_ids.to(sims.device))
    sims = _masked(sims, class_ids)
    labels = torch.arange(sims.shape[0], device=sims.device)
    return cross_entropy_int(sims, labels), cross_entropy_int(sims.T, labels)


def _cosine_grid(a: torch.Tensor, b: torch.Tensor, gamma3: float,
                 eps: float) -> torch.Tensor:
    scores = a @ b.T
    norms = a.norm(dim=-1, keepdim=True) @ b.norm(dim=-1, keepdim=True).T
    return scores / torch.clamp_min(norms, eps) * gamma3


def sent_loss(cnn_code: torch.Tensor, rnn_code: torch.Tensor,
              class_ids: Optional[torch.Tensor], gamma3: float = 10.0,
              eps: float = 1e-8, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional sentence-image contrastive CE (reference `sent_loss`):
    (image->text, text->image) with diagonal targets. Under a ``mesh``:
    this rank's image codes against the gathered text codes."""
    if mesh is not None:
        rnn_code = mesh.all_gather(rnn_code)
    return contrastive_losses(_cosine_grid(cnn_code, rnn_code, gamma3, eps),
                              class_ids, mesh)


def attend_words_to_regions(words: torch.Tensor, regions: torch.Tensor,
                            word_mask: torch.Tensor, gamma1: float
                            ) -> torch.Tensor:
    """Batched `func_attention` over the (image, text) grid: words
    (Bt, L, D), regions (Bi, S, D), word_mask (Bt, L) -> the weighted
    context (Bi, Bt, L, D) (reference `DAMSM_losses.py:25-63`)."""
    logits = torch.einsum("isd,tld->itsl", regions, words)
    logits = torch.where(word_mask[None, :, None, :] > 0, logits,
                         torch.full_like(logits, NEG_INF))
    attn = torch.softmax(logits, dim=-1)
    # Reference quirk: the probabilities times gamma1, then softmax over s.
    attn = torch.softmax(attn * gamma1, dim=2)
    return torch.einsum("itsl,isd->itld", attn, regions)


def _regions(region_features: torch.Tensor) -> torch.Tensor:
    if region_features.dim() == 4:
        b, h, w, d = region_features.shape
        return region_features.reshape(b, h * w, d)
    return region_features


def word_mask(cap_lens: torch.Tensor, L: int, dtype=torch.float32
              ) -> torch.Tensor:
    steps = torch.arange(L, device=cap_lens.device)
    return (steps[None, :] < cap_lens[:, None]).to(dtype)


def word_region_log_sims(regions: torch.Tensor, words: torch.Tensor,
                         cap_lens: torch.Tensor, gamma1: float = 5.0,
                         gamma2: float = 5.0, eps: float = 1e-8
                         ) -> torch.Tensor:
    """(Bi, Bt) log sum_l mask * exp(gamma2 * cos(w_l, c_l)), not yet
    scaled by gamma3 or class-masked: the function the fused DAMSM kernel
    computes (``eegan_tpu/ops/damsm_pallas.py:225-263``)."""
    regions = _regions(regions)
    mask = word_mask(cap_lens.to(words.device), words.shape[1], words.dtype)
    wei = attend_words_to_regions(words, regions, mask, gamma1)
    dots = torch.einsum("tld,itld->itl", words, wei)
    wn = torch.sqrt(torch.clamp_min(torch.sum(words ** 2, -1), eps * eps))
    cn = torch.sqrt(torch.clamp_min(torch.sum(wei ** 2, -1), eps * eps))
    row_sim = dots / torch.clamp_min(wn[None] * cn, eps)
    row_sim = torch.exp(row_sim * gamma2) * mask[None]
    return torch.log(torch.clamp_min(row_sim.sum(dim=-1), eps))


def words_loss(region_features: torch.Tensor, words_emb: torch.Tensor,
               cap_lens: torch.Tensor, class_ids: Optional[torch.Tensor],
               gamma1: float = 5.0, gamma2: float = 5.0, gamma3: float = 10.0,
               eps: float = 1e-8, mesh=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional word-region contrastive CE (reference `words_loss`).
    Under a ``mesh``: this rank's regions against the gathered words."""
    if mesh is not None:
        words_emb = mesh.all_gather(words_emb)
        cap_lens = mesh.all_gather(cap_lens.to(words_emb.device))
    sims = word_region_log_sims(region_features, words_emb, cap_lens, gamma1,
                                gamma2, eps) * gamma3
    return contrastive_losses(sims, class_ids, mesh)


def words_similarity(region_features: torch.Tensor, words_emb: torch.Tensor,
                     cap_lens: torch.Tensor, class_ids: Optional[torch.Tensor],
                     gamma1: float = 5.0, gamma2: float = 5.0,
                     gamma3: float = 10.0, eps: float = 1e-8) -> torch.Tensor:
    """The masked (B_img, B_txt) words similarity grid (reference
    `words_similarity`, DAMSM_losses.py:168-231)."""
    sims = word_region_log_sims(region_features, words_emb, cap_lens, gamma1,
                                gamma2, eps) * gamma3
    return _masked(sims, class_ids)


def global_attention(query_feat: torch.Tensor, context_key: torch.Tensor,
                     content_value: torch.Tensor,
                     mask: Optional[torch.Tensor] = None):
    """Image-side word attention (reference `GlobalAttentionGeneral`,
    DAMSM_losses.py:65-132). query_feat (B, H, W, D), context_key and
    content_value (B, S, D), mask (B, S) True where a word is ignored.
    Returns (weighted (B, H, W, D), attn (B, H, W, S))."""
    b, h, w, d = query_feat.shape
    q = query_feat.reshape(b, h * w, d)
    logits = torch.einsum("bqd,bsd->bqs", q, context_key)
    if mask is not None:
        logits = logits.masked_fill(mask[:, None, :], NEG_INF)
    attn = torch.softmax(logits, dim=-1)
    weighted = torch.einsum("bqs,bsd->bqd", attn, content_value)
    return weighted.reshape(b, h, w, d), attn.reshape(b, h, w, -1)


def sent_similarity(cnn_code: torch.Tensor, rnn_code: torch.Tensor,
                    gamma3: float = 10.0, eps: float = 1e-8) -> torch.Tensor:
    """The (B_img, B_txt) scaled cosine grid, unmasked (reference
    `sent_similarity`, DAMSM_losses.py:134-166; used by R-precision)."""
    return _cosine_grid(cnn_code, rnn_code, gamma3, eps)
