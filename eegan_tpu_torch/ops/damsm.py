"""Fused DAMSM word-region similarity (counterpart of
``eegan_tpu/ops/damsm_pallas.py``).

For each (image, text) pair, the attention of the text's words over the
image's regions (the reference's double softmax), the attended context, the
word/context cosines and their log-sum-exp: the (B_img, B_txt) grid that the
words loss contrasts (reference hot spot `miscc/DAMSM_losses.py:272-342`).

* :func:`words_similarity_fused` gives the grid, unscaled by gamma3. For
  CUDA tensors it is :class:`WordsSimilarity`: the forward is the kernel
  ``damsm_words_fwd`` and the backward ``damsm_words_bwd_dr`` (the regions'
  gradient) and ``damsm_words_bwd_dw`` (the words' gradient), each launched
  only when its input needs a gradient; all three in
  ``csrc/damsm_words.cu``. For CPU tensors it is the plain version
  :func:`words_similarity_reference`, and autograd of it is the plain
  backward.
* :func:`words_loss_fused` ports ``words_loss_pallas``: the bidirectional
  contrastive CE over that grid, a drop-in for ``losses.damsm.words_loss``.
* ``words_similarity_forward.launches``, ``words_similarity_backward_dr
  .launches`` and ``words_similarity_backward_dw.launches`` count launches.

Everything is float32: regions (Bi, S, D) or (Bi, 17, 17, D), words
(Bt, L, D), cap_lens (Bt,) integers.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from eegan_tpu_torch.losses.damsm import (
    NEG_INF,
    cross_entropy_int,
    same_class_mask,
    word_region_log_sims,
)
from eegan_tpu_torch.ops import _build

_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use (Hopper)


def words_similarity_reference(regions, words, cap_lens, gamma1: float = 5.0,
                               gamma2: float = 5.0) -> torch.Tensor:
    """Plain PyTorch version of the three kernels' function: the
    (Bi, Bt) log-similarity grid, unscaled, unmasked."""
    return word_region_log_sims(regions, words, cap_lens, gamma1, gamma2)


def _lib():
    lib = _build.load("damsm_words")
    if lib.eegan_damsm_words_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.eegan_damsm_words_fwd.argtypes = [p] * 4 + [i] * 5 + [f, f, p]
        for name in ("eegan_damsm_words_bwd_dr", "eegan_damsm_words_bwd_dw"):
            getattr(lib, name).argtypes = [p] * 5 + [i] * 5 + [f, f, p]
        lib.eegan_damsm_words_smem_bytes.argtypes = [i] * 4
        lib.eegan_damsm_words_smem_bytes.restype = ctypes.c_longlong
        for name in ("eegan_damsm_words_fwd", "eegan_damsm_words_bwd_dr",
                     "eegan_damsm_words_bwd_dw"):
            getattr(lib, name).restype = ctypes.c_int
    return lib


def _prepare(regions, words, cap_lens):
    """Checks and the kernels' operand forms: contiguous float32 regions
    (Bi, S, D) and words (Bt, L, D), int32 lengths on the device."""
    if regions.device.type != "cuda":
        raise ValueError(f"the DAMSM kernels take CUDA tensors, got "
                         f"{regions.device} (words_similarity_fused takes the "
                         "plain version on the CPU)")
    if regions.dim() == 4:
        b, h, w, d = regions.shape
        regions = regions.reshape(b, h * w, d)
    if regions.dim() != 3 or words.dim() != 3:
        raise ValueError(f"regions (Bi, S, D) and words (Bt, L, D) expected, "
                         f"got {tuple(regions.shape)} and {tuple(words.shape)}")
    Bi, S, D = regions.shape
    Bt, L, Dw = words.shape
    if Dw != D or tuple(cap_lens.shape) != (Bt,):
        raise ValueError(f"shapes regions {tuple(regions.shape)}, words "
                         f"{tuple(words.shape)}, cap_lens "
                         f"{tuple(cap_lens.shape)} do not agree")
    for name, t in (("regions", regions), ("words", words)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != regions.device:
            raise ValueError(f"{name} is on {t.device}, regions on "
                             f"{regions.device}")
    if D % 4 or D > 256 or L > 32 or min(Bi, Bt, S, L) == 0:
        raise ValueError(f"the DAMSM kernels take D % 4 == 0, D <= 256, "
                         f"0 < L <= 32; got S={S}, L={L}, D={D}")
    lib = _lib()
    for kind in (0, 1):
        need = lib.eegan_damsm_words_smem_bytes(kind, S, L, D)
        if need > _SMEM_LIMIT:
            raise ValueError(f"S={S}, L={L}, D={D} needs {need} bytes of "
                             f"shared memory per block (limit {_SMEM_LIMIT})")
    lens = cap_lens.to(regions.device, torch.int32).contiguous()
    return (regions.contiguous(), words.contiguous(), lens,
            (Bi, Bt, S, L, D), lib)


def _check_err(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def words_similarity_forward(regions, words, cap_lens, gamma1: float = 5.0,
                             gamma2: float = 5.0) -> torch.Tensor:
    """Kernel 3: the (Bi, Bt) log-similarity grid. CUDA tensors only."""
    r, w, lens, (Bi, Bt, S, L, D), lib = _prepare(regions, words, cap_lens)
    sims = torch.empty((Bi, Bt), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        err = lib.eegan_damsm_words_fwd(
            r.data_ptr(), w.data_ptr(), lens.data_ptr(), sims.data_ptr(),
            Bi, Bt, S, L, D, float(gamma1), float(gamma2),
            torch.cuda.current_stream(r.device).cuda_stream)
    _check_err(err, "damsm_words_fwd")
    words_similarity_forward.launches += 1
    return sims


def _backward(kind: str, regions, words, cap_lens, dsim, gamma1, gamma2):
    r, w, lens, (Bi, Bt, S, L, D), lib = _prepare(regions, words, cap_lens)
    if tuple(dsim.shape) != (Bi, Bt):
        raise ValueError(f"dsim has shape {tuple(dsim.shape)}, expected "
                         f"{(Bi, Bt)}")
    g = dsim.to(r.device, torch.float32).contiguous()
    out = torch.empty(r.shape if kind == "dr" else w.shape,
                      dtype=torch.float32, device=r.device)
    fn = getattr(lib, f"eegan_damsm_words_bwd_{kind}")
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), w.data_ptr(), lens.data_ptr(), g.data_ptr(),
                 out.data_ptr(), Bi, Bt, S, L, D, float(gamma1),
                 float(gamma2), torch.cuda.current_stream(r.device).cuda_stream)
    _check_err(err, f"damsm_words_bwd_{kind}")
    return out


def words_similarity_backward_dr(regions, words, cap_lens, dsim,
                                 gamma1: float = 5.0, gamma2: float = 5.0):
    """Kernel 4: the regions' gradient (Bi, S, D) from dsim (Bi, Bt)."""
    out = _backward("dr", regions, words, cap_lens, dsim, gamma1, gamma2)
    words_similarity_backward_dr.launches += 1
    return out


def words_similarity_backward_dw(regions, words, cap_lens, dsim,
                                 gamma1: float = 5.0, gamma2: float = 5.0):
    """Kernel 5: the words' gradient (Bt, L, D) from dsim (Bi, Bt); exactly
    zero at padded words."""
    out = _backward("dw", regions, words, cap_lens, dsim, gamma1, gamma2)
    words_similarity_backward_dw.launches += 1
    return out


words_similarity_forward.launches = 0
words_similarity_backward_dr.launches = 0
words_similarity_backward_dw.launches = 0


class WordsSimilarity(torch.autograd.Function):
    """The port of ``words_similarity_fused_vjp`` (damsm_pallas.py:372-398):
    kernel 3 forward; kernels 4 and 5 backward, each only when its input
    needs a gradient. Nothing but the inputs is saved."""

    @staticmethod
    def forward(ctx, regions, words, cap_lens, gamma1, gamma2):
        ctx.gammas = (gamma1, gamma2)
        ctx.save_for_backward(regions, words, cap_lens)
        return words_similarity_forward(regions, words, cap_lens, gamma1,
                                        gamma2)

    @staticmethod
    def backward(ctx, dsim):
        regions, words, cap_lens = ctx.saved_tensors
        d_regions = d_words = None
        if ctx.needs_input_grad[0]:
            d_regions = words_similarity_backward_dr(
                regions, words, cap_lens, dsim, *ctx.gammas).reshape(
                    regions.shape)
        if ctx.needs_input_grad[1]:
            d_words = words_similarity_backward_dw(
                regions, words, cap_lens, dsim, *ctx.gammas)
        return d_regions, d_words, None, None, None


def words_similarity_fused(regions, words, cap_lens, gamma1: float = 5.0,
                           gamma2: float = 5.0) -> torch.Tensor:
    """The (Bi, Bt) word-region log-similarity (unscaled by gamma3),
    differentiable in regions and words. CPU tensors take the plain
    version; CUDA tensors launch the kernels."""
    if regions.device.type == "cpu":
        return words_similarity_reference(regions, words, cap_lens, gamma1,
                                          gamma2)
    if regions.device.type != "cuda":
        raise ValueError(f"no kernel for device {regions.device}")
    return WordsSimilarity.apply(regions, words, cap_lens, gamma1, gamma2)


def words_loss_fused(region_features, words_emb, cap_lens,
                     class_ids: Optional[torch.Tensor] = None,
                     gamma1: float = 5.0, gamma2: float = 5.0,
                     gamma3: float = 10.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``losses.damsm.words_loss`` backed by the fused
    similarity (the port of ``words_loss_pallas``, damsm_pallas.py:401-419)."""
    sims = words_similarity_fused(region_features, words_emb, cap_lens,
                                  gamma1, gamma2) * gamma3
    if class_ids is not None:
        sims = sims.masked_fill(same_class_mask(class_ids.to(sims.device)),
                                NEG_INF)
    labels = torch.arange(sims.shape[0], device=sims.device)
    return cross_entropy_int(sims, labels), cross_entropy_int(sims.T, labels)
