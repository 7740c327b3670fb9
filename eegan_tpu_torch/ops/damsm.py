"""Fused DAMSM word-region similarity (counterpart of
``eegan_tpu/ops/damsm_pallas.py``).

For each (image, text) pair, the attention of the text's words over the
image's regions (the reference's double softmax), the attended context, the
word/context cosines and their log-sum-exp: the (B_img, B_txt) grid that the
words loss contrasts (reference hot spot `miscc/DAMSM_losses.py:272-342`).

* :func:`words_similarity_fused` gives the grid, unscaled by gamma3. For
  CUDA tensors it is :class:`WordsSimilarity`: the forward is the kernel
  ``damsm_words_fwd`` and the backward ``damsm_dr_pair`` + ``damsm_dr_sum``
  (the regions' gradient) and ``damsm_dw_pair`` + ``damsm_dw_sum`` (the
  words' gradient), each launched only when its input needs a gradient;
  all in ``csrc/damsm_words.cu``. For CPU tensors it is the plain version
  :func:`words_similarity_reference`, and autograd of it is the plain
  backward.
* :func:`words_loss_fused` ports ``words_loss_pallas``: the bidirectional
  contrastive CE over that grid, a drop-in for ``losses.damsm.words_loss``.
* ``words_similarity_forward.launches``, ``words_similarity_backward_dr
  .launches`` and ``words_similarity_backward_dw.launches`` count launches.
  Under a running profiler the entry is the span
  ``eegan.ops.words_similarity.fwd`` (either path) and each gradient of
  the backward ``eegan.ops.words_similarity.bwd_dr`` / ``.bwd_dw``, so the
  trace puts the device's work here whatever kernel does it.
* :func:`fwd_launch_plan`, :func:`dr_launch_plan` and
  :func:`dw_launch_plan` are the kernels' launch plans and shared-memory
  layouts, plain Python that the CPU tests reach; the C side only checks
  that a plan covers its layout.

Everything is float32: regions (Bi, S, D) or (Bi, 17, 17, D), words
(Bt, L, D), cap_lens (Bt,) integers.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from eegan_tpu_torch.losses.damsm import (
    contrastive_losses,
    word_region_log_sims,
)
from eegan_tpu_torch.ops import _build
from eegan_tpu_torch.training.logging import span

_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use (Hopper)
_SM_SMEM = 228 * 1024  # shared memory of one SM (Hopper)
_THREADS = 256
_SUM_TILE = (64, 64)  # damsm_dr_sum's (S, D) output tile
_DW_TILE = 64  # damsm_dw_sum's columns of D per block (kDwTile)
_DW_CHUNK = 64  # damsm_dw_sum's regions per shared-memory stage (kDwChunk)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _word_rows(L: int) -> Tuple[int, int]:
    """(LT, LP) of the pair kernels: LT = L rounded up to 4, the rows of the
    (LT, D + 4) word and context tiles; LP, the row stride of the (S, LP)
    grids. A stride of 4 mod 8 floats spreads a grid column over 8 banks
    (dR's copy-out reads grids column-wise)."""
    LT = _round_up(L, 4)
    return LT, LT if LT % 8 == 4 else LT + 4


def _pair_smem(S: int, L: int, D: int, grids: int, stats: int = 4) -> int:
    """Dynamic shared memory of a pair block (the forward, pass 1 of dR
    and dW): the (LT, D + 4) words and contexts, ``grids`` (S, LP) grids,
    256 partials and ``stats`` 32-float per-word statistics, float32."""
    LT, LP = _word_rows(L)
    return 4 * (2 * LT * (D + 4) + grids * S * LP + _THREADS + stats * 32)


def _check_shape(what: str, Bi: int, Bt: int, S: int, L: int, D: int):
    if min(Bi, Bt, S, L, D) <= 0 or L > 32 or D % 4 or D > _THREADS:
        raise ValueError(f"{what} takes 0 < L <= 32, D % 4 == 0, 0 < D <= "
                         f"{_THREADS}; got Bi={Bi}, Bt={Bt}, S={S}, L={L}, "
                         f"D={D}")
    if Bi > 65535:
        raise ValueError(f"{what} takes at most 65535 images, got {Bi}")


def _blocks_per_sm(smem: int) -> int:
    """Blocks of a DAMSM kernel that fit on an SM: its dynamic shared
    memory (1 KB reserved per block) and ``__launch_bounds__(256, 2)``,
    which caps the registers at two blocks' worth and promises no more."""
    return min(2, _SM_SMEM // (smem + 1024))


def fwd_launch_plan(Bi: int, Bt: int, S: int, L: int, D: int) -> dict:
    """The launch of kernel 3 (the DAMSM forward) at these shapes.

    ``damsm_words_fwd``: one block of 256 threads per (text, image) pair,
    grid (Bt, Bi), over the text's valid words only. Its shared memory
    holds the words and contexts (LT, D + 4), one (S, LP) grid (attn1, then
    attn2 in place), 256 partials and four 32-float per-word statistics:
    64.7 KB at the train shape, so that at least two blocks share an SM.
    Raises ValueError for shapes the kernel does not take.
    """
    _check_shape("the DAMSM forward", Bi, Bt, S, L, D)
    smem = _pair_smem(S, L, D, 1)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"the DAMSM forward needs {smem} bytes of shared "
                         f"memory at S={S}, L={L}, D={D} (limit "
                         f"{_SMEM_LIMIT})")
    return dict(threads=_THREADS, LP=_word_rows(L)[1], grid=(Bt, Bi),
                blocks=Bt * Bi, smem_bytes=smem,
                blocks_per_sm=_blocks_per_sm(smem))


def dr_launch_plan(Bi: int, Bt: int, S: int, L: int, D: int) -> dict:
    """The two launches of kernel 4 (dR) at these shapes.

    Pass 1, ``damsm_dr_pair``: one block per (text, image) pair; it writes
    the pair's dA and attn2 (word-major planes of SP floats) and dC (rows of
    D) to a float32 scratch. Pass 2, ``damsm_dr_sum``: one block per image
    and 64 x 64 tile of (S, D) sums the texts in index order (within a
    text the dA W terms of its valid words, then the attn2 dC terms).
    Raises ValueError for shapes the kernels do not take.
    """
    _check_shape("dR", Bi, Bt, S, L, D)
    SP = _round_up(S, 4)
    smem = _pair_smem(S, L, D, 3)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"dR pass 1 needs {smem} bytes of shared memory at "
                         f"S={S}, L={L}, D={D} (limit {_SMEM_LIMIT})")
    sum_grid = (-(-D // _SUM_TILE[1]), -(-S // _SUM_TILE[0]), Bi)
    return dict(
        threads=_THREADS, LP=_word_rows(L)[1], SP=SP,
        pair_grid=(Bt, Bi), pair_blocks=Bt * Bi,
        pair_smem_bytes=smem,
        pair_blocks_per_sm=_blocks_per_sm(smem),
        sum_grid=sum_grid, sum_blocks=sum_grid[0] * sum_grid[1] * Bi,
        scratch_bytes=4 * Bi * Bt * L * (2 * SP + D))


def dw_launch_plan(Bi: int, Bt: int, S: int, L: int, D: int,
                   tile: int = _DW_TILE) -> dict:
    """The two launches of kernel 5 (dW) at these shapes.

    Pass 1, ``damsm_dw_pair``: one block per (text, image) pair, dR's pair
    code with a fifth per-word statistic (|W_l|^2); it writes the pair's
    P = dA + (dcos / den) attn2 (S rows of NQ floats, in a slot of S * LT)
    and kappa = dcos cos / |W|^2 (L floats) to a float32 scratch. Pass 2,
    ``damsm_dw_sum``: one block per text and ``tile`` columns of D sums
    P_i^T R_i over the images in index order, staged in two buffers of 64
    regions, then subtracts (sum_i kappa_i) W_t. ``tile`` is the C side's
    kDwTile (64; 32 only for a copy built with it). Raises ValueError for
    shapes the kernels do not take.
    """
    _check_shape("dW", Bi, Bt, S, L, D)
    if Bt > 65535:
        raise ValueError(f"dW takes at most 65535 texts, got {Bt}")
    if tile not in (32, 64):
        raise ValueError(f"dW pass 2's tile is 32 or 64 columns, got {tile}")
    LT, LP = _word_rows(L)
    smem = _pair_smem(S, L, D, 3, stats=5)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"dW pass 1 needs {smem} bytes of shared memory at "
                         f"S={S}, L={L}, D={D} (limit {_SMEM_LIMIT})")
    # Two stages of P rows and R columns; after the loop the 8 warps'
    # (LT, tile) partial sums in their place.
    sum_smem = 4 * max(2 * _DW_CHUNK * (LT + tile), 8 * LT * tile)
    sum_grid = (-(-D // tile), Bt)
    return dict(
        threads=_THREADS, LP=LP, tile=tile,
        pair_grid=(Bt, Bi), pair_blocks=Bt * Bi, pair_smem_bytes=smem,
        pair_blocks_per_sm=_blocks_per_sm(smem),
        sum_grid=sum_grid, sum_blocks=sum_grid[0] * Bt,
        sum_smem_bytes=sum_smem, sum_blocks_per_sm=_blocks_per_sm(sum_smem),
        scratch_bytes=4 * Bi * Bt * (S * LT + L))


_KERNEL_OPS = {"forward": 4, "dr": 10, "dw": 8}  # x S·D per valid word
_PLAIN_OPS = {"forward": (4, 2), "dr": (6, 2), "dw": (4, 4)}  # (x S·D, x D)


def words_similarity_ops(kind: str, Bi: int, Bt: int, S: int, L: int,
                         D: int, cap_lens=None) -> int:
    """Operations, at 2 per multiply-add, of kernel 3 (``kind``
    "forward"), 4 ("dr") or 5 ("dw") at (Bi, Bt, S, L, D): Bi images of S
    regions against Bt texts of L word slots, D features.

    With ``cap_lens`` (Bt,): the kernels' own work, over the valid words
    only. Per word and (image, text) pair the forward's two products (the
    attention logits and the context) take 4·S·D; pass 1 of dR and of dW
    computes them again, so dR takes 10·S·D and dW 8·S·D. Phase 12's
    bounds divide this.

    Without: the function as its plain version computes it, over all L
    slots of each text (a padded word is computed, then masked) and
    without the passes' recomputation: per slot and pair 4·S·D + 2·D
    (forward, the cosines' dots too), 6·S·D + 2·D (dR) and 4·S·D + 4·D
    (dW). This is the step's count, the same on the CPU, where the plain
    version runs, and on a card (``eegan_tpu_torch/bench.py``)."""
    if cap_lens is not None:
        valid = int(torch.as_tensor(cap_lens).sum())
        return _KERNEL_OPS[kind] * Bi * valid * S * D
    sd, d = _PLAIN_OPS[kind]
    return (sd * S * D + d * D) * Bi * Bt * L


def words_similarity_reference(regions, words, cap_lens, gamma1: float = 5.0,
                               gamma2: float = 5.0) -> torch.Tensor:
    """Plain PyTorch version of the three kernels' function: the
    (Bi, Bt) log-similarity grid, unscaled, unmasked."""
    return word_region_log_sims(regions, words, cap_lens, gamma1, gamma2)


def _lib():
    lib = _build.load("damsm_words")
    if lib.eegan_damsm_words_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        n = ctypes.c_longlong
        lib.eegan_damsm_words_fwd.argtypes = [p] * 4 + [i] * 6 + [n, f, f, p]
        lib.eegan_damsm_words_bwd_dr.argtypes = (
            [p] * 6 + [i] * 7 + [n, f, f, p])
        lib.eegan_damsm_words_bwd_dw.argtypes = (
            [p] * 6 + [i] * 6 + [n, n, i, f, f, p])
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
    lens = cap_lens.to(regions.device, torch.int32).contiguous()
    # The kernels read rows as float4: a view that starts off a 16-byte
    # boundary is copied.
    regions, words = (t if t.data_ptr() % 16 == 0 else t.clone()
                      for t in (regions.contiguous(), words.contiguous()))
    return regions, words, lens, (Bi, Bt, S, L, D), _lib()


def _check_err(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def words_similarity_forward(regions, words, cap_lens, gamma1: float = 5.0,
                             gamma2: float = 5.0) -> torch.Tensor:
    """Kernel 3: the (Bi, Bt) log-similarity grid, in the launch of
    :func:`fwd_launch_plan`. CUDA tensors only."""
    r, w, lens, (Bi, Bt, S, L, D), lib = _prepare(regions, words, cap_lens)
    plan = fwd_launch_plan(Bi, Bt, S, L, D)
    sims = torch.empty((Bi, Bt), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        err = lib.eegan_damsm_words_fwd(
            r.data_ptr(), w.data_ptr(), lens.data_ptr(), sims.data_ptr(),
            Bi, Bt, S, L, D, plan["LP"], plan["smem_bytes"], float(gamma1),
            float(gamma2), torch.cuda.current_stream(r.device).cuda_stream)
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
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        if kind == "dr":
            plan = dr_launch_plan(Bi, Bt, S, L, D)
            scratch = torch.empty(plan["scratch_bytes"] // 4,
                                  dtype=torch.float32, device=r.device)
            err = lib.eegan_damsm_words_bwd_dr(
                r.data_ptr(), w.data_ptr(), lens.data_ptr(), g.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), Bi, Bt, S, L, D,
                plan["LP"], plan["SP"], plan["pair_smem_bytes"],
                float(gamma1), float(gamma2), stream)
        else:
            plan = dw_launch_plan(Bi, Bt, S, L, D)
            scratch = torch.empty(plan["scratch_bytes"] // 4,
                                  dtype=torch.float32, device=r.device)
            err = lib.eegan_damsm_words_bwd_dw(
                r.data_ptr(), w.data_ptr(), lens.data_ptr(), g.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), Bi, Bt, S, L, D,
                plan["LP"], plan["pair_smem_bytes"], plan["sum_smem_bytes"],
                plan["tile"], float(gamma1), float(gamma2), stream)
    _check_err(err, f"damsm_words_bwd_{kind}")
    return out


def words_similarity_backward_dr(regions, words, cap_lens, dsim,
                                 gamma1: float = 5.0, gamma2: float = 5.0):
    """Kernel 4: the regions' gradient (Bi, S, D) from dsim (Bi, Bt), in
    the two launches of :func:`dr_launch_plan` (counted as one)."""
    out = _backward("dr", regions, words, cap_lens, dsim, gamma1, gamma2)
    words_similarity_backward_dr.launches += 1
    return out


def words_similarity_backward_dw(regions, words, cap_lens, dsim,
                                 gamma1: float = 5.0, gamma2: float = 5.0):
    """Kernel 5: the words' gradient (Bt, L, D) from dsim (Bi, Bt), in the
    two launches of :func:`dw_launch_plan` (counted as one); exactly zero
    at padded words."""
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
            with span("ops.words_similarity.bwd_dr"):
                d_regions = words_similarity_backward_dr(
                    regions, words, cap_lens, dsim, *ctx.gammas).reshape(
                        regions.shape)
        if ctx.needs_input_grad[1]:
            with span("ops.words_similarity.bwd_dw"):
                d_words = words_similarity_backward_dw(
                    regions, words, cap_lens, dsim, *ctx.gammas)
        return d_regions, d_words, None, None, None


def words_similarity_fused(regions, words, cap_lens, gamma1: float = 5.0,
                           gamma2: float = 5.0) -> torch.Tensor:
    """The (Bi, Bt) word-region log-similarity (unscaled by gamma3),
    differentiable in regions and words. CPU tensors take the plain
    version; CUDA tensors launch the kernels."""
    with span("ops.words_similarity.fwd"):
        if regions.device.type == "cpu":
            return words_similarity_reference(regions, words, cap_lens,
                                              gamma1, gamma2)
        if regions.device.type != "cuda":
            raise ValueError(f"no kernel for device {regions.device}")
        return WordsSimilarity.apply(regions, words, cap_lens, gamma1,
                                     gamma2)


def words_loss_fused(region_features, words_emb, cap_lens,
                     class_ids: Optional[torch.Tensor] = None,
                     gamma1: float = 5.0, gamma2: float = 5.0,
                     gamma3: float = 10.0, mesh=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``losses.damsm.words_loss`` backed by the fused
    similarity (the port of ``words_loss_pallas``, damsm_pallas.py:401-419).
    Under a ``mesh`` the words are gathered, this rank's regions give its
    rows of the grid (the kernels at (Bi, Bt) = (B / ranks, B)), and the
    rows are gathered before the cross-entropies."""
    if mesh is not None:
        words_emb = mesh.all_gather(words_emb)
        cap_lens = mesh.all_gather(cap_lens.to(words_emb.device))
    sims = words_similarity_fused(region_features, words_emb, cap_lens,
                                  gamma1, gamma2) * gamma3
    return contrastive_losses(sims, class_ids, mesh)
