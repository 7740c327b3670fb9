"""Work and bytes of the program's hand-written kernels, from shapes.

Frozen copies, at git 310df21, of the port's arithmetic:
``eegan_tpu_torch/ops/damsm.py:words_similarity_ops`` (the words
similarity's operations; here only the plain function's count per valid
word, the least these inputs need, without the kernels' recomputation)
and ``chip_smoke.py:affine_launch_shapes`` / ``affine_bytes`` (kernel 1's
launches in one generator forward with FUSED_UPSAMPLE, and the bytes one
launch must move). A roofline share is the least time, the larger of
operations over the peak rate and bytes over the memory's bandwidth,
over the device time the trace gives the kernels.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.harness import H100_FP32_FLOPS, H100_HBM_BYTES_S

REGIONS = 17 * 17  # the image encoder's region grid
# Per valid word and (image, text) pair: (x S·D, x D) operations.
WORDS_OPS = {"forward": (4, 2), "dr": (6, 2)}


def words_ops(kind: str, Bi: int, valid_words: int, S: int, D: int) -> int:
    """Operations (2 per multiply-add) of the words similarity's forward
    or its regions' gradient (``dr``) over ``valid_words`` words of all
    texts, against Bi images: per word and image, the attention logits
    and the context (4·S·D), the cosine's dots (2·D); the gradient the
    same products backwards (6·S·D + 2·D)."""
    sd, d = WORDS_OPS[kind]
    return (sd * S * D + d * D) * Bi * valid_words


def words_bytes(kind: str, Bi: int, Bt: int, S: int, L: int, D: int) -> int:
    """float32 bytes read and written once: regions, words, the (Bi, Bt)
    grid (out, or its gradient in), and for ``dr`` the regions'
    gradient out."""
    base = Bi * S * D + Bt * L * D + Bi * Bt
    return 4 * (base + (Bi * S * D if kind == "dr" else 0))


def words_bound_s(Bi: int, Bt: int, S: int, L: int, D: int,
                  valid_words: int) -> float:
    """Least seconds of one forward and one regions' gradient."""
    return sum(max(words_ops(k, Bi, valid_words, S, D) / H100_FP32_FLOPS,
                   words_bytes(k, Bi, Bt, S, L, D) / H100_HBM_BYTES_S)
               for k in ("forward", "dr"))


def affine_launch_shapes(ngf: int) -> List[Tuple[int, int, int, bool]]:
    """(C, h, w, up) of every kernel 1 launch in one generator forward:
    affine1 of an up block normalises the pre-upsample input and writes
    twice the resolution."""
    chans = [ngf * 8] * 4 + [ngf * 4, ngf * 2, ngf]
    shapes, in_ch, res = [], ngf * 8, 4
    for i, out_ch in enumerate(chans):
        up = i > 0
        shapes.append((in_ch, res, res, up))
        res = 2 * res if up else res
        shapes.append((out_ch, res, res, False))
        in_ch = out_ch
    return shapes


def affine_bytes(B: int, C: int, h: int, w: int, up: bool,
                 elem: int) -> int:
    """One launch reads x (B, C, h, w), the float32 mean and variance
    (C), gamma and beta (B, C) and the mask (B, 1, H, W), and writes
    (B, C, H, W); ``elem`` bytes per element of the compute dtype."""
    H, W = (2 * h, 2 * w) if up else (h, w)
    return (elem * (B * C * h * w + 2 * B * C + B * H * W + B * C * H * W)
            + 4 * 2 * C)


def affine_bound_s(B: int, ngf: int, elem: int) -> float:
    """Least seconds of kernel 1's launches in one generator forward."""
    return sum(affine_bytes(B, C, h, w, up, elem) / H100_HBM_BYTES_S
               for C, h, w, up in affine_launch_shapes(ngf))
