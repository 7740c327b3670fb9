"""Per-scale conditional patch discriminators (counterpart of
``eegan_tpu/models/discriminator.py``; reference `resD`, `DiscSent`,
`DiscCond`, `Dis64/128/256`, `models.py:262-403`).

Each tower takes the image to a 4x4 feature map through residual down
blocks (avg-pool shortcut, learned zero-init residual gate). The head
concatenates the tiled sentence embedding and gives one hinge logit per
sample, plus class logits at 256² when USE_CLASS is on. No spectral norm
and no batch norm, as in the reference.

``features`` and ``head`` are separate methods: the D loss reuses the real
features for the matched and mismatched conditions (reference
`train.py:340-346`). Images come in NHWC (B, s, s, 3), as the JAX package's;
inside, tensors are NCHW in channels_last memory format. State-dict keys are
the reference's (``block0.conv_r.0.weight``, ``COND_DNET.joint_conv.2
.weight``, ``COND_DNET.joinConv.0.weight``...). With ``remat``
(RUNTIME.REMAT and REMAT_D) each down block runs under
:func:`~eegan_tpu_torch.models.layers.checkpointed`, through the MAGP's
double backward too. RUNTIME.S2D_CONVS (a TPU lane-packing lowering of the
same math) is not ported.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import torch
import torch.nn as nn

from eegan_tpu_torch.models.layers import (
    Conv2d,
    LeakyReLU,
    Linear,
    avg_pool_2x,
    checkpointed,
    conv1x1,
    conv3x3,
    conv4x4_down,
)


class ResDown(nn.Module):
    """Residual down block (reference `resD`, models.py:262-288)."""

    def __init__(self, fin: int, fout: int, downsample: bool = True,
                 compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.downsample = downsample
        self.conv_r = nn.Sequential(
            conv4x4_down(fin, fout, compute_dtype=compute_dtype),
            LeakyReLU(0.2),
            conv3x3(fout, fout, compute_dtype=compute_dtype),
            LeakyReLU(0.2))
        self.conv_s = (conv1x1(fin, fout, bias=True,
                               compute_dtype=compute_dtype)
                       if fin != fout else None)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        h = self.conv_r(x)
        sc = x.to(self.compute_dtype) if self.conv_s is None else self.conv_s(x)
        if self.downsample:
            sc = avg_pool_2x(sc)
        return sc + self.gamma.to(self.compute_dtype) * h


def _tile_cond(feat, cond):
    b, _, h, w = feat.shape
    cond = cond.to(feat.dtype)[:, :, None, None].expand(b, cond.shape[-1],
                                                         h, w)
    return torch.cat([feat, cond], dim=1)


class DiscSent(nn.Module):
    """Sentence-conditional logit head (reference `DiscSent`,
    models.py:290-306): feat ++ tiled sent -> conv3x3 -> lrelu -> conv4x4
    VALID -> (B,) logit."""

    def __init__(self, ndf: int, nef: int = 256, compute_dtype=torch.float32):
        super().__init__()
        self.joint_conv = nn.Sequential(
            conv3x3(ndf + nef, ndf * 2, compute_dtype=compute_dtype),
            LeakyReLU(0.2),
            Conv2d(ndf * 2, 1, 4, compute_dtype=compute_dtype, padding=0))

    def forward(self, feat, cond):
        return self.joint_conv(_tile_cond(feat, cond)).reshape(feat.shape[0])


class DiscCond(nn.Module):
    """Pair + class-logit head at 256² (reference `DiscCond`,
    models.py:308-338). The reference's pair_node has stride 4; on the 4x4
    input a VALID 4x4 kernel gives one output position at any stride
    (``eegan_tpu/models/discriminator.py:111-117``)."""

    def __init__(self, ndf: int, class_nums: int = 200, nef: int = 256,
                 compute_dtype=torch.float32):
        super().__init__()
        self.ndf = ndf
        dt = compute_dtype
        self.joinConv = nn.Sequential(
            conv3x3(ndf + nef, ndf * 2, compute_dtype=dt), LeakyReLU(0.2))
        self.pair_node = Conv2d(ndf * 2, 1, 4, bias=True, compute_dtype=dt,
                                stride=4, padding=0)
        self.class_node = Conv2d(ndf * 2, ndf * 2, 4, bias=True,
                                 compute_dtype=dt, stride=4, padding=0)
        self.class_linear = Linear(ndf * 2, class_nums, compute_dtype=dt)

    def forward(self, feat, cond) -> Tuple[torch.Tensor, torch.Tensor]:
        b = feat.shape[0]
        x = self.joinConv(_tile_cond(feat, cond))
        pair = self.pair_node(x).reshape(b)
        cls = self.class_node(x).reshape(b, self.ndf * 2)
        return pair, self.class_linear(cls)

    def pair_logit(self, feat, cond):
        """The pair logit alone, without the class logits (the MAGP)."""
        x = self.joinConv(_tile_cond(feat, cond))
        return self.pair_node(x).reshape(feat.shape[0])


def channel_ladder(ndf: int, scale: int) -> List[int]:
    if scale == 64:
        return [ndf * 2, ndf * 4, ndf * 8, ndf * 8]
    if scale == 128:
        return [ndf * 2, ndf * 4, ndf * 8, ndf * 8, ndf * 16]
    if scale == 256:
        return [ndf * 2, ndf * 4, ndf * 8, ndf * 16, ndf * 16, ndf * 16]
    raise ValueError(f"unsupported discriminator scale {scale}")


class Discriminator(nn.Module):
    """One per-scale tower (reference `Dis64/128/256`, models.py:340-403)."""

    def __init__(self, ndf: int, scale: int, disc_class: bool = False,
                 class_nums: int = 200, nef: int = 256,
                 compute_dtype=torch.float32, remat: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat = remat
        ladder = channel_ladder(ndf, scale)
        self.conv_img = conv3x3(3, ndf, bias=True, compute_dtype=compute_dtype)
        fin = ndf
        self.n_blocks = len(ladder)
        for i, ch in enumerate(ladder):
            self.add_module(f"block{i}", ResDown(fin, ch,
                                                 compute_dtype=compute_dtype))
            fin = ch
        self.COND_DNET = (DiscCond(ladder[-1], class_nums, nef, compute_dtype)
                          if disc_class else
                          DiscSent(ladder[-1], nef, compute_dtype))
        # The MAGP differentiates the input gradient by the weights.
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.twice_differentiable = True

    def features(self, x):
        """x: (B, s, s, 3) NHWC -> (B, C, 4, 4) features (channels_last)."""
        x = self.conv_img(x.permute(0, 3, 1, 2))
        for i in range(self.n_blocks):
            block = getattr(self, f"block{i}")
            x = checkpointed(block, x) if self.remat else block(x)
        return x

    def head(self, feat, cond) -> Union[torch.Tensor,
                                        Tuple[torch.Tensor, torch.Tensor]]:
        return self.COND_DNET(feat, cond)

    def forward(self, x, cond):
        return self.head(self.features(x), cond)
