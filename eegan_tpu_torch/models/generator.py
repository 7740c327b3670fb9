"""Hierarchical explore-then-exploit generator (counterpart of
``eegan_tpu/models/generator.py``; reference `Gen`, `models.py:183-256`).

* z -> fc -> 4x4 x 8*ngf seed (channel-major, as torch's ``view``), then
  seven SAGB blocks with nearest-2x upsampling to 256². Blocks 0-3
  ("explore") condition both affine layers on the sentence embedding;
  blocks 4-6 ("exploit") condition the second affine on the merged
  attribute embedding.
* Every block but the last predicts a mask-logit map that gates the next
  block's affine modulation after an align_corners bilinear resize +
  sigmoid, done inside the next block.
* Three cumulative blocks fuse the 32->64->128->256 ladder and three to-RGB
  heads emit [img64, img128, img256], returned NHWC float32 like the JAX
  package's.

State-dict keys are the reference's (``blocks.{i}.affine1.fc_gamma.linear1
.weight``, ``cum_64.up_block.2.weight``, ``init_mask.1.running_var``...), so
reference ``.pth`` files load with ``load_state_dict``.

``up_fused`` (RUNTIME.FUSED_UPSAMPLE) takes the BN statistics and the 1x1
shortcut before the upsample and runs the Cum blocks' up_conv3 as the
subpixel conv of ``ops/upconv.py``: the same math. ``pallas_affine``
(RUNTIME.PALLAS_AFFINE) runs normalise + upsample + modulate + ReLU through
``ops/affine.affine_mask_relu`` (the CUDA kernels for CUDA tensors, forward
and backward; in train mode the batch statistics come from
``TorchBatchNorm.batch_stats`` with their graph, so dmean and dvar flow back
through them). ``remat`` (RUNTIME.REMAT) runs the chosen SAGB blocks and
the three Cum blocks under :func:`~eegan_tpu_torch.models.layers.checkpointed`
(``remat_blocks``, RUNTIME.REMAT_BLOCKS: a comma list of block indices and
``cum``; empty for all), so their activations are recomputed in the
backward, the affine kernel's forward included. RUNTIME.S2D_CONVS is
ignored.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from eegan_tpu_torch.models.layers import (
    Linear,
    MaskHead,
    ToImage,
    TorchBatchNorm,
    checkpointed,
    conv1x1,
    conv3x3,
    resize_bilinear_align_corners,
    upsample_nearest_2x,
)
from eegan_tpu_torch.ops.affine import affine_mask_relu
from eegan_tpu_torch.ops.upconv import Conv3x3UpFused


class _AffineMLP(nn.Module):
    """linear1 -> ReLU -> linear2 (zero-init), the gamma / beta heads."""

    def __init__(self, cond_dim: int, hidden: int, features: int,
                 compute_dtype):
        super().__init__()
        self.linear1 = Linear(cond_dim, hidden, compute_dtype=compute_dtype)
        self.linear2 = Linear(hidden, features, compute_dtype=compute_dtype,
                              zero_init=True)

    def forward(self, cond):
        return self.linear2(F.relu(self.linear1(cond)))


class AffineSSA(nn.Module):
    """Mask-gated text-conditional affine over BN-normalised features
    (reference `affine_ssa`, `models.py:43-86`):
    ``out = (gamma*mask + 1) * BN(feat) + beta*mask``.

    ``up``: ``feat`` arrives before the nearest-2x upsample; the statistics
    are taken there with ``n_override`` = the upsampled element count.
    ``pallas``: the fused op, whose output is already rectified
    (``fuses_relu``); the caller then applies no ReLU.
    """

    def __init__(self, features: int, cond_dim: int, hidden: int = 256,
                 compute_dtype=torch.float32, up: bool = False,
                 pallas: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.up = up
        self.pallas = pallas
        self.norm2d = TorchBatchNorm(features, affine=False)
        self.fc_gamma = _AffineMLP(cond_dim, hidden, features, compute_dtype)
        self.fc_beta = _AffineMLP(cond_dim, hidden, features, compute_dtype)

    @property
    def fuses_relu(self) -> bool:
        return self.pallas

    def forward(self, feat, cond, mask):
        dt = self.compute_dtype
        b, _, h, w = feat.shape
        n_override = 4 * b * h * w if self.up else None
        if self.pallas:
            mean, var = self.norm2d(feat, n_override=n_override,
                                    return_stats=True)
            return affine_mask_relu(
                feat.contiguous(memory_format=torch.channels_last), mean, var,
                self.fc_gamma(cond), self.fc_beta(cond),
                mask.to(dt).contiguous(), self.up, self.norm2d.eps, dt)

        feat = self.norm2d(feat, n_override=n_override).to(dt)
        if self.up:
            feat = upsample_nearest_2x(feat)
        gamma = self.fc_gamma(cond)[:, :, None, None]
        beta = self.fc_beta(cond)[:, :, None, None]
        mask = mask.to(dt)
        return (gamma * mask + 1.0) * feat + beta * mask


class SAGBBlock(nn.Module):
    """Spatial Affine Generative Block (reference `SAGB_Block`,
    models.py:89-126):

        residual = c2(relu(affine2(c1(relu(affine1(x, cond1, m))), cond2, m)))
        out      = shortcut(x) + gamma * residual
        mask     = MaskHead(out) if pred_mask

    With ``up`` the block upsamples its input itself and resizes the RAW
    mask logits of the previous block to its resolution (+ sigmoid).
    """

    def __init__(self, in_ch: int, out_ch: int, cond_dim: int,
                 pred_mask: bool = True, compute_dtype=torch.float32,
                 up: bool = False, up_fused: bool = False,
                 pallas_affine: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.up = up
        self.fused = up and up_fused
        self.affine1 = AffineSSA(in_ch, cond_dim, compute_dtype=compute_dtype,
                                 up=self.fused, pallas=pallas_affine)
        self.c1 = conv3x3(in_ch, out_ch, compute_dtype=compute_dtype)
        self.affine2 = AffineSSA(out_ch, cond_dim, compute_dtype=compute_dtype,
                                 pallas=pallas_affine)
        self.c2 = conv3x3(out_ch, out_ch, compute_dtype=compute_dtype)
        self.c_sc = (conv1x1(in_ch, out_ch, bias=True,
                             compute_dtype=compute_dtype)
                     if in_ch != out_ch else None)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.conv_mask = (MaskHead(out_ch, compute_dtype=compute_dtype)
                          if pred_mask else None)

    def forward(self, feat, cond1, cond2, mask_logits
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        dt = self.compute_dtype
        if self.up and not self.fused:
            feat = upsample_nearest_2x(feat)
        h, w = feat.shape[2:]
        hi_hw = (2 * h, 2 * w) if self.fused else (h, w)
        mask = torch.sigmoid(resize_bilinear_align_corners(mask_logits, hi_hw))

        x = self.affine1(feat, cond1, mask)
        if not self.affine1.fuses_relu:
            x = F.relu(x)
        x = self.c1(x)
        x = self.affine2(x, cond2, mask)
        if not self.affine2.fuses_relu:
            x = F.relu(x)
        x = self.c2(x)

        # The 1x1 shortcut is per-pixel, so it runs before the upsample.
        sc = feat if self.c_sc is None else self.c_sc(feat)
        if self.fused:
            sc = upsample_nearest_2x(sc.to(dt))
        out = sc + self.gamma.to(dt) * x
        new_mask = None if self.conv_mask is None else self.conv_mask(out)
        return out, new_mask


class CumBlock(nn.Module):
    """Cumulative fusion block (reference `Cum_Block`, models.py:129-143):
    ``fuse_block(up_block(prev) + gamma * cur)``. ``up_block`` is
    conv1x1 -> nearest-2x -> conv3x3, or with ``up_fused`` conv1x1 -> the
    subpixel conv (index 1 is then an Identity, so the keys stay put)."""

    def __init__(self, prev_ch: int, cur_ch: int, compute_dtype=torch.float32,
                 up_fused: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        if up_fused:
            self.up_block = nn.Sequential(
                conv1x1(prev_ch, cur_ch, compute_dtype=compute_dtype),
                nn.Identity(),
                Conv3x3UpFused(cur_ch, cur_ch, compute_dtype=compute_dtype))
        else:
            self.up_block = nn.Sequential(
                conv1x1(prev_ch, cur_ch, compute_dtype=compute_dtype),
                nn.Upsample(scale_factor=2.0, mode="nearest"),
                conv3x3(cur_ch, cur_ch, compute_dtype=compute_dtype))
        self.gamma = nn.Parameter(torch.zeros(1))
        self.fuse_block = conv3x3(cur_ch, cur_ch, compute_dtype=compute_dtype)

    def forward(self, prev_feat, cur_feat):
        fused = (self.up_block(prev_feat)
                 + cur_feat * self.gamma.to(self.compute_dtype))
        return self.fuse_block(fused)


class Generator(nn.Module):
    """Reference `Gen` (models.py:183-256). ``forward(z, sent, attrs)``
    returns [img64, img128, img256], NHWC float32 in [-1, 1]; BN runs in
    train or eval mode as the module is set."""

    def __init__(self, ngf: int = 32, nz: int = 100, cond_dim: int = 256,
                 compute_dtype=torch.float32, up_fused: bool = False,
                 pallas_affine: bool = False, remat: bool = False,
                 remat_blocks: str = ""):
        super().__init__()
        self.ngf = ngf
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.remat_blocks = remat_blocks
        dt = compute_dtype
        chans = [ngf * 8, ngf * 8, ngf * 8, ngf * 8, ngf * 4, ngf * 2, ngf]
        self.fc = Linear(nz, ngf * 8 * 4 * 4, compute_dtype=dt)
        self.init_mask = MaskHead(ngf * 8, compute_dtype=dt)
        blocks = [SAGBBlock(ngf * 8, chans[0], cond_dim, True, dt,
                            pallas_affine=pallas_affine)]
        for ix in range(1, 7):
            blocks.append(SAGBBlock(
                chans[ix - 1], chans[ix], cond_dim, pred_mask=ix != 6,
                compute_dtype=dt, up=True, up_fused=up_fused,
                pallas_affine=pallas_affine))
        self.blocks = nn.ModuleList(blocks)
        self.cum_64 = CumBlock(ngf * 8, ngf * 4, dt, up_fused)
        self.cum_128 = CumBlock(ngf * 4, ngf * 2, dt, up_fused)
        self.cum_256 = CumBlock(ngf * 2, ngf, dt, up_fused)
        self.get_image_64 = ToImage(ngf * 4, compute_dtype=dt)
        self.get_image_128 = ToImage(ngf * 2, compute_dtype=dt)
        self.get_image_256 = ToImage(ngf, compute_dtype=dt)

    def _remat_wanted(self, key) -> bool:
        if not self.remat:
            return False
        if not self.remat_blocks:
            return True
        return str(key) in {t.strip() for t in self.remat_blocks.split(",")}

    def _block(self, ix: int, *args):
        block = self.blocks[ix]
        if self._remat_wanted(ix):
            return checkpointed(block, *args)
        return block(*args)

    def _cum(self, cum: CumBlock, *args):
        return checkpointed(cum, *args) if self._remat_wanted("cum") \
            else cum(*args)

    def forward(self, z, sent, attrs) -> List[torch.Tensor]:
        dt = self.compute_dtype
        b = z.shape[0]
        sent = sent.to(dt)
        attrs = attrs.to(dt)
        # torch's view(B, 8*ngf, 4, 4) is channel-major, as the reference's.
        out = self.fc(z.to(dt)).view(b, self.ngf * 8, 4, 4).contiguous(
            memory_format=torch.channels_last)
        # Blocks take the RAW mask logits (for block0 the resize is the
        # identity: 4x4 logits, 4x4 features).
        stage_mask = self.init_mask(out)
        for ix in range(4):  # explore: 4, 8, 16, 32
            out, stage_mask = self._block(ix, out, sent, sent, stage_mask)
        x_32 = out
        feats = []
        for ix in range(4, 7):  # exploit: 64, 128, 256
            out, new_mask = self._block(ix, out, sent, attrs, stage_mask)
            if new_mask is not None:
                stage_mask = new_mask
            feats.append(out)
        cum_64 = self._cum(self.cum_64, x_32, feats[0])
        cum_128 = self._cum(self.cum_128, cum_64, feats[1])
        cum_256 = self._cum(self.cum_256, cum_128, feats[2])
        imgs = (self.get_image_64(cum_64), self.get_image_128(cum_128),
                self.get_image_256(cum_256))
        return [img.float().permute(0, 2, 3, 1).contiguous() for img in imgs]
