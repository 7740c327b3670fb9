"""Inception-v3 trunk in torchvision's module and key layout (counterpart of
``eegan_tpu/models/inception.py``).

``torchvision`` is not a dependency, so the tree is written out here with
torchvision's names (``Conv2d_1a_3x3``, ``Mixed_5b``..``Mixed_7c``,
``conv``/``bn`` inside ``BasicConv2d``, the branch names): a torchvision or
AttnGAN state dict loads with ``load_state_dict``. Convs run in
``compute_dtype``; batch norm (eps 1e-3) and its output are in the
parameters' dtype (float32, as the JAX package's
``nn.BatchNorm(dtype=float32)``; float64 after ``factory.to_float64_``).

``forward(x)`` takes NCHW input (channels_last memory) already resized to
299x299 and returns the taps ``mixed_6e`` (B, 768, 17, 17) and ``pool3``
(B, 2048), float32, plus ``logits`` when ``num_classes > 0``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from eegan_tpu_torch.models.layers import Conv2d, Linear


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode moves the running variance
    towards the biased batch variance, as flax's ``BatchNorm`` (the JAX
    package's Inception) does; torch's own takes the unbiased one. Eval
    mode, and the normalisation in train mode, are torch's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class BasicConv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1,
                 padding=0, compute_dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                           padding=padding, compute_dtype=compute_dtype)
        self.bn = BatchNorm2d(out_ch, eps=0.001)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x).to(self.bn.weight.dtype)))


def max_pool3_s2(x):
    return F.max_pool2d(x, kernel_size=3, stride=2)


def avg_pool3_s1_p1(x):
    """3x3 average pool, stride 1, padding 1, the padded cells not counted;
    computed in the NCHW layout and returned in x's. In channels_last
    memory, PyTorch's CUDA backward of a padded ``avg_pool2d`` gets the
    input gradient about 100% wrong (torch 2.11, PERF.md §6), which put
    the trunk's gradients (the DAMSM encoder's, and the image gradient of
    the G phase) 2.7% off on the card."""
    fmt = (torch.channels_last
           if x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    y = F.avg_pool2d(x.contiguous(), kernel_size=3, stride=1, padding=1,
                     count_include_pad=False)
    return y.contiguous(memory_format=fmt)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int, dt=torch.float32):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1, compute_dtype=dt)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1, compute_dtype=dt)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2, compute_dtype=dt)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1, compute_dtype=dt)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1,
                                          compute_dtype=dt)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1,
                                          compute_dtype=dt)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1,
                                       compute_dtype=dt)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool3_s1_p1(x))
        return torch.cat([b1, b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int, dt=torch.float32):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2, compute_dtype=dt)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1, compute_dtype=dt)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1,
                                          compute_dtype=dt)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2,
                                          compute_dtype=dt)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, max_pool3_s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int, dt=torch.float32):
        super().__init__()
        c7 = channels_7x7
        row, col = dict(padding=(0, 3)), dict(padding=(3, 0))
        self.branch1x1 = BasicConv2d(in_ch, 192, 1, compute_dtype=dt)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1, compute_dtype=dt)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), **row, compute_dtype=dt)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), **col,
                                       compute_dtype=dt)
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1, compute_dtype=dt)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), **col,
                                          compute_dtype=dt)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), **row,
                                          compute_dtype=dt)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), **col,
                                          compute_dtype=dt)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), **row,
                                          compute_dtype=dt)
        self.branch_pool = BasicConv2d(in_ch, 192, 1, compute_dtype=dt)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(avg_pool3_s1_p1(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int, dt=torch.float32):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1, compute_dtype=dt)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2, compute_dtype=dt)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1, compute_dtype=dt)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3),
                                         compute_dtype=dt)
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0),
                                         compute_dtype=dt)
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2,
                                         compute_dtype=dt)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, max_pool3_s2(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, dt=torch.float32):
        super().__init__()
        row, col = dict(padding=(0, 1)), dict(padding=(1, 0))
        self.branch1x1 = BasicConv2d(in_ch, 320, 1, compute_dtype=dt)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1, compute_dtype=dt)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), **row,
                                        compute_dtype=dt)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), **col,
                                        compute_dtype=dt)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1, compute_dtype=dt)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1,
                                          compute_dtype=dt)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), **row,
                                           compute_dtype=dt)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), **col,
                                           compute_dtype=dt)
        self.branch_pool = BasicConv2d(in_ch, 192, 1, compute_dtype=dt)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = self.branch_pool(avg_pool3_s1_p1(x))
        return torch.cat([b1, b3, bd, bp], 1)


class InceptionV3(nn.Module):
    """The trunk with named taps (torchvision ``inception_v3`` without the
    auxiliary head)."""

    def __init__(self, num_classes: int = 1000, compute_dtype=torch.float32):
        super().__init__()
        dt = self.compute_dtype = compute_dtype
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2, compute_dtype=dt)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, compute_dtype=dt)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1,
                                         compute_dtype=dt)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, compute_dtype=dt)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, compute_dtype=dt)
        self.Mixed_5b = InceptionA(192, 32, dt)
        self.Mixed_5c = InceptionA(256, 64, dt)
        self.Mixed_5d = InceptionA(288, 64, dt)
        self.Mixed_6a = InceptionB(288, dt)
        self.Mixed_6b = InceptionC(768, 128, dt)
        self.Mixed_6c = InceptionC(768, 160, dt)
        self.Mixed_6d = InceptionC(768, 160, dt)
        self.Mixed_6e = InceptionC(768, 192, dt)
        self.Mixed_7a = InceptionD(768, dt)
        self.Mixed_7b = InceptionE(1280, dt)
        self.Mixed_7c = InceptionE(2048, dt)
        self.fc = (Linear(2048, num_classes, compute_dtype=dt)
                   if num_classes > 0 else None)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = max_pool3_s2(x)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = max_pool3_s2(x)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e"):
            x = getattr(self, f"Mixed_{name}")(x)
        mixed_6e = x
        for name in ("7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        pool3 = x.mean(dim=(2, 3))  # the global 8x8 average pool
        out = {"mixed_6e": mixed_6e, "pool3": pool3}
        if self.fc is not None:
            out["logits"] = self.fc(pool3).float()
        return out
