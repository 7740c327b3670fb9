"""Plain PyTorch reference of EE-GAN's networks, in float32.

Written from the published model (upstream EE-GAN ``code/models.py``:
``Gen``, ``SAGB_Block``, ``affine_ssa``, ``Cum_Block``, ``ATTR_Enhance``,
``resD``, ``DiscSent``, ``DiscCond``, ``Dis64/128/256``; AttnGAN's
``RNN_ENCODER`` and ``CNN_ENCODER`` on torchvision's Inception-v3), with
the parameter names of those modules, so one state dict loads into this
reference and into the program under test alike. It imports nothing of
the program: the benchmark hands both sides the same weights and inputs.

Departures from a naive transcription, each the same mathematics:

* the discriminators' convolutions, leaky ReLUs and 2x2 average pools use
  autograd functions whose second derivative is built from first-order
  operations (:class:`TwiceDifferentiableConv`, :func:`leaky_relu_mask`,
  :func:`avg_pool_2x`), and a forward recorded under
  :func:`input_grads_only` computes no weight gradient in its backward.
  PyTorch's own double backward of those operations sends gradients of
  zeros through every convolution of the tower; the operation count of
  the step (``benchmark/opcount.py``) would count that waste as work.
* the 256 -> 299 resize of the image encoder is a bilinear resize with
  half-pixel centres, antialiased when shrinking, written as two
  interpolation matmuls.

``quant`` (None for the reference) rounds the operands of every
convolution and linear layer of the trained networks and the image
encoder, and the gradients that flow back through them: the control of
the correctness check runs the reference in a precision below the
bfloat16 that the configurations state: float8 (:func:`fp8_round`).
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def _to_fp8(t: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / largest
    return (t / scale).to(dtype).to(t.dtype) * scale


class _GradFp8(torch.autograd.Function):
    """A gradient rounded to float8 e5m2 (one scale per tensor); its own
    derivative is taken as 1."""

    @staticmethod
    def forward(ctx, g):
        return _to_fp8(g, torch.float8_e5m2, 57344.0)

    @staticmethod
    def backward(ctx, gg):
        return gg


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _to_fp8(t, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _GradFp8.apply(g)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per tensor, as fp8
    training scales by the tensor's largest magnitude; the gradient that
    flows back through it is rounded to float8 e5m2, as fp8 training
    keeps gradients."""
    return _Fp8.apply(t)


def _q(quant: Quant, t: torch.Tensor) -> torch.Tensor:
    return t if quant is None else quant(t)


# --- operations with a first-order second derivative -------------------

_recording = threading.local()


@contextlib.contextmanager
def input_grads_only():
    """Convolutions recorded within it differentiate by their input only
    (read when the forward runs: autograd may run the backward on a
    thread of its own)."""
    prev = getattr(_recording, "input_only", False)
    _recording.input_only = True
    try:
        yield
    finally:
        _recording.input_only = prev


class TwiceDifferentiableConv(torch.autograd.Function):
    """``F.conv2d`` whose backward is ``conv_transpose2d`` (input) and
    ``convolution_backward`` (weight, bias), which autograd differentiates
    again."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.geometry = (stride, padding, b is not None)
        ctx.input_only = getattr(_recording, "input_only", False)
        return F.conv2d(x, w, b, stride, padding)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding, has_bias = ctx.geometry
        need = ctx.needs_input_grad
        dx = dw = db = None
        if need[0]:
            extra = tuple(x.shape[2 + i] - ((dy.shape[2 + i] - 1) * stride[i]
                                            - 2 * padding[i] + w.shape[2 + i])
                          for i in range(2))
            dx = F.conv_transpose2d(dy, w, None, stride, padding, extra)
        if (need[1] or need[2]) and not ctx.input_only:
            _, dw, db = torch.ops.aten.convolution_backward(
                dy, x, w, [w.shape[0]] if has_bias else None, stride,
                padding, (1, 1), False, (0, 0), 1,
                [False, need[1], need[2] and has_bias])
        return dx, dw, db, None, None


class _SignMaskLeakyReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope: float):
        ctx.slope = slope
        ctx.save_for_backward(x > 0)
        return F.leaky_relu(x, slope)

    @staticmethod
    def backward(ctx, dy):
        (positive,) = ctx.saved_tensors
        return torch.where(positive, dy, dy * ctx.slope), None


def leaky_relu_mask(x, slope: float = 0.2):
    if torch.is_grad_enabled() and x.requires_grad:
        return _SignMaskLeakyReLU.apply(x, slope)
    return F.leaky_relu(x, slope)


class _AvgPool2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.avg_pool2d(x, 2, 2)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return torch.ops.aten.avg_pool2d_backward(
            dy, x.detach(), [2, 2], [2, 2], [0, 0], False, True, None)


def avg_pool_2x(x):
    if torch.is_grad_enabled() and x.requires_grad:
        return _AvgPool2x.apply(x)
    return F.avg_pool2d(x, 2, 2)


# --- layers ------------------------------------------------------------


class Conv(nn.Conv2d):
    """'same' padding unless given; no bias unless asked; ``twice`` takes
    :class:`TwiceDifferentiableConv` when recording a gradient."""

    def __init__(self, cin, cout, k, bias=False, stride=1, padding=None,
                 quant: Quant = None, twice=False):
        ks = (k, k) if isinstance(k, int) else k
        if padding is None:
            padding = tuple(n // 2 for n in ks)
        super().__init__(cin, cout, ks, stride=stride, padding=padding,
                         bias=bias)
        self.quant = quant
        self.twice = twice

    def forward(self, x):
        x, w = _q(self.quant, x), _q(self.quant, self.weight)
        if self.twice and torch.is_grad_enabled():
            return TwiceDifferentiableConv.apply(x, w, self.bias, self.stride,
                                                 self.padding)
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


class Lin(nn.Linear):
    def __init__(self, fin, fout, bias=True, quant: Quant = None):
        super().__init__(fin, fout, bias=bias)
        self.quant = quant

    def forward(self, x):
        return F.linear(_q(self.quant, x), _q(self.quant, self.weight),
                        self.bias)


class BN(nn.BatchNorm2d):
    """Batch norm; in train mode it normalises by the batch's mean and
    biased variance (the running statistics are not moved: nothing the
    check compares reads them)."""

    def __init__(self, n, affine=True, eps=1e-5):
        super().__init__(n, eps=eps, affine=affine)

    def forward(self, x):
        if self.training:
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, self.eps)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def up2(x):
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


# --- generator ---------------------------------------------------------


class AffineMLP(nn.Module):
    def __init__(self, cond_dim, hidden, features, quant):
        super().__init__()
        self.linear1 = Lin(cond_dim, hidden, quant=quant)
        self.linear2 = Lin(hidden, features, quant=quant)

    def forward(self, c):
        return self.linear2(F.relu(self.linear1(c)))


class AffineSSA(nn.Module):
    """(gamma * mask + 1) * BN(x) + beta * mask."""

    def __init__(self, features, cond_dim, quant):
        super().__init__()
        self.norm2d = BN(features, affine=False)
        self.fc_gamma = AffineMLP(cond_dim, 256, features, quant)
        self.fc_beta = AffineMLP(cond_dim, 256, features, quant)

    def forward(self, x, cond, mask):
        g = self.fc_gamma(cond)[:, :, None, None]
        b = self.fc_beta(cond)[:, :, None, None]
        return (g * mask + 1.0) * self.norm2d(x) + b * mask


def mask_head(cin, quant):
    return nn.Sequential(Conv(cin, 100, 3, quant=quant), BN(100), nn.ReLU(),
                         Conv(100, 1, 1, quant=quant))


class SAGBBlock(nn.Module):
    def __init__(self, cin, cout, cond_dim, pred_mask, up, quant):
        super().__init__()
        self.up = up
        self.affine1 = AffineSSA(cin, cond_dim, quant)
        self.c1 = Conv(cin, cout, 3, quant=quant)
        self.affine2 = AffineSSA(cout, cond_dim, quant)
        self.c2 = Conv(cout, cout, 3, quant=quant)
        self.c_sc = Conv(cin, cout, 1, bias=True, quant=quant) \
            if cin != cout else None
        self.gamma = nn.Parameter(torch.zeros(1))
        self.conv_mask = mask_head(cout, quant) if pred_mask else None

    def forward(self, x, c1, c2, mask_logits):
        if self.up:
            x = up2(x)
        hw = tuple(x.shape[2:])
        if tuple(mask_logits.shape[2:]) != hw:
            mask_logits = F.interpolate(mask_logits, size=hw,
                                        mode="bilinear", align_corners=True)
        mask = torch.sigmoid(mask_logits)
        h = self.c1(F.relu(self.affine1(x, c1, mask)))
        h = self.c2(F.relu(self.affine2(h, c2, mask)))
        sc = x if self.c_sc is None else self.c_sc(x)
        out = sc + self.gamma * h
        return out, None if self.conv_mask is None else self.conv_mask(out)


class CumBlock(nn.Module):
    def __init__(self, prev_ch, cur_ch, quant):
        super().__init__()
        self.up_block = nn.Sequential(Conv(prev_ch, cur_ch, 1, quant=quant),
                                      nn.Upsample(scale_factor=2.0,
                                                  mode="nearest"),
                                      Conv(cur_ch, cur_ch, 3, quant=quant))
        self.gamma = nn.Parameter(torch.zeros(1))
        self.fuse_block = Conv(cur_ch, cur_ch, 3, quant=quant)

    def forward(self, prev, cur):
        return self.fuse_block(self.up_block(prev) + cur * self.gamma)


def to_image(cin, quant):
    return nn.Sequential(BN(cin), nn.LeakyReLU(0.2), Conv(cin, 3, 3,
                                                          quant=quant),
                         nn.Tanh())


class Generator(nn.Module):
    """[img64, img128, img256], NHWC in [-1, 1]."""

    def __init__(self, ngf, nz, cond_dim, quant: Quant = None):
        super().__init__()
        self.ngf = ngf
        chans = [ngf * 8] * 4 + [ngf * 4, ngf * 2, ngf]
        self.fc = Lin(nz, ngf * 8 * 16, quant=quant)
        self.init_mask = mask_head(ngf * 8, quant)
        blocks, cin = [], ngf * 8
        for i, cout in enumerate(chans):
            blocks.append(SAGBBlock(cin, cout, cond_dim, i != 6, i > 0,
                                    quant))
            cin = cout
        self.blocks = nn.ModuleList(blocks)
        self.cum_64 = CumBlock(ngf * 8, ngf * 4, quant)
        self.cum_128 = CumBlock(ngf * 4, ngf * 2, quant)
        self.cum_256 = CumBlock(ngf * 2, ngf, quant)
        self.get_image_64 = to_image(ngf * 4, quant)
        self.get_image_128 = to_image(ngf * 2, quant)
        self.get_image_256 = to_image(ngf, quant)

    def forward(self, z, sent, attrs) -> List[torch.Tensor]:
        out = self.fc(z).view(z.shape[0], self.ngf * 8, 4, 4)
        mask = self.init_mask(out)
        for i in range(4):
            out, mask = self.blocks[i](out, sent, sent, mask)
        x32, feats = out, []
        for i in range(4, 7):
            out, new = self.blocks[i](out, sent, attrs, mask)
            mask = mask if new is None else new
            feats.append(out)
        c64 = self.cum_64(x32, feats[0])
        c128 = self.cum_128(c64, feats[1])
        c256 = self.cum_256(c128, feats[2])
        return [im.permute(0, 2, 3, 1) for im in (
            self.get_image_64(c64), self.get_image_128(c128),
            self.get_image_256(c256))]


class AttrEnhance(nn.Module):
    """Self-attention over [sentence, attributes]; the 1/sqrt(d) scale
    after the softmax, as upstream."""

    def __init__(self, ntf, quant: Quant = None):
        super().__init__()
        self.ntf = ntf
        self.attr_query = Lin(ntf, ntf, quant=quant)
        self.attr_key = Lin(ntf, ntf, quant=quant)
        self.attr_value = Lin(ntf, ntf, quant=quant)

    def forward(self, sent, attrs):
        x = torch.cat([sent[:, None], attrs], 1)
        q, k, v = self.attr_query(x), self.attr_key(x), self.attr_value(x)
        attn = torch.softmax(q @ k.transpose(1, 2), -1) / math.sqrt(self.ntf)
        out = attn @ v
        return out[:, 0], out.sum(1)  # (attended sentence, merged)


# --- discriminators ----------------------------------------------------


class ResDown(nn.Module):
    def __init__(self, fin, fout, quant):
        super().__init__()
        self.conv_r = nn.Sequential(
            Conv(fin, fout, 4, stride=2, padding=1, quant=quant, twice=True),
            nn.Identity(),
            Conv(fout, fout, 3, quant=quant, twice=True), nn.Identity())
        self.conv_s = Conv(fin, fout, 1, bias=True, quant=quant, twice=True) \
            if fin != fout else None
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        h = leaky_relu_mask(self.conv_r[0](x))
        h = leaky_relu_mask(self.conv_r[2](h))
        sc = x if self.conv_s is None else self.conv_s(x)
        return avg_pool_2x(sc) + self.gamma * h


def _tile(feat, cond):
    b, _, h, w = feat.shape
    return torch.cat([feat, cond[:, :, None, None].expand(b, -1, h, w)], 1)


class DiscSent(nn.Module):
    def __init__(self, ndf, nef, quant):
        super().__init__()
        self.joint_conv = nn.Sequential(
            Conv(ndf + nef, ndf * 2, 3, quant=quant, twice=True),
            nn.Identity(),
            Conv(ndf * 2, 1, 4, padding=0, quant=quant, twice=True))

    def forward(self, feat, cond):
        h = leaky_relu_mask(self.joint_conv[0](_tile(feat, cond)))
        return self.joint_conv[2](h).reshape(feat.shape[0])


class DiscCond(nn.Module):
    def __init__(self, ndf, class_nums, nef, quant):
        super().__init__()
        self.ndf = ndf
        self.joinConv = nn.Sequential(
            Conv(ndf + nef, ndf * 2, 3, quant=quant, twice=True),
            nn.Identity())
        self.pair_node = Conv(ndf * 2, 1, 4, bias=True, stride=4, padding=0,
                              quant=quant, twice=True)
        self.class_node = Conv(ndf * 2, ndf * 2, 4, bias=True, stride=4,
                               padding=0, quant=quant, twice=True)
        self.class_linear = Lin(ndf * 2, class_nums, quant=quant)

    def joint(self, feat, cond):
        return leaky_relu_mask(self.joinConv[0](_tile(feat, cond)))

    def forward(self, feat, cond):
        x = self.joint(feat, cond)
        b = feat.shape[0]
        cls = self.class_linear(self.class_node(x).reshape(b, self.ndf * 2))
        return self.pair_node(x).reshape(b), cls

    def pair_logit(self, feat, cond):
        return self.pair_node(self.joint(feat, cond)).reshape(feat.shape[0])


LADDER = {64: [2, 4, 8, 8], 128: [2, 4, 8, 8, 16],
          256: [2, 4, 8, 16, 16, 16]}


def channel_ladder(ndf, scale):
    return [ndf * m for m in LADDER[scale]]


class Discriminator(nn.Module):
    def __init__(self, ndf, scale, disc_class, class_nums, nef,
                 quant: Quant = None):
        super().__init__()
        ladder = channel_ladder(ndf, scale)
        self.n_blocks = len(ladder)
        self.conv_img = Conv(3, ndf, 3, bias=True, quant=quant, twice=True)
        fin = ndf
        for i, ch in enumerate(ladder):
            self.add_module(f"block{i}", ResDown(fin, ch, quant))
            fin = ch
        self.disc_class = disc_class
        self.COND_DNET = (DiscCond(fin, class_nums, nef, quant) if disc_class
                          else DiscSent(fin, nef, quant))

    def features(self, img):
        x = self.conv_img(img.permute(0, 3, 1, 2))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        return x

    def head(self, feat, cond):
        return self.COND_DNET(feat, cond)


# --- frozen encoders ---------------------------------------------------


class TextEncoder(nn.Module):
    """Bidirectional LSTM over captions of given lengths: words (B, T, D),
    zero at padded steps, and the final states (B, D) (torch's packed
    ``nn.LSTM``: each direction runs over a caption's valid steps only,
    the backward one from its last word). Written out step by step over
    the rows still running, the parameters in ``rnn``'s layout."""

    def __init__(self, ntoken, ninput=300, nhidden=256):
        super().__init__()
        self.encoder = nn.Embedding(ntoken, ninput)
        self.rnn = nn.LSTM(ninput, nhidden // 2, 1, batch_first=True,
                           bidirectional=True)

    def _direction(self, x, running, suffix):
        """x (B, T, I) sorted by length, longest first; running[t] rows
        still run at step t. Returns outputs (B, T, H), final h (B, H)."""
        w_ih = getattr(self.rnn, f"weight_ih_l0{suffix}")
        w_hh = getattr(self.rnn, f"weight_hh_l0{suffix}")
        bias = getattr(self.rnn, f"bias_ih_l0{suffix}") + getattr(
            self.rnn, f"bias_hh_l0{suffix}")
        b, t, _ = x.shape
        hid = w_hh.shape[1]
        h = x.new_zeros(b, hid)
        c = x.new_zeros(b, hid)
        outs = [None] * t
        order = range(t - 1, -1, -1) if suffix else range(t)
        for step in order:
            n = running[step]
            gates = x[:n, step] @ w_ih.T + h[:n] @ w_hh.T + bias
            i, f, g, o = gates.chunk(4, 1)
            c_n = torch.sigmoid(f) * c[:n] + torch.sigmoid(i) * torch.tanh(g)
            h_n = torch.sigmoid(o) * torch.tanh(c_n)
            c = torch.cat([c_n, c[n:]])
            h = torch.cat([h_n, h[n:]])
            outs[step] = torch.cat([h_n, x.new_zeros(b - n, hid)])
        return torch.stack(outs, 1), h

    def forward(self, caps, lens):
        b, t = caps.shape
        lens = lens.to("cpu", torch.int64)
        order = torch.argsort(-lens, stable=True)
        undo = torch.argsort(order)
        sorted_lens = lens[order].tolist()
        running = [sum(1 for n in sorted_lens if n > s) for s in range(t)]
        x = self.encoder(caps.long())[order.to(caps.device)]
        wf, hf = self._direction(x, running, "")
        wb, hb = self._direction(x, running, "_reverse")
        undo = undo.to(caps.device)
        return torch.cat([wf, wb], 2)[undo], torch.cat([hf, hb], 1)[undo]


class BasicConv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, quant=None):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride=stride, padding=padding,
                         quant=quant)
        self.bn = BN(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _pool3(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class _Branches(nn.Module):
    """An Inception block from a table of branches; ``pool`` says what the
    input's pooled branch is."""

    def __init__(self, spec, quant):
        super().__init__()
        for name, args, kw in spec:
            self.add_module(name, BasicConv(*args, quant=quant, **kw))

    def c(self, name, x):
        return getattr(self, name)(x)


class InceptionA(_Branches):
    def __init__(self, cin, pool_features, quant):
        super().__init__([
            ("branch1x1", (cin, 64, 1), {}),
            ("branch5x5_1", (cin, 48, 1), {}),
            ("branch5x5_2", (48, 64, 5), dict(padding=2)),
            ("branch3x3dbl_1", (cin, 64, 1), {}),
            ("branch3x3dbl_2", (64, 96, 3), dict(padding=1)),
            ("branch3x3dbl_3", (96, 96, 3), dict(padding=1)),
            ("branch_pool", (cin, pool_features, 1), {})], quant)

    def forward(self, x):
        c = self.c
        return torch.cat([
            c("branch1x1", x), c("branch5x5_2", c("branch5x5_1", x)),
            c("branch3x3dbl_3", c("branch3x3dbl_2", c("branch3x3dbl_1", x))),
            c("branch_pool", _pool3(x))], 1)


class InceptionB(_Branches):
    def __init__(self, cin, quant):
        super().__init__([
            ("branch3x3", (cin, 384, 3), dict(stride=2)),
            ("branch3x3dbl_1", (cin, 64, 1), {}),
            ("branch3x3dbl_2", (64, 96, 3), dict(padding=1)),
            ("branch3x3dbl_3", (96, 96, 3), dict(stride=2))], quant)

    def forward(self, x):
        c = self.c
        return torch.cat([
            c("branch3x3", x),
            c("branch3x3dbl_3", c("branch3x3dbl_2", c("branch3x3dbl_1", x))),
            F.max_pool2d(x, 3, 2)], 1)


class InceptionC(_Branches):
    def __init__(self, cin, c7, quant):
        row, col = dict(padding=(0, 3)), dict(padding=(3, 0))
        super().__init__([
            ("branch1x1", (cin, 192, 1), {}),
            ("branch7x7_1", (cin, c7, 1), {}),
            ("branch7x7_2", (c7, c7, (1, 7)), row),
            ("branch7x7_3", (c7, 192, (7, 1)), col),
            ("branch7x7dbl_1", (cin, c7, 1), {}),
            ("branch7x7dbl_2", (c7, c7, (7, 1)), col),
            ("branch7x7dbl_3", (c7, c7, (1, 7)), row),
            ("branch7x7dbl_4", (c7, c7, (7, 1)), col),
            ("branch7x7dbl_5", (c7, 192, (1, 7)), row),
            ("branch_pool", (cin, 192, 1), {})], quant)

    def forward(self, x):
        c = self.c
        bd = c("branch7x7dbl_1", x)
        for i in range(2, 6):
            bd = c(f"branch7x7dbl_{i}", bd)
        return torch.cat([
            c("branch1x1", x),
            c("branch7x7_3", c("branch7x7_2", c("branch7x7_1", x))), bd,
            c("branch_pool", _pool3(x))], 1)


class InceptionD(_Branches):
    def __init__(self, cin, quant):
        super().__init__([
            ("branch3x3_1", (cin, 192, 1), {}),
            ("branch3x3_2", (192, 320, 3), dict(stride=2)),
            ("branch7x7x3_1", (cin, 192, 1), {}),
            ("branch7x7x3_2", (192, 192, (1, 7)), dict(padding=(0, 3))),
            ("branch7x7x3_3", (192, 192, (7, 1)), dict(padding=(3, 0))),
            ("branch7x7x3_4", (192, 192, 3), dict(stride=2))], quant)

    def forward(self, x):
        c = self.c
        b7 = c("branch7x7x3_1", x)
        for i in range(2, 5):
            b7 = c(f"branch7x7x3_{i}", b7)
        return torch.cat([c("branch3x3_2", c("branch3x3_1", x)), b7,
                          F.max_pool2d(x, 3, 2)], 1)


class InceptionE(_Branches):
    def __init__(self, cin, quant):
        row, col = dict(padding=(0, 1)), dict(padding=(1, 0))
        super().__init__([
            ("branch1x1", (cin, 320, 1), {}),
            ("branch3x3_1", (cin, 384, 1), {}),
            ("branch3x3_2a", (384, 384, (1, 3)), row),
            ("branch3x3_2b", (384, 384, (3, 1)), col),
            ("branch3x3dbl_1", (cin, 448, 1), {}),
            ("branch3x3dbl_2", (448, 384, 3), dict(padding=1)),
            ("branch3x3dbl_3a", (384, 384, (1, 3)), row),
            ("branch3x3dbl_3b", (384, 384, (3, 1)), col),
            ("branch_pool", (cin, 192, 1), {})], quant)

    def forward(self, x):
        c = self.c
        b3 = c("branch3x3_1", x)
        bd = c("branch3x3dbl_2", c("branch3x3dbl_1", x))
        return torch.cat([
            c("branch1x1", x),
            c("branch3x3_2a", b3), c("branch3x3_2b", b3),
            c("branch3x3dbl_3a", bd), c("branch3x3dbl_3b", bd),
            c("branch_pool", _pool3(x))], 1)


@functools.lru_cache(maxsize=None)
def _resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of a bilinear resize with half-pixel centres,
    the triangle kernel widened by src/dst when shrinking, rows summing
    to 1."""
    inv = np.float32(src / dst)
    width = max(inv, np.float32(1.0))
    sample = (np.arange(dst, dtype=np.float32) + 0.5) * inv - 0.5
    dist = np.abs(sample[None, :] - np.arange(src, dtype=np.float32)[:, None])
    w = np.maximum(0.0, 1.0 - dist / width).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, 0).T
                                .astype(np.float32))


def resize_299(x):
    h, w = x.shape[2:]
    ah = torch.from_numpy(_resize_matrix(h, 299)).to(x.device, x.dtype)
    aw = torch.from_numpy(_resize_matrix(w, 299)).to(x.device, x.dtype)
    return torch.einsum("Ww,bchw->bchW", aw, torch.einsum(
        "Hh,bchw->bcHw", ah, x))


class ImageEncoder(nn.Module):
    """Inception-v3 to Mixed_6e (regions, through ``emb_features``) and
    Mixed_7c's average (the code, through ``emb_cnn_code``); batch norms
    in eval mode. Returns regions (B, 17, 17, nef) and the code (B, nef)."""

    def __init__(self, nef=256, quant: Quant = None):
        super().__init__()
        q = quant
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2, quant=q)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3, quant=q)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1, quant=q)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1, quant=q)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3, quant=q)
        self.Mixed_5b = InceptionA(192, 32, q)
        self.Mixed_5c = InceptionA(256, 64, q)
        self.Mixed_5d = InceptionA(288, 64, q)
        self.Mixed_6a = InceptionB(288, q)
        self.Mixed_6b = InceptionC(768, 128, q)
        self.Mixed_6c = InceptionC(768, 160, q)
        self.Mixed_6d = InceptionC(768, 160, q)
        self.Mixed_6e = InceptionC(768, 192, q)
        self.Mixed_7a = InceptionD(768, q)
        self.Mixed_7b = InceptionE(1280, q)
        self.Mixed_7c = InceptionE(2048, q)
        self.emb_features = Conv(768, nef, 1, quant=q)
        self.emb_cnn_code = Lin(2048, nef, quant=q)

    def forward(self, img):
        x = resize_299(img.permute(0, 3, 1, 2))
        for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
            x = getattr(self, name)(x)
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e"):
            x = getattr(self, f"Mixed_{name}")(x)
        region = self.emb_features(x)
        for name in ("7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        code = self.emb_cnn_code(x.mean(dim=(2, 3)))
        return region.permute(0, 2, 3, 1), code


# --- the model, from a configuration file's "model" group --------------


def imsizes(model: Dict) -> List[int]:
    tree = model["TREE"]
    return [tree["BASE_SIZE"] * 2 ** i for i in range(tree["BRANCH_NUM"])]


def build(model: Dict, n_words: int, device, quant: Quant = None,
          parts=("generator", "attr_enhance", "discriminators",
                 "text_encoder", "image_encoder")) -> Dict[str, nn.Module]:
    """The named networks of a configuration, in float32 on ``device``.
    The discriminators come as ``disc0`` .. ``disc{n-1}``."""
    gan, text, train = model["GAN"], model["TEXT"], model["TRAIN"]
    emb = text["EMBEDDING_DIM"]
    out: Dict[str, nn.Module] = {}
    with torch.device(device):
        if "generator" in parts:
            out["generator"] = Generator(gan["GF_DIM"], gan["Z_DIM"], emb,
                                         quant)
        if "attr_enhance" in parts:
            out["attr_enhance"] = AttrEnhance(emb, quant)
        if "discriminators" in parts:
            scales = imsizes(model)
            for i, s in enumerate(scales):
                out[f"disc{i}"] = Discriminator(
                    gan["DF_DIM"], s, train["USE_CLASS"]
                    and i == len(scales) - 1, train["CLASS_NUM"], emb, quant)
        if "text_encoder" in parts:
            out["text_encoder"] = TextEncoder(n_words, 300, emb)
        if "image_encoder" in parts:
            out["image_encoder"] = ImageEncoder(emb, quant)
    return out
