"""Shared building blocks (counterpart of ``eegan_tpu/models/layers.py``).

* Tensors are NCHW in ``torch.channels_last`` memory format: the byte order
  of the JAX package's NHWC arrays, which is what the port's kernels read.
* ``COMPUTE_DTYPE``: parameters stay float32 and are cast to the compute
  dtype at use (:class:`Conv2d`, :class:`Linear`), as flax's ``dtype=`` does.
* :class:`TorchBatchNorm` keeps torch's state-dict layout and semantics
  (biased variance to normalise, unbiased to update the running stats,
  momentum 0.1), computes its statistics in float32 whatever the input
  dtype, and adds the two things stock ``nn.BatchNorm2d`` lacks and the
  generator needs: ``n_override`` and ``return_stats``.
* Weight init follows torch's defaults (kaiming_uniform(a=sqrt(5)), i.e.
  U(+-1/sqrt(fan_in))); biases start at zero, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


class TwiceDifferentiableConv(torch.autograd.Function):
    """``F.conv2d`` whose backward is made of first-order convolutions that
    autograd differentiates again: the input gradient is
    ``conv_transpose2d(dy, w)``, the weight and bias gradients come from
    ``convolution_backward``. For the discriminators' convs, whose input
    gradient the MAGP differentiates by the weights: PyTorch's own double
    backward of conv2d (``_convolution_double_backward``) gives that weight
    gradient wrong for stride 1 with padding in bfloat16 on the CPU (about
    100% off against float64; float32 is right), where this form is within
    bf16's rounding. On the card it also keeps those weight gradients on
    cuDNN's weight-gradient kernels, not on the batch-and-channel-swapped
    convolutions of the native double backward (PERF.md §6).

    A conv recorded under :func:`input_grads_only` computes no weight or
    bias gradient in its backward: ``ctx.needs_input_grad`` is fixed when
    the graph is built and cannot tell that a backward asks only for the
    input's gradient."""

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
            # The rows and columns a strided conv never read, as padding.
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


_recording = threading.local()


@contextlib.contextmanager
def input_grads_only():
    """The :class:`TwiceDifferentiableConv` calls recorded within it
    differentiate by their input only. For a pass whose weight gradients
    nothing reads: the MAGP's D forward (its first backward asks for the
    image and sentence gradients alone, as JAX's ``jax.grad`` by the inputs
    does; the penalty's own backward into the weights goes through the
    ``conv_transpose2d`` of that first backward) and the G phase's D
    forwards (their backward fills the generator's gradients). Read when
    the forward runs, since on a card autograd runs the backward on a
    thread of its own."""
    prev = getattr(_recording, "input_only", False)
    _recording.input_only = True
    try:
        yield
    finally:
        _recording.input_only = prev


class Conv2d(nn.Conv2d):
    """Conv computing in ``compute_dtype``; 'same' padding (k // 2 per
    side) unless ``padding`` is given. With ``twice_differentiable`` set
    (the discriminators' convs), a forward that records a gradient takes
    :class:`TwiceDifferentiableConv`."""

    twice_differentiable = False

    def __init__(self, in_ch: int, out_ch: int, kernel_size,
                 bias: bool = False, compute_dtype=torch.float32,
                 stride=1, padding=None):
        if padding is None:
            ks = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
                  else kernel_size)
            padding = tuple(k // 2 for k in ks)
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.compute_dtype = compute_dtype
        if bias:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.twice_differentiable and torch.is_grad_enabled():
            return TwiceDifferentiableConv.apply(
                x.to(dt), self.weight.to(dt), bias, self.stride,
                self.padding)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias,
                        stride=self.stride, padding=self.padding)


def conv1x1(in_ch: int, out_ch: int, bias: bool = False,
            compute_dtype=torch.float32) -> Conv2d:
    return Conv2d(in_ch, out_ch, 1, bias=bias, compute_dtype=compute_dtype)


def conv3x3(in_ch: int, out_ch: int, bias: bool = False,
            compute_dtype=torch.float32) -> Conv2d:
    return Conv2d(in_ch, out_ch, 3, bias=bias, compute_dtype=compute_dtype)


def conv4x4_down(in_ch: int, out_ch: int, bias: bool = False,
                 compute_dtype=torch.float32) -> Conv2d:
    """4x4 stride-2 conv, padding 1 (reference `models.py:22`)."""
    return Conv2d(in_ch, out_ch, 4, bias=bias, compute_dtype=compute_dtype,
                  stride=2, padding=1)


class Linear(nn.Linear):
    """Dense layer computing in ``compute_dtype``; ``zero_init`` zeroes the
    weight (the last layer of the affine MLPs)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype=torch.float32, zero_init: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype
        if zero_init:
            nn.init.zeros_(self.weight)
        if bias:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class TorchBatchNorm(nn.BatchNorm2d):
    """Batch norm with fp32 statistics, ``n_override`` and ``return_stats``.

    Train mode normalises with the biased batch variance and moves the
    running stats towards the unbiased one, momentum 0.1
    (``eegan_tpu/models/layers.py:124-140``). ``n_override`` is the element
    count for the unbiased factor when the statistics come from a tensor
    that stands in for a larger one (the fused up-path takes them before
    the nearest-2x upsample, where the reference's count is 4x larger).
    ``return_stats=True`` returns ``(mean, var)`` instead of the normalised
    tensor (running stats still updated), for callers that fuse the
    normalise into a kernel. Eval mode uses the running stats.

    With a ``mesh`` of more than one rank (``parallel/mesh.py``), the
    per-channel sum and sum of squares are summed over the ranks (float32,
    through the mesh's differentiable all-reduce), so the statistics and
    ``n`` are the global batch's, as the JAX package computes them over the
    sharded batch; ``n_override`` then counts the local batch and is scaled
    to the global one. While ``recomputing`` is set (:func:`checkpointed`'s
    recompute in the backward) the running stats are left alone: they move
    once per forward.
    """

    mesh = None
    recomputing = False

    def __init__(self, num_features: int, affine: bool = True,
                 eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.1, affine=affine)

    def batch_stats(self, x, n_override: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.training:
            return self.running_mean, self.running_var
        xf = x.float()
        n = n_override if n_override is not None else x.numel() // x.shape[1]
        mesh = self.mesh
        if mesh is not None and mesh.size > 1:
            moments = torch.stack([xf.sum(dim=(0, 2, 3)),
                                   xf.square().sum(dim=(0, 2, 3))])
            moments = mesh.all_reduce_sum(moments)
            count = x.numel() // x.shape[1] * mesh.size
            mean, mean2 = moments[0] / count, moments[1] / count
            n *= mesh.size
        else:
            mean = xf.mean(dim=(0, 2, 3))
            mean2 = xf.square().mean(dim=(0, 2, 3))
        var = (mean2 - mean.square()).clamp_min(0.0)
        if self.recomputing:
            return mean, var
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            self.running_mean.mul_(1.0 - self.momentum).add_(
                self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(
                self.momentum * unbiased)
            self.num_batches_tracked.add_(1)
        return mean, var

    def forward(self, x, n_override: Optional[int] = None,
                return_stats: bool = False):
        mean, var = self.batch_stats(x, n_override)
        if return_stats:
            return mean, var
        y = (x.float() - mean[:, None, None]) * torch.rsqrt(
            var + self.eps)[:, None, None]
        if self.affine:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y


class _Recomputing:
    """Sets ``recomputing`` on a module's batch norms while entered;
    re-enterable, since a double backward (the MAGP) unpacks a checkpoint's
    saved tensors, and so recomputes, more than once."""

    def __init__(self, module: nn.Module):
        self.norms = [m for m in module.modules()
                      if isinstance(m, TorchBatchNorm)]

    def __enter__(self):
        for m in self.norms:
            m.recomputing = True

    def __exit__(self, *exc):
        for m in self.norms:
            m.recomputing = False


def checkpointed(fn, *args):
    """``fn(*args)`` under activation checkpointing (RUNTIME.REMAT*, the
    counterpart of flax's ``nn.remat``): its activations are dropped and
    recomputed in the backward. ``fn`` is a module or a module's bound
    method. Non-reentrant, so that ``torch.autograd.grad(create_graph=True)``
    works through it (the MAGP). The module's batch norms skip their
    running-stat update in the recompute. Without autograd recording, a
    plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    module = fn if isinstance(fn, nn.Module) else fn.__self__
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _Recomputing(module)))


class _SignMaskLeakyReLU(torch.autograd.Function):
    """``F.leaky_relu`` whose backward scales the gradient by a saved sign
    mask; differentiated again, it is linear in the gradient alone."""

    @staticmethod
    def forward(ctx, x, negative_slope: float):
        ctx.negative_slope = negative_slope
        ctx.save_for_backward(x > 0)
        return F.leaky_relu(x, negative_slope)

    @staticmethod
    def backward(ctx, dy):
        (positive,) = ctx.saved_tensors
        return torch.where(positive, dy, dy * ctx.negative_slope), None


class LeakyReLU(nn.LeakyReLU):
    """The discriminators' ``nn.LeakyReLU``, with a backward that reads the
    sign of its input from a saved mask (the same values as PyTorch's
    ``leaky_relu_backward``). Differentiated again (the MAGP), it sends
    nothing back into its input: PyTorch's own double backward sends a
    zero gradient there, and through it reaches every operation of the D's
    forward, one more input gradient of zeros for each conv."""

    def forward(self, x):
        if not (torch.is_grad_enabled() and x.requires_grad):
            return F.leaky_relu(x, self.negative_slope)
        return _SignMaskLeakyReLU.apply(x, self.negative_slope)


def leaky_relu(x, negative_slope: float = 0.2):
    return F.leaky_relu(x, negative_slope)


class _AvgPool2x(torch.autograd.Function):
    """``F.avg_pool2d(x, 2, 2)`` whose backward reads its input's shape
    only; differentiated again, it is linear in the gradient alone."""

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
    """2x2 stride-2 average pool (VALID). Recorded for a gradient, its
    backward is PyTorch's (the same values), but it sends nothing back
    into its input when differentiated again (the MAGP): PyTorch's own
    double backward sends a zero gradient there, as ``leaky_relu`` does
    (:class:`LeakyReLU`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AvgPool2x.apply(x)
    return F.avg_pool2d(x, 2, 2)


def upsample_nearest_2x(x):
    """Nearest-neighbour 2x upsample (reference `F.interpolate(x, 2)`)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def resize_bilinear_align_corners(x, out_hw: Tuple[int, int]):
    """Bilinear resize with ``align_corners=True`` (reference
    `models.py:220`, the semantic-mask pyramid); identity at equal size."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


@functools.lru_cache(maxsize=None)
def _half_pixel_matrix(src: int, dst: int) -> np.ndarray:
    """Interpolation matrix (dst, src) of ``jax.image.resize(...,
    "bilinear")``: the triangle kernel at half-pixel centres, widened by
    src/dst when shrinking (antialias), each row normalised to sum 1, and
    zero for a sample outside the input (as
    ``jax._src.image.scale.compute_weight_mat``)."""
    scale = np.float32(dst / src)
    inv = np.float32(1.0) / scale
    kernel_scale = max(inv, np.float32(1.0))
    sample = (np.arange(dst, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    dist = np.abs(sample[None, :] - np.arange(src, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0.0), np.float32(1.0) - dist / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, 0).T
                                .astype(np.float32))


def resize_bilinear_half_pixel(x, out_hw: Tuple[int, int]):
    """Bilinear resize with half-pixel centres (align_corners=False), NCHW,
    as ``jax.image.resize(method="bilinear")`` computes it (antialiased
    when shrinking), in x's dtype. The image encoder resizes 256 -> 299
    with it. Two interpolation matmuls, like the align_corners resize of
    the JAX package."""
    h, w = x.shape[2:]
    ah = torch.from_numpy(_half_pixel_matrix(h, out_hw[0])).to(x.device,
                                                                x.dtype)
    aw = torch.from_numpy(_half_pixel_matrix(w, out_hw[1])).to(x.device,
                                                                x.dtype)
    x = torch.einsum("Hh,bchw->bcHw", ah, x)
    return torch.einsum("Ww,bchw->bchW", aw, x)


class ToImage(nn.Sequential):
    """BN -> LeakyReLU(0.2) -> conv3x3 -> tanh (reference `get_image`;
    Sequential indices 0/2 carry the weights, as in the reference)."""

    def __init__(self, in_ch: int, compute_dtype=torch.float32):
        super().__init__(
            TorchBatchNorm(in_ch),
            nn.LeakyReLU(0.2),
            conv3x3(in_ch, 3, compute_dtype=compute_dtype),
            nn.Tanh(),
        )


class MaskHead(nn.Sequential):
    """conv3x3 -> BN -> ReLU -> conv1x1 mask-logit head (reference
    `get_mask`; Sequential indices 0/1/3)."""

    def __init__(self, in_ch: int, mask_channels: int = 100,
                 compute_dtype=torch.float32):
        super().__init__(
            conv3x3(in_ch, mask_channels, compute_dtype=compute_dtype),
            TorchBatchNorm(mask_channels),
            nn.ReLU(),
            conv1x1(mask_channels, 1, compute_dtype=compute_dtype),
        )
