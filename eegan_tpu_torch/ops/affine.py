"""Fused BN-normalise (+ nearest-2x upsample) + mask-gated affine + ReLU.

Counterpart of ``eegan_tpu/ops/affine_pallas.py``. The generator's SAGB
blocks run, in both affine layers,

    out = relu((gamma*mask + 1) * (x - mean)*rsqrt(var + eps) + beta*mask)

with an optional nearest-2x upsample of the normalised map (``up=True``,
the FUSED_UPSAMPLE schedule whose BN statistics live at the pre-upsample
resolution). The statistics stay outside (``TorchBatchNorm(return_stats)``).

* :func:`affine_mask_relu` dispatches on the tensors' device: a CUDA tensor
  goes through :class:`AffineMaskReLU`, whose forward is the hand-written
  kernel ``csrc/affine_mask_relu.cu`` and whose backward is
  ``csrc/affine_mask_relu_bwd.cu`` (the port of ``_affine_vjp_bwd``),
  giving the gradients of x, mean, var, gamma, beta and mask; a CPU tensor
  goes to the plain version, and autograd of it is the plain backward.
  There is no other fallback: a CUDA tensor launches the kernel or raises.
* :func:`affine_mask_relu_reference` is the plain PyTorch version, the math
  of ``affine_pallas.py:255-271`` (fp32 inside).
* ``affine_mask_relu.launches`` and ``affine_mask_relu_backward.launches``
  count kernel launches. Under a running profiler the entry is the span
  ``eegan.ops.affine_mask_relu.fwd`` (either path) and the backward
  ``eegan.ops.affine_mask_relu.bwd``.
* :func:`forward_launch_plan` and :func:`backward_launch_plan` are the two
  kernels' launch plans (vector width, lanes per pixel, blocks per sample;
  the backward's scratch), plain Python that the CPU tests reach.

Layout: x (B, C, h, w) and the result (B, C, H, W) are NCHW tensors in
``torch.channels_last`` memory format (NHWC bytes, as the TPU kernel's);
mask (B, 1, H, W); gamma, beta (B, C) in x's dtype; mean, var (C,) float32.
The gradients come in the inputs' dtypes and layouts.
"""

from __future__ import annotations

import ctypes

import torch

from eegan_tpu_torch.models.layers import upsample_nearest_2x
from eegan_tpu_torch.ops import _build
from eegan_tpu_torch.training.logging import span

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
_THREADS = 256
_SMS = 132  # streaming multiprocessors of an H100 SXM


def affine_mask_relu_reference(x, mean, var, gamma, beta, mask,
                               up: bool = False, eps: float = 1e-5,
                               out_dtype=torch.float32):
    """Plain PyTorch version of the kernel (fp32 inside)."""
    r = torch.rsqrt(var.float() + eps)[:, None, None]
    xhat = (x.float() - mean.float()[:, None, None]) * r
    if up:
        xhat = upsample_nearest_2x(xhat)
    m = mask.float()
    g = gamma.float()[:, :, None, None]
    b = beta.float()[:, :, None, None]
    z = (g * m + 1.0) * xhat + b * m
    return torch.relu(z).to(out_dtype).contiguous(
        memory_format=torch.channels_last)


_BWD_MAX_C = 512
# Blocks per launch: one or two whole waves (the forward runs four blocks
# per SM, the backward two), the second when there are about 16 pixel steps
# per block for it, and never more blocks than steps.
_FWD_BLOCKS_PER_SM = 4  # __launch_bounds__ of csrc/affine_mask_relu.cu
_FWD_WAVE = _FWD_BLOCKS_PER_SM * _SMS
_BWD_WAVE = 2 * _SMS
_STEPS_PER_BLOCK = 16


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _blocks_per_sample(B: int, steps: int, wave: int) -> int:
    """Blocks per sample (and channel chunk) for one or two whole waves."""
    waves = min(2, max(1, round(B * steps / (wave * _STEPS_PER_BLOCK))))
    return max(1, min(waves * wave // B, steps))


def _fwd_unroll(up: bool, vec: int) -> int:
    """Pixels a group takes per step: the kernel's own rule
    (``unroll_for``), which sizes the grid here."""
    if up:
        return 1
    return 4 if vec <= 4 else 2


def forward_launch_plan(B: int, C: int, h: int, w: int, up: bool,
                        in_dtype=torch.bfloat16, aligned: bool = True
                        ) -> dict:
    """The forward kernel's launch at these shapes.

    A thread owns ``vec`` channels of one sample (16 bytes of x: 8 bf16 or
    4 float32; 1 when C is not a multiple of that or an operand is not
    aligned to a whole vector) and loads their constants once. ``lanes``
    neighbouring threads cover one pixel's vectors (``chunks`` blocks of
    them side by side when C / vec exceeds 256), so a block of 256 threads
    covers ``groups`` pixels at once and each group takes ``unroll`` pixels
    per step: low-res pixels with ``up``, each written as its 2x2 quad.
    Thread t of block (x, chunk, b) owns vector ``chunk * lanes + t %
    lanes`` and, at step k, the pixels ``(k * nblk + x) * groups * unroll
    + u * groups + t // lanes`` for u < unroll. ``blocks_per_sample``
    blocks per sample and chunk make one or two whole waves of four blocks
    per SM of an H100.
    """
    if min(B, C, h, w) <= 0:
        raise ValueError(f"the forward kernel takes positive shapes, got "
                         f"B={B}, C={C}, h={h}, w={w}")
    if h * w >= 2 ** 31:
        raise ValueError(f"the forward kernel takes h * w < 2**31, got "
                         f"{h}x{w}")
    vmax = 16 // torch.empty((), dtype=in_dtype).element_size()
    vec = vmax if C % vmax == 0 and aligned else 1
    nvec = C // vec
    lanes = min(nvec, _THREADS)
    chunks = -(-nvec // lanes)
    if B > _MAX_GRID_Y or chunks > _MAX_GRID_Y:
        raise ValueError(f"the forward kernel takes at most {_MAX_GRID_Y} "
                         f"samples and {_MAX_GRID_Y * _THREADS} vectors of "
                         f"channels; got B={B}, C={C}")
    groups = _THREADS // lanes
    unroll = _fwd_unroll(up, vec)
    steps = -(-h * w // (groups * unroll))  # per sample and chunk
    nblk = _blocks_per_sample(B * chunks, steps, _FWD_WAVE)
    return dict(vec=vec, lanes=lanes, chunks=chunks, groups=groups,
                unroll=unroll, blocks_per_sample=nblk,
                grid=(nblk, chunks, B), blocks=nblk * chunks * B)


def _bwd_unroll(up: bool, channels_per_lane: int) -> int:
    """Low-res pixels a group takes per step: the kernel's own rule
    (``unroll_for``), which sizes the grid here."""
    if up:
        return 1
    return 4 if channels_per_lane <= 8 else 2


def backward_launch_plan(B: int, C: int, h: int, w: int, up: bool,
                         in_dtype=torch.bfloat16, aligned: bool = True
                         ) -> dict:
    """The backward kernel's launch at these shapes.

    A thread takes ``vec`` channels per access (16 bytes of x: 8 bf16 or 4
    float32; 1 when C is not a multiple of that or an operand is not 16-byte
    aligned), ``vecs_per_lane`` vectors per pixel; ``lanes`` lanes (a power
    of 2, at most 32) cover one low-res pixel, so a warp covers
    ``pixels_per_warp`` pixels at once and a group takes ``unroll`` of them
    per step. ``blocks_per_sample`` blocks of 256 threads per sample fill
    one or two whole waves of two blocks per SM of an H100 (a partial wave
    costs as much as a whole one), the second only for about 16 steps per
    block. ``scratch_floats`` is the float32 partial buffer, four sums per
    block and channel, which a second launch sums in a fixed order.
    """
    if not 0 < C <= _BWD_MAX_C:
        raise ValueError(f"the backward kernel takes 0 < C <= {_BWD_MAX_C}, "
                         f"got {C}")
    vmax = 16 // torch.empty((), dtype=in_dtype).element_size()
    vec = vmax if C % vmax == 0 and aligned else 1
    nvec = C // vec
    lanes = min(32, _pow2_ceil(nvec))
    vpl = _pow2_ceil(-(-nvec // lanes))
    unroll = _bwd_unroll(up, vec * vpl)
    steps = -(-h * w // (_THREADS // lanes * unroll))  # per sample
    nblk = _blocks_per_sample(B, steps, _BWD_WAVE)
    return dict(vec=vec, lanes=lanes, vecs_per_lane=vpl, unroll=unroll,
                pixels_per_warp=32 // lanes, blocks_per_sample=nblk,
                grid=(nblk, B), scratch_floats=B * nblk * 4 * C)


def _lib():
    lib = _build.load("affine_mask_relu")
    fn = lib.eegan_affine_mask_relu_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_float] + [i] * 7 + [p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    lib = _build.load("affine_mask_relu_bwd")
    fn = lib.eegan_affine_mask_relu_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 14 + [i] * 5 + [ctypes.c_float] + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, mean, var, gamma, beta, mask, up, out_dtype):
    if x.device.type != "cuda":
        raise ValueError(f"the affine kernels take CUDA tensors, got "
                         f"{x.device} (affine_mask_relu takes the plain "
                         "version on the CPU)")
    tensors = dict(x=x, mean=mean, var=var, gamma=gamma, beta=beta, mask=mask)
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, h, w), got {tuple(x.shape)}")
    B, C, h, w = x.shape
    H, W = (2 * h, 2 * w) if up else (h, w)
    want = dict(mean=(C,), var=(C,), gamma=(B, C), beta=(B, C),
                mask=(B, 1, H, W))
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, "
                             f"expected {shape}")
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"x/out dtype must be float32 or bfloat16, got "
                        f"{x.dtype}/{out_dtype}")
    for name in ("gamma", "beta", "mask"):
        if tensors[name].dtype != x.dtype:
            raise TypeError(f"{name} is {tensors[name].dtype}, x is {x.dtype}")
    for name in ("mean", "var"):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensors[name].dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be contiguous in channels_last memory format")
    for name in ("mean", "var", "gamma", "beta", "mask"):
        if not tensors[name].is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, C, h, w, H, W


def _forward_kernel(x, mean, var, gamma, beta, mask, up, eps, out_dtype):
    B, C, h, w, H, W = _check(x, mean, var, gamma, beta, mask, up, out_dtype)
    out = torch.empty((B, C, H, W), dtype=out_dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    # The vector path reads x, gamma, beta (vec * x's size) and mean, var
    # (vec floats) and writes out as whole vectors; the upsample reads the
    # mask two elements at a time.
    vmax = 16 // x.element_size()
    aligned = (all(t.data_ptr() % 16 == 0 for t in (x, gamma, beta, mean,
                                                    var))
               and out.data_ptr() % (vmax * out.element_size()) == 0)
    if up and mask.data_ptr() % (2 * mask.element_size()):
        mask = mask.clone()
    plan = forward_launch_plan(B, C, h, w, up, x.dtype, aligned)
    fn = _lib()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), mean.data_ptr(), var.data_ptr(),
                 gamma.data_ptr(), beta.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), B, h, w, C, int(up), float(eps),
                 _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], plan["vec"],
                 plan["lanes"], plan["chunks"], plan["blocks_per_sample"],
                 plan["unroll"],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"affine_mask_relu kernel launch failed: CUDA "
                           f"error {err}")
    affine_mask_relu.launches += 1
    return out


def affine_mask_relu_backward(x, mean, var, gamma, beta, mask, dy,
                              up: bool = False, eps: float = 1e-5):
    """The backward kernel: (dx, dmean, dvar, dgamma, dbeta, dmask) from the
    forward's inputs and the output gradient ``dy`` (B, C, H, W), each in
    its input's dtype and layout. CUDA tensors only."""
    B, C, h, w, H, W = _check(x, mean, var, gamma, beta, mask, up, dy.dtype)
    if tuple(dy.shape) != (B, C, H, W):
        raise ValueError(f"dy has shape {tuple(dy.shape)}, expected "
                         f"{(B, C, H, W)}")
    if dy.device != x.device:
        raise ValueError(f"dy is on {dy.device}, x on {x.device}")
    if not dy.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("dy must be contiguous in channels_last memory "
                         "format")
    if C > _BWD_MAX_C:
        raise ValueError(f"the backward kernel takes C <= {_BWD_MAX_C}, "
                         f"got {C}")
    if B > _MAX_GRID_Y:
        raise ValueError(f"the backward kernel takes at most {_MAX_GRID_Y} "
                         f"samples, got {B}")
    dev = x.device
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dmask = torch.empty_like(mask)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(beta)
    dmean = torch.empty_like(mean)
    dvar = torch.empty_like(var)
    if x.numel() == 0:
        return dx, dmean.zero_(), dvar.zero_(), dgamma.zero_(), \
            dbeta.zero_(), dmask.zero_()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, dx))
    plan = backward_launch_plan(B, C, h, w, up, x.dtype, aligned)
    partial = torch.empty((plan["scratch_floats"],), dtype=torch.float32,
                          device=dev)
    fn = _bwd_lib()
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), mean.data_ptr(), var.data_ptr(),
                 gamma.data_ptr(), beta.data_ptr(), mask.data_ptr(),
                 dy.data_ptr(), dx.data_ptr(), dmask.data_ptr(),
                 dgamma.data_ptr(), dbeta.data_ptr(), dmean.data_ptr(),
                 dvar.data_ptr(), partial.data_ptr(), B, h, w, C, int(up),
                 float(eps), _DTYPE_CODES[x.dtype], _DTYPE_CODES[dy.dtype],
                 plan["vec"], plan["lanes"], plan["vecs_per_lane"],
                 plan["blocks_per_sample"],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"affine_mask_relu backward kernel launch failed: "
                           f"CUDA error {err}")
    affine_mask_relu_backward.launches += 1
    return dx, dmean, dvar, dgamma, dbeta, dmask


affine_mask_relu_backward.launches = 0


class AffineMaskReLU(torch.autograd.Function):
    """Kernel 1 forward, kernel 2 backward (the port of the JAX custom VJP,
    ``affine_pallas.py:166-252``). Nothing but the inputs is saved: the
    backward recomputes z."""

    @staticmethod
    def forward(ctx, x, mean, var, gamma, beta, mask, up, eps, out_dtype):
        ctx.up, ctx.eps = up, eps
        ctx.save_for_backward(x, mean, var, gamma, beta, mask)
        return _forward_kernel(x, mean, var, gamma, beta, mask, up, eps,
                               out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, mean, var, gamma, beta, mask = ctx.saved_tensors
        with span("ops.affine_mask_relu.bwd"):
            grads = affine_mask_relu_backward(
                x, mean, var, gamma, beta, mask,
                dy.contiguous(memory_format=torch.channels_last), ctx.up,
                ctx.eps)
        return (*grads, None, None, None)


def affine_mask_relu(x, mean, var, gamma, beta, mask, up: bool = False,
                     eps: float = 1e-5, out_dtype=torch.float32):
    """relu((gamma*mask+1) * normalise(x) + beta*mask), one fused pass,
    differentiable in all six tensors.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernels.
    """
    with span("ops.affine_mask_relu.fwd"):
        if x.device.type == "cpu":
            return affine_mask_relu_reference(x, mean, var, gamma, beta, mask,
                                              up, eps, out_dtype)
        if x.device.type != "cuda":
            raise ValueError(f"no kernel for device {x.device}")
        return AffineMaskReLU.apply(x, mean, var, gamma, beta, mask, up, eps,
                                    out_dtype)


affine_mask_relu.launches = 0
