"""Model bundle construction from a Config (counterpart of
``eegan_tpu/models/factory.py``): the generator, AttrEnhance, one
discriminator per scale (the class head only at the last, as
``eegan_tpu/models/factory.py:48-55``), the frozen text encoder and the
frozen image encoder.

Unlike the JAX factory, RUNTIME.PALLAS_AFFINE and PALLAS_DAMSM are not
gated on the backend: the ops dispatch on the tensors' device themselves
(CUDA tensors launch the kernels, CPU tensors take the plain versions).
RUNTIME.REMAT (with REMAT_BLOCKS), REMAT_D and REMAT_IMAGE_ENCODER are
wired as ``eegan_tpu/models/factory.py:54-70`` wires them. RUNTIME.S2D_CONVS
is a TPU lane-packing lowering of the same math and is ignored.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn

from eegan_tpu_torch import resolve_device
from eegan_tpu_torch.config import Config
from eegan_tpu_torch.models.attr_enhance import AttrEnhance
from eegan_tpu_torch.models.discriminator import Discriminator
from eegan_tpu_torch.models.generator import Generator
from eegan_tpu_torch.models.image_encoder import ImageEncoder
from eegan_tpu_torch.models.layers import DTYPES
from eegan_tpu_torch.models.text_encoder import TextEncoder


def compute_dtype(config: Config) -> torch.dtype:
    return DTYPES[config.RUNTIME.COMPUTE_DTYPE]


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    generator: Generator
    attr_enhance: AttrEnhance
    discriminators: Tuple[Discriminator, ...]  # one per branch scale
    text_encoder: TextEncoder
    image_encoder: ImageEncoder
    scales: Tuple[int, ...]
    device: torch.device


def build_models(config: Config, n_words: int, device="cuda") -> ModelBundle:
    """Randomly initialised modules on ``device`` (channels_last)."""
    dev = resolve_device(device)
    dt = compute_dtype(config)
    emb = config.TEXT.EMBEDDING_DIM
    cl = torch.channels_last
    scales = tuple(config.imsizes)
    rt = config.RUNTIME
    generator = Generator(ngf=config.GAN.GF_DIM, nz=config.GAN.Z_DIM,
                          cond_dim=emb, compute_dtype=dt,
                          up_fused=rt.FUSED_UPSAMPLE,
                          pallas_affine=rt.PALLAS_AFFINE, remat=rt.REMAT,
                          remat_blocks=rt.REMAT_BLOCKS)
    discs = tuple(
        Discriminator(ndf=config.GAN.DF_DIM, scale=s,
                      disc_class=config.TRAIN.USE_CLASS
                      and i == len(scales) - 1,
                      class_nums=config.TRAIN.CLASS_NUM, nef=emb,
                      compute_dtype=dt, remat=rt.REMAT and rt.REMAT_D
                      ).to(dev, memory_format=cl)
        for i, s in enumerate(scales))
    return ModelBundle(
        generator=generator.to(dev, memory_format=cl),
        attr_enhance=AttrEnhance(ntf=emb, compute_dtype=dt).to(dev),
        discriminators=discs,
        text_encoder=TextEncoder(ntoken=n_words, nhidden=emb,
                                 rnn_type=config.RNN_TYPE).to(dev),
        image_encoder=ImageEncoder(nef=emb, compute_dtype=dt,
                                   remat=rt.REMAT_IMAGE_ENCODER).to(
            dev, memory_format=cl),
        scales=scales,
        device=dev,
    )


@torch.no_grad()
def randomize_(module: nn.Module, seed: int) -> nn.Module:
    """Redraw every parameter and BN running stat from ``seed``, in place.

    For smoke runs and parity tests with random weights: unlike the default
    init, the zero-initialised layers (the affine MLPs' last layer, the
    residual gammas) and the BN running stats get non-trivial values, so
    every path of the network moves the output. Draws happen on the CPU, so
    a seed gives the same weights on every device.

    * weights with >= 2 dims: U(+-sqrt(3/fan_in)) (variance 1/fan_in, so
      activations keep their scale through the blocks and the images
      spread over [-1, 1]);
    * BN scale: 1 + 0.1 N(0, 1); other 1-D parameters: 0.1 N(0, 1);
    * running_mean: 0.1 N(0, 1); running_var: U(0.5, 1.5).
    """
    gen = torch.Generator().manual_seed(seed)
    for mod in module.modules():
        is_bn = isinstance(mod, nn.modules.batchnorm._BatchNorm)
        for name, p in mod.named_parameters(recurse=False):
            if p.dim() >= 2:
                bound = math.sqrt(3.0 / p[0].numel())
                new = torch.rand(p.shape, generator=gen) * 2 * bound - bound
            else:
                new = 0.1 * torch.randn(p.shape, generator=gen)
                if is_bn and name == "weight":
                    new += 1.0
            p.copy_(new)
        for name, buf in mod.named_buffers(recurse=False):
            if name == "running_mean":
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name == "running_var":
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    return module


def to_float64_(module: nn.Module) -> nn.Module:
    """Casts ``module``'s parameters and buffers to float64, in place, and
    makes its layers compute in float64: the yardstick that says how far a
    float32 step's rounding moves its gradients (the DAMSM encoders; their
    losses follow the inputs' dtype)."""
    for mod in module.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    return module.double()
