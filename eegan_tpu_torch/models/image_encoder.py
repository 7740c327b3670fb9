"""Frozen DAMSM image encoder on the Inception-v3 trunk (counterpart of
``eegan_tpu/models/image_encoder.py``; reference `CNN_ENCODER`,
`DAMSM.py:117-230`).

Images are resized to 299² (:func:`resize_bilinear_half_pixel`, the JAX
resize), region features are the Mixed_6e 17x17x768 tap through a 1x1 conv
(``emb_features``, no bias) and the global code is the Mixed_7c average
pool through a linear (``emb_cnn_code``). The trunk's modules sit at the
top level, as in the reference's state dict (``Conv2d_1a_3x3.conv.weight``,
``emb_features.weight``); the JAX tree nests them under ``inception/``.

The encoder is frozen (eval-mode batch norm, no parameter requires grad),
but gradients flow through it to the image: the G phase trains the
generator through the DAMSM losses. With ``remat``
(RUNTIME.REMAT_IMAGE_ENCODER) the trunk runs under
:func:`~eegan_tpu_torch.models.layers.checkpointed`, so its activations
are recomputed in that backward instead of held.
"""

from __future__ import annotations

from typing import Tuple

import torch

from eegan_tpu_torch.models.inception import InceptionV3
from eegan_tpu_torch.models.layers import (
    Linear,
    checkpointed,
    conv1x1,
    resize_bilinear_half_pixel,
)


class ImageEncoder(InceptionV3):
    def __init__(self, nef: int = 256, compute_dtype=torch.float32,
                 remat: bool = False):
        super().__init__(num_classes=0, compute_dtype=compute_dtype)
        self.remat = remat
        self.emb_features = conv1x1(768, nef, compute_dtype=compute_dtype)
        self.emb_cnn_code = Linear(2048, nef, compute_dtype=compute_dtype)
        for p in (self.emb_features.weight, self.emb_cnn_code.weight):
            torch.nn.init.uniform_(p, -0.1, 0.1)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, 3) in [-1, 1], NHWC. Returns (region features
        (B, 17, 17, nef), code (B, nef)), both in the parameters' dtype
        (float32)."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = resize_bilinear_half_pixel(x, (299, 299))
        trunk = super().forward
        taps = checkpointed(trunk, x) if self.remat else trunk(x)
        region = self.emb_features(taps["mixed_6e"])
        code = self.emb_cnn_code(taps["pool3"])
        dt = self.emb_features.weight.dtype
        return region.to(dt).permute(0, 2, 3, 1), code.to(dt)
