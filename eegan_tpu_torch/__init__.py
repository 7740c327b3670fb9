"""eegan_tpu_torch — the PyTorch/CUDA port of ``eegan_tpu``.

The JAX package stays the reference; this package rebuilds it module by
module for an NVIDIA Hopper GPU and is tested against it (same weights, same
inputs, outputs within a stated tolerance). Module names follow the JAX
package so each counterpart is easy to find.

Layout:
    config        typed config tree + strict YAML merge (copy of eegan_tpu's)
    data          caption prep, attribute parsing, the CUB datasets and
                  transforms, the native resize, the batching pipeline and
                  device prefetch, synthetic data, the demo corpus
    evaluation    FID, Inception Score and its classifier's fine-tune, the
                  checkpoint sweep with R-precision, evaluation overlapped
                  with training
    models        generator, AttrEnhance, discriminators, text and image
                  encoders as torch nn.Modules
    ops           hand-written CUDA kernels with their plain PyTorch versions
    training      the train and sampling steps, the trainer, checkpoints,
                  logging, DAMSM pretraining
    utils         image IO, weight conversion (JAX trees, AttnGAN .pth)
    sample        the sampling CLI (``python -m eegan_tpu_torch.sample``)
    train         the training CLI (``python -m eegan_tpu_torch.train``)
    pretrain_damsm  the DAMSM pretraining CLI
    test, fid_score, inception_score, finetune_inception
                  the evaluation CLIs

Tensors run NCHW in ``torch.channels_last`` memory format, so the kernels see
the NHWC byte order of the JAX package. Entry points run on ``cuda`` unless
the caller asks for the CPU; see :func:`resolve_device`.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.

    ``cuda`` (the default everywhere) needs a visible GPU and raises without
    one: the port never falls back to the CPU on its own. The CPU runs only
    when the caller asks for it (``device="cpu"``), as the tests do.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' (or --device cpu) to run on the CPU")
    return dev
