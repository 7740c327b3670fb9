"""DAMSM encoder pretraining (counterpart of
``eegan_tpu/training/damsm_trainer.py``).

The reference consumes AttnGAN-pretrained DAMSM encoders
(`cfg.TEXT.DAMSM_NAME`, reference `train.py:233-248`) but cannot produce
them; its config still carries the AttnGAN training knobs (ENCODER_LR,
RNN_GRAD_CLIP — reference `miscc/config.py:43-44`). This trains the text
BiLSTM and the Inception image encoder jointly with the DAMSM sentence and
word losses, and writes them where TEXT.DAMSM_NAME can name them.

One step, as the JAX step: the text encoder in train mode (embedding
dropout, its mask from an explicit ``torch.Generator``), the image encoder
in eval mode (running BN statistics), ``sent_loss`` + the plain
``words_loss`` (not the fused kernel, as in JAX, so the dW kernel is not
taken), one backward, the global-norm clip (RNN_GRAD_CLIP) on the text
gradients only, and one Adam(ENCODER_LR, betas (0.5, 0.999)) update of
each encoder, in place.
"""

from __future__ import annotations

import itertools
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from eegan_tpu_torch.config import Config
from eegan_tpu_torch.losses import damsm as damsm_losses
from eegan_tpu_torch.models.factory import ModelBundle
from eegan_tpu_torch.training.state import FrozenEncoders, clip_by_global_norm_
from eegan_tpu_torch.training.steps import _tensor, normalize_image_leaves

Optimizers = Tuple[torch.optim.Optimizer, torch.optim.Optimizer]


def make_damsm_train_step(config: Config, models: ModelBundle
                          ) -> Tuple[Callable[..., Dict[str, torch.Tensor]],
                                     Callable[..., Optimizers]]:
    """-> ``(step, init_opt)``.

    ``init_opt(text_encoder, image_encoder)`` gives the two Adams;
    ``step(opts, batch, generator=None) -> metrics`` trains
    ``models.text_encoder`` and ``models.image_encoder`` in place on
    ``batch`` (the pipeline's keys; arrays or tensors, the length leaves on
    the host) and returns the JAX step's metrics as 0-d device tensors.
    ``generator`` draws the dropout mask (the global RNG when None).
    """
    sm = config.TRAIN.SMOOTH
    lr = config.TRAIN.ENCODER_LR
    clip = config.TRAIN.RNN_GRAD_CLIP
    text_encoder, image_encoder = models.text_encoder, models.image_encoder
    img_key = f"img{models.scales[-1]}"
    dev = models.device

    def init_opt(text_module, image_module) -> Optimizers:
        return tuple(torch.optim.Adam(m.parameters(), lr=lr,
                                      betas=(0.5, 0.999), eps=1e-8)
                     for m in (text_module, image_module))

    def step(opts: Optimizers, batch,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        text_opt, image_opt = opts
        host = {k: _tensor(v) for k, v in batch.items()}
        batch = normalize_image_leaves(
            {k: v.to(dev, non_blocking=True) for k, v in host.items()})
        text_encoder.train()
        image_encoder.eval()
        text_opt.zero_grad(set_to_none=True)
        image_opt.zero_grad(set_to_none=True)
        words, sent = text_encoder(batch["caps"], host["cap_lens"],
                                   generator=generator)
        region, code = image_encoder(batch[img_key])
        class_ids = batch["class_ids"]
        s0, s1 = damsm_losses.sent_loss(code, sent, class_ids, sm.GAMMA3)
        w0, w1 = damsm_losses.words_loss(region, words, batch["cap_lens"],
                                         class_ids, sm.GAMMA1, sm.GAMMA2,
                                         sm.GAMMA3)
        total = (s0 + s1 + w0 + w1) * sm.LAMBDA
        total.backward()
        clip_by_global_norm_(text_encoder.parameters(), clip)
        text_opt.step()
        image_opt.step()
        return {"damsm/s_loss": (s0 + s1).detach(),
                "damsm/w_loss": (w0 + w1).detach(),
                "damsm/total": total.detach()}

    return step, init_opt


def pretrain_damsm(config: Config, models: ModelBundle, dataset,
                   output_dir: str, epochs: int, seed: int = 0,
                   max_iters_per_epoch: Optional[int] = None
                   ) -> FrozenEncoders:
    """Train ``models``' two encoders for ``epochs`` epochs and save them
    (``<output_dir>/Model/frozen_encoders``) for TEXT.DAMSM_NAME."""
    from eegan_tpu_torch.data.pipeline import DataPipeline, device_prefetch
    from eegan_tpu_torch.training.checkpoint import CheckpointManager
    from eegan_tpu_torch.training.logging import MetricWriter

    text_encoder, image_encoder = models.text_encoder, models.image_encoder
    for module in (text_encoder, image_encoder):
        module.requires_grad_(True)
    step_fn, init_opt = make_damsm_train_step(config, models)
    opts = init_opt(text_encoder, image_encoder)
    generator = torch.Generator(models.device).manual_seed(seed)
    pipeline = DataPipeline(dataset, config.TRAIN.BATCH_SIZE, seed=seed,
                            num_workers=config.RUNTIME.DATA_WORKERS)
    writer = MetricWriter(os.path.join(output_dir, "writer_damsm"))
    try:
        it_count = 0
        for epoch in range(1, epochs + 1):
            src = pipeline.epoch(epoch)
            if max_iters_per_epoch is not None:
                src = itertools.islice(src, max_iters_per_epoch)
            for batch in device_prefetch(src, models.device):
                metrics = step_fn(opts, batch, generator)
                it_count += 1
                if it_count % 50 == 1:
                    writer.write_scalars(
                        it_count, {k: float(v) for k, v in metrics.items()})
        frozen = FrozenEncoders(text_encoder=text_encoder,
                                image_encoder=image_encoder)
        path = CheckpointManager(os.path.join(output_dir, "Model")
                                 ).save_frozen(frozen)
        print(f"saved DAMSM encoders -> {path}")
    finally:
        writer.close()
        pipeline.close()
    return frozen
