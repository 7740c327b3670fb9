"""Fine-tune the Inception classifier of the Inception Score (counterpart
of ``eegan_tpu/evaluation/inception_finetune.py``).

The reference scores IS with StackGAN's fine-tuned Inception checkpoints
(birds: 50 classes, flowers: 20, + 1 background class — reference
`metrics/IS_TF/inception_score.py:41-51`), which it cannot produce. This
trains that classifier: Inception-v3 with ``CLASS_NUM + 1`` classes (class
0 is the background, as the scorer expects), softmax cross-entropy over
all classes on the dataset's 1-based class ids, augmented crops of the
largest branch resized on the device to 299², Adam(lr) with optax's
defaults (b1 0.9, b2 0.999, eps 1e-8), batch norm in train mode (its
running statistics move, as flax's do: towards the biased batch
variance).

The classifier is saved as a state dict, ``<output_dir>/is_inception.pt``
(``training/checkpoint.atomic_save``), which :func:`load_is_classifier`
reads. The JAX package saves an Orbax directory, which the port cannot
read: converting one is the checkpoint bridge of ROADMAP.md Queue 1.
"""

from __future__ import annotations

import itertools
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from eegan_tpu_torch import resolve_device
from eegan_tpu_torch.config import Config
from eegan_tpu_torch.models.factory import compute_dtype
from eegan_tpu_torch.models.inception import InceptionV3
from eegan_tpu_torch.models.layers import resize_bilinear_half_pixel
from eegan_tpu_torch.training.steps import _tensor, normalize_image_leaves

CLASSIFIER_FILE = "is_inception.pt"


def build_is_model(config: Config, device="cuda") -> InceptionV3:
    return InceptionV3(num_classes=config.TRAIN.CLASS_NUM + 1,
                       compute_dtype=compute_dtype(config)).to(
        resolve_device(device), memory_format=torch.channels_last)


def make_finetune_step(config: Config, model: InceptionV3, lr: float = 1e-4
                       ) -> Tuple[Callable[..., Dict[str, torch.Tensor]],
                                  Callable[..., torch.optim.Optimizer]]:
    """-> ``(step, init_opt)``.

    ``init_opt(model)`` gives the Adam; ``step(opt, batch) -> metrics``
    trains ``model`` in place on ``batch`` (the pipeline's keys, arrays or
    tensors) and returns the loss and accuracy as 0-d device tensors."""
    img_key = f"img{config.imsizes[-1]}"
    dev = next(model.parameters()).device

    def init_opt(module) -> torch.optim.Optimizer:
        return torch.optim.Adam(module.parameters(), lr=lr,
                                betas=(0.9, 0.999), eps=1e-8)

    def step(opt: torch.optim.Optimizer, batch) -> Dict[str, torch.Tensor]:
        batch = normalize_image_leaves(
            {k: _tensor(batch[k]).to(dev, non_blocking=True)
             for k in (img_key, "class_ids")})
        model.train()
        opt.zero_grad(set_to_none=True)
        x = resize_bilinear_half_pixel(
            batch[img_key].permute(0, 3, 1, 2).float(), (299, 299))
        logits = model(x)["logits"]
        # The dataset's class ids are 1-based; class 0 stays background.
        labels = batch["class_ids"].long()
        loss = torch.mean(torch.logsumexp(logits, dim=-1)
                          - logits.gather(1, labels[:, None])[:, 0])
        loss.backward()
        opt.step()
        acc = torch.mean((logits.argmax(-1) == labels).float())
        return {"is_finetune/loss": loss.detach(), "is_finetune/acc": acc}

    return step, init_opt


def finetune_inception(config: Config, dataset, output_dir: str, epochs: int,
                       seed: int = 0, lr: float = 1e-4,
                       max_iters_per_epoch: Optional[int] = None,
                       device="cuda") -> InceptionV3:
    """Train the IS classifier and save it to
    ``<output_dir>/is_inception.pt``; returns the model."""
    from eegan_tpu_torch.data.pipeline import DataPipeline, device_prefetch
    from eegan_tpu_torch.training.checkpoint import atomic_save
    from eegan_tpu_torch.training.logging import MetricWriter

    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_is_model(config, dev)
    step_fn, init_opt = make_finetune_step(config, model, lr)
    opt = init_opt(model)
    pipeline = DataPipeline(dataset, config.TRAIN.BATCH_SIZE, seed=seed,
                            num_workers=config.RUNTIME.DATA_WORKERS)
    writer = MetricWriter(os.path.join(output_dir, "writer_is"))
    try:
        it = 0
        for epoch in range(1, epochs + 1):
            src = pipeline.epoch(epoch)
            if max_iters_per_epoch is not None:
                src = itertools.islice(src, max_iters_per_epoch)
            for batch in device_prefetch(src, dev):
                metrics = step_fn(opt, batch)
                it += 1
                if it % 50 == 1:
                    writer.write_scalars(
                        it, {k: float(v) for k, v in metrics.items()})
        path = os.path.abspath(os.path.join(output_dir, CLASSIFIER_FILE))
        atomic_save({k: v.detach().cpu()
                     for k, v in model.state_dict().items()}, path)
        print(f"saved IS classifier -> {path}")
    finally:
        writer.close()
        pipeline.close()
    return model


def load_is_classifier(path: str, config: Config,
                       device="cuda") -> InceptionV3:
    """The classifier :func:`finetune_inception` saved, for
    ``InceptionScorer(model=...)``."""
    model = build_is_model(config, device)
    model.load_state_dict(torch.load(path, map_location="cpu",
                                     weights_only=True))
    return model.eval()
