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

Over a ``mesh`` of R ranks (``parallel/mesh.py``; the JAX package shards
the batch over its ``data`` axis) each rank trains on its B/R rows of the
global batch: the Inception's batch norms take the global batch's
statistics, the gradients are averaged over the ranks before the same
Adam step runs on every rank, and the loss and accuracy are the global
batch's means.

The classifier is saved as a state dict, ``<output_dir>/is_inception.pt``
(``training/checkpoint.atomic_save``), which :func:`load_is_classifier`
reads. The JAX package saves an Orbax directory; the repository's root
script ``convert_jax_checkpoints.py --is_classifier`` converts one into
this file.
"""

from __future__ import annotations

import itertools
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from eegan_tpu_torch import resolve_device
from eegan_tpu_torch.config import Config
from eegan_tpu_torch.models.factory import compute_dtype
from eegan_tpu_torch.models.inception import BatchNorm2d, InceptionV3
from eegan_tpu_torch.models.layers import resize_bilinear_half_pixel
from eegan_tpu_torch.parallel.mesh import Mesh
from eegan_tpu_torch.training.steps import _tensor, normalize_image_leaves

CLASSIFIER_FILE = "is_inception.pt"


def build_is_model(config: Config, device="cuda") -> InceptionV3:
    return InceptionV3(num_classes=config.TRAIN.CLASS_NUM + 1,
                       compute_dtype=compute_dtype(config)).to(
        resolve_device(device), memory_format=torch.channels_last)


def make_finetune_step(config: Config, model: InceptionV3, lr: float = 1e-4,
                       mesh: Optional[Mesh] = None
                       ) -> Tuple[Callable[..., Dict[str, torch.Tensor]],
                                  Callable[..., torch.optim.Optimizer]]:
    """-> ``(step, init_opt)``.

    ``init_opt(model)`` gives the Adam; ``step(opt, batch) -> metrics``
    trains ``model`` in place on ``batch`` (the pipeline's keys, arrays or
    tensors) and returns the loss and accuracy as 0-d device tensors. With
    a ``mesh`` of more than one rank, ``batch`` is this rank's rows of the
    global batch (:meth:`Mesh.shard_batch`), the model's batch norms are
    bound to the mesh and the metrics are the global batch's."""
    img_key = f"img{config.imsizes[-1]}"
    dev = next(model.parameters()).device
    if mesh is not None and mesh.size == 1:
        mesh = None
    if mesh is not None:
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.mesh = mesh

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
        acc = torch.mean((logits.argmax(-1) == labels).float())
        loss = loss.detach()
        if mesh is not None:
            mesh.average_gradients_(model.parameters())
            loss, acc = mesh.average([loss, acc])
        opt.step()
        return {"is_finetune/loss": loss, "is_finetune/acc": acc}

    return step, init_opt


def finetune_inception(config: Config, dataset, output_dir: str, epochs: int,
                       seed: int = 0, lr: float = 1e-4,
                       max_iters_per_epoch: Optional[int] = None,
                       device="cuda", mesh: Optional[Mesh] = None
                       ) -> InceptionV3:
    """Train the IS classifier and save it to
    ``<output_dir>/is_inception.pt``; returns the model. With a ``mesh``
    every rank loads the global batch and trains on its rows
    (:meth:`Mesh.shard_batch`); rank 0 writes the metrics and the file."""
    from eegan_tpu_torch.data.pipeline import DataPipeline, device_prefetch
    from eegan_tpu_torch.training.checkpoint import atomic_save
    from eegan_tpu_torch.training.logging import MetricWriter

    dev = resolve_device(device)
    main_rank = mesh is None or mesh.rank == 0
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_is_model(config, dev)
    step_fn, init_opt = make_finetune_step(config, model, lr, mesh)
    opt = init_opt(model)
    pipeline = DataPipeline(dataset, config.TRAIN.BATCH_SIZE, seed=seed,
                            num_workers=config.RUNTIME.DATA_WORKERS)
    writer = (MetricWriter(os.path.join(output_dir, "writer_is"))
              if main_rank else None)
    try:
        it = 0
        for epoch in range(1, epochs + 1):
            src = pipeline.epoch(epoch)
            if max_iters_per_epoch is not None:
                src = itertools.islice(src, max_iters_per_epoch)
            if mesh is not None:
                src = map(mesh.shard_batch, src)
            for batch in device_prefetch(src, dev):
                metrics = step_fn(opt, batch)
                it += 1
                if writer is not None and it % 50 == 1:
                    writer.write_scalars(
                        it, {k: float(v) for k, v in metrics.items()})
        if main_rank:
            path = os.path.abspath(os.path.join(output_dir, CLASSIFIER_FILE))
            atomic_save({k: v.detach().cpu()
                         for k, v in model.state_dict().items()}, path)
            print(f"saved IS classifier -> {path}")
    finally:
        if writer is not None:
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
