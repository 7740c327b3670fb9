"""Fine-tune the Inception classifier of the Inception Score (the port's
counterpart of the JAX package's ``finetune_inception.py``):

    python -m eegan_tpu_torch.finetune_inception --cfg cfg/bird.yml \\
        --output_dir is_bird --epochs 30 --set TRAIN.CLASS_NUM=50

then score with
    python -m eegan_tpu_torch.inception_score --eval_image_folder ... \\
        --is_classifier <SAVE_DIR>/is_bird/is_inception.pt --num_classes 51

Runs on ``--device cuda`` (default) and on the CPU only with
``--device cpu``. RUNTIME.MESH (``--set RUNTIME.MESH=data:N``; default
``data:-1``, every visible GPU) of N > 1 ranks trains on N processes on
this host, one per GPU (N CPU processes with ``--device cpu``; ranks
beyond the GPUs share them through gloo), each on
its rows of every batch with the global batch's batch-norm statistics
(``finetune_inception(mesh=...)``); rank 0 writes the classifier. The
batch must divide N.
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Fine-tune the IS Inception "
                                     "(PyTorch port)")
    parser.add_argument("--cfg", dest="cfg_file", default="cfg/bird.yml")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--output_dir", default="is_out")
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--manualSeed", type=int, default=3407)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--max_iters", type=int, default=None)
    parser.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="KEY=VALUE")
    return parser.parse_args(argv)


def load_config(args):
    from eegan_tpu_torch.config import apply_overrides, fresh_config

    config = fresh_config(args.cfg_file)
    apply_overrides(config, args.overrides)
    config.TRAIN.BATCH_SIZE = args.batch_size
    return config


def main(argv=None):
    args = parse_args(argv)

    import torch

    from eegan_tpu_torch import resolve_device
    from eegan_tpu_torch.parallel import distributed
    from eegan_tpu_torch.parallel.mesh import mesh_shape

    device = resolve_device(args.device)
    config = load_config(args)
    data, fsdp = mesh_shape(config.RUNTIME.MESH, torch.cuda.device_count()
                            if device.type == "cuda" else None, share=True)
    ranks = data * fsdp
    if config.TRAIN.BATCH_SIZE % ranks:
        raise SystemExit(f"batch size {config.TRAIN.BATCH_SIZE} not "
                         f"divisible by {ranks} devices")
    if ranks == 1:
        finetune(args, config, device)
        return
    distributed.spawn(_rank_main, sys.argv[1:] if argv is None else argv,
                      ranks, device)


def _rank_main(argv, device, mesh) -> None:
    """One rank of a one-host mesh fine-tune (``distributed.spawn``)."""
    args = parse_args(argv)
    finetune(args, load_config(args), device, mesh)


def finetune(args, config, device, mesh=None) -> None:
    from eegan_tpu_torch.evaluation.inception_finetune import (
        finetune_inception,
    )

    if args.synthetic:
        from eegan_tpu_torch.data.synthetic import SyntheticDataset

        dataset = SyntheticDataset(config)
    else:
        from eegan_tpu_torch.data.datasets import TextImageDataset

        dataset = TextImageDataset(config, split="train")

    out = os.path.join(config.SAVE_DIR or ".", args.output_dir)
    os.makedirs(out, exist_ok=True)
    finetune_inception(config, dataset, out, epochs=args.epochs,
                       seed=args.manualSeed, lr=args.lr,
                       max_iters_per_epoch=args.max_iters, device=device,
                       mesh=mesh)


if __name__ == "__main__":
    main()
