"""Pretrain the DAMSM text/image encoders (sentence + word contrastive),
the port's counterpart of the JAX package's ``pretrain_damsm.py``:

    python -m eegan_tpu_torch.pretrain_damsm --cfg cfg/bird.yml \\
        --output_dir damsm_bird --epochs 200

The encoders land in <SAVE_DIR>/<output_dir>/Model/frozen_encoders, which
TEXT.DAMSM_NAME can name (or its parent Model dir) for
``python -m eegan_tpu_torch.train``. Runs on ``--device cuda`` (default)
and on the CPU only with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Pretrain DAMSM encoders "
                                     "(PyTorch port)")
    parser.add_argument("--cfg", dest="cfg_file", default="cfg/bird.yml")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--output_dir", default="damsm_out")
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--batch_size", type=int, default=48)
    parser.add_argument("--manualSeed", type=int, default=3407)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--max_iters", type=int, default=None)
    parser.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="KEY=VALUE",
                        help="config override, e.g. --set GAN.GF_DIM=16")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from eegan_tpu_torch import resolve_device
    from eegan_tpu_torch.config import apply_overrides, fresh_config
    from eegan_tpu_torch.models.factory import build_models
    from eegan_tpu_torch.training.damsm_trainer import pretrain_damsm

    device = resolve_device(args.device)
    config = fresh_config(args.cfg_file)
    apply_overrides(config, args.overrides)
    config.TRAIN.BATCH_SIZE = args.batch_size

    if args.synthetic:
        from eegan_tpu_torch.data.synthetic import SyntheticDataset

        dataset = SyntheticDataset(config)
    else:
        from eegan_tpu_torch.data.datasets import TextImageDataset

        dataset = TextImageDataset(config, split="train")

    torch.manual_seed(args.manualSeed)
    models = build_models(config, dataset.n_words, device)

    out = os.path.join(config.SAVE_DIR or ".", args.output_dir)
    os.makedirs(out, exist_ok=True)
    pretrain_damsm(config, models, dataset, out, epochs=args.epochs,
                   seed=args.manualSeed, max_iters_per_epoch=args.max_iters)


if __name__ == "__main__":
    main()
