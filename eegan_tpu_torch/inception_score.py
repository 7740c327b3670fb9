"""Inception Score CLI of the port (counterpart of the JAX package's
``metrics/inception_score.py``; reference
`metrics/IS_TF/inception_score.py`):

    python -m eegan_tpu_torch.inception_score \\
        --eval_image_folder <run>/GenImage --is_classifier is_bird/is_inception.pt

Scores image folders (the Epoch_{e}_{r} sweep, or one folder) with IS =
exp(mean KL) over --splits splits. The classifier: --is_classifier (the
``is_inception.pt`` that ``python -m eegan_tpu_torch.finetune_inception``
writes, its class count from --cfg's TRAIN.CLASS_NUM set to
--num_classes - 1) or --inception_ckpt (a torchvision-layout ``.pth``);
without either the weights are random and the score is only a pipeline
check. Runs on ``--device cuda`` (default) and on the CPU only with
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Inception Score "
                                     "(PyTorch port)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--eval_image_folder", type=str, required=True)
    parser.add_argument("--select_epochs", type=str, default="550:700:10")
    parser.add_argument("--repeat_times", type=int, default=1)
    parser.add_argument("--splits", type=int, default=10)
    parser.add_argument("--max_images", type=int, default=30000)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_classes", type=int, default=51,
                        help="50 birds / 20 flowers + 1 background "
                             "(reference inception_score.py:41-51)")
    parser.add_argument("--inception_ckpt", type=str, default="",
                        help="torchvision-layout Inception-v3 .pth")
    parser.add_argument("--is_classifier", type=str, default="",
                        help="is_inception.pt from finetune_inception")
    parser.add_argument("--cfg", type=str, default="cfg/bird.yml",
                        help="config (class count) for --is_classifier")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from eegan_tpu_torch.evaluation.inception_score import InceptionScorer
    from eegan_tpu_torch.models.inception import InceptionV3
    from eegan_tpu_torch.test import parse_epochs

    model = None
    if args.is_classifier:
        from eegan_tpu_torch.config import fresh_config
        from eegan_tpu_torch.evaluation.inception_finetune import (
            load_is_classifier,
        )

        config = fresh_config(args.cfg)
        config.TRAIN.CLASS_NUM = args.num_classes - 1
        model = load_is_classifier(args.is_classifier, config, args.device)
    elif args.inception_ckpt:
        from eegan_tpu_torch.utils.convert import (
            load_reference,
            load_state_dict,
        )

        model = InceptionV3(num_classes=args.num_classes)
        load_reference(model, load_state_dict(args.inception_ckpt),
                       args.inception_ckpt)
    else:
        print("WARNING: no --is_classifier or --inception_ckpt — scores use "
              "random weights and are not comparable to published numbers")

    scorer = InceptionScorer(model, num_classes=args.num_classes,
                             batch_size=args.batch_size, device=args.device)

    root = args.eval_image_folder
    if any(d.startswith("Epoch_") for d in os.listdir(root)):
        for e in parse_epochs(args.select_epochs):
            for r in range(args.repeat_times):
                folder = os.path.join(root, f"Epoch_{e}_{r}")
                if not os.path.isdir(folder):
                    continue
                mean, std = scorer.score_folder(folder, args.splits,
                                                args.max_images)
                print(f"Epoch_{e}_{r}: IS = {mean:.3f} +- {std:.3f}")
    else:
        mean, std = scorer.score_folder(root, args.splits, args.max_images)
        print(f"IS = {mean:.3f} +- {std:.3f}")


if __name__ == "__main__":
    main()
