"""FID CLI of the port (counterpart of the JAX package's
``metrics/fid_score.py``; reference `metrics/FID/fid_score.py:296-305`):

    python -m eegan_tpu_torch.fid_score --eval_image_folder <run>/GenImage \\
        --compared_path bird_val.npz --select_epochs 550:700:10

Sweeps ``<eval_image_folder>/Epoch_{e}_{r}/`` (or scores one folder)
against dataset statistics (an .npz with mu/sigma, or a folder of real
images). --gen_npz writes the statistics of --eval_image_folder;
--dataset_npz writes those of --cfg's dataset (--split, random crops).
--inception_ckpt loads a torchvision-layout Inception-v3 ``.pth`` (the
port's keys are torchvision's); without it the weights are random and the
numbers are relative only. Runs on ``--device cuda`` (default) and on the
CPU only with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="FID measurement "
                                     "(PyTorch port)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--compared_path", "--compare_path",
                        dest="compared_path",
                        default="../data/Models/IS_model/bird_val.npz",
                        help=".npz stats or folder of real images")
    parser.add_argument("--eval_image_folder", type=str, default="",
                        help="root containing Epoch_{e}_{r}/ folders, or a "
                             "single image folder")
    parser.add_argument("--select_epochs", type=str, default="550:700:10")
    parser.add_argument("--repeat_times", type=int, default=1)
    parser.add_argument("--max_images", type=int, default=30000)
    parser.add_argument("--batch_size", type=int, default=50)
    parser.add_argument("--inception_ckpt", type=str, default="",
                        help="torchvision-layout Inception-v3 .pth (else "
                             "random weights — relative comparisons only)")
    parser.add_argument("--gen_npz", type=str, default="",
                        help="write the stats npz of --eval_image_folder")
    parser.add_argument("--dataset_npz", type=str, default="",
                        help="write the stats npz of the dataset itself "
                             "(random crops; needs --cfg)")
    parser.add_argument("--cfg", type=str, default="",
                        help="config for --dataset_npz")
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="KEY=VALUE",
                        help="config override for --dataset_npz")
    args = parser.parse_args(argv)
    if not args.dataset_npz and not args.eval_image_folder:
        parser.error("--eval_image_folder is required (unless "
                     "--dataset_npz)")
    return args


def main(argv=None):
    args = parse_args(argv)

    from eegan_tpu_torch.evaluation.fid import (
        FIDExtractor,
        MeasureFID,
        activation_statistics,
        save_npz_stats,
    )
    from eegan_tpu_torch.models.inception import InceptionV3
    from eegan_tpu_torch.test import parse_epochs
    from eegan_tpu_torch.utils.convert import load_reference, load_state_dict

    model = None
    if args.inception_ckpt:
        model = InceptionV3(num_classes=0)
        load_reference(model, load_state_dict(args.inception_ckpt),
                       args.inception_ckpt)
    extractor = FIDExtractor(model, batch_size=args.batch_size,
                             device=args.device)
    measure = MeasureFID(extractor)

    if args.dataset_npz:
        from eegan_tpu_torch.config import apply_overrides, fresh_config
        from eegan_tpu_torch.evaluation.fid import dataset_statistics

        config = fresh_config(args.cfg)
        apply_overrides(config, args.overrides)
        mu, sigma = dataset_statistics(config, extractor, split=args.split,
                                       n_images=args.max_images)
        save_npz_stats(args.dataset_npz, mu, sigma)
        print(f"saved dataset stats -> {args.dataset_npz}")
        return

    if args.gen_npz:
        feats = extractor.features_from_folder(args.eval_image_folder,
                                               args.max_images)
        mu, sigma = activation_statistics(feats)
        save_npz_stats(args.gen_npz, mu, sigma)
        print(f"saved stats for {len(feats)} images -> {args.gen_npz}")
        return

    root = args.eval_image_folder
    if any(d.startswith("Epoch_") for d in os.listdir(root)):
        results = measure.sweep(args.compared_path, root,
                                parse_epochs(args.select_epochs),
                                range(args.repeat_times),
                                max_images=args.max_images)
        for (e, r), fid in sorted(results.items()):
            print(f"Epoch_{e}_{r}: FID = {fid:.3f}")
    else:
        fid = measure.fid_between(args.compared_path, root, args.max_images)
        print(f"FID = {fid:.3f}")


if __name__ == "__main__":
    main()
