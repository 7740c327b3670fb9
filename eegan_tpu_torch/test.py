"""Checkpoint evaluation sweep CLI of the port (counterpart of the JAX
package's ``test.py``; reference `test.py`):

    python -m eegan_tpu_torch.test --cfg cfg/bird.yml --output_dir my_run \\
        --select_epochs 550:700:10 --compare_sim --saving_image

Generates --sampling_nums images per (epoch, repeat) from the test captions
into ``<SAVE_DIR>/<output_dir>/GenImage/Epoch_{e}_{r}/`` (with
--saving_image) and scores R-precision (--compare_sim), from the
``netG_<epoch>.pth`` + ``attr_enhance_<epoch>.pth`` snapshots under
--model_dir (default ``<SAVE_DIR>/<output_dir>/Model``, where the port's
trainer writes them). The frozen encoders follow TEXT.DAMSM_NAME as in
training (--debug allows random ones). Runs on ``--device cuda`` (default)
and on the CPU only with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate EE-GAN checkpoints "
                                     "(PyTorch port)")
    parser.add_argument("--cfg", dest="cfg_file", default="cfg/bird.yml")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--gpu", dest="gpu_ids", type=str, default="0",
                        help="accepted for compatibility; use --device")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--output_dir", default="")
    parser.add_argument("--debug_output_dir", default="debug")
    parser.add_argument("--model_dir", default="",
                        help="dir holding netG_{epoch}.pth snapshots "
                             "(default: <output_dir>/Model)")
    parser.add_argument("--repeat_times", type=int, default=1)
    parser.add_argument("--sampling_nums", type=int, default=30000)
    parser.add_argument("--regard_sent", action="store_true",
                        help="traverse sentences instead of images")
    parser.add_argument("--select_epochs", type=str, default="",
                        help="comma list or start:end:step; default "
                             "550:700:10")
    parser.add_argument("--saving_image", action="store_true",
                        help="write generated PNGs (reference test.py:44); "
                             "omit with --compare_sim for an R-precision-only "
                             "sweep with no image IO")
    parser.add_argument("--compare_sim", action="store_true",
                        help="compute R-precision")
    parser.add_argument("--manualSeed", type=int, default=3407)
    parser.add_argument("--batch_size", type=int, default=0)
    parser.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="KEY=VALUE",
                        help="config override, e.g. --set GAN.GF_DIM=16")
    return parser.parse_args(argv)


def parse_epochs(spec: str):
    """'' -> 550..700 step 10 (reference test.py:96-97); 'a,b,c' or
    'a:b[:s]' (inclusive, step 10 by default)."""
    if not spec:
        return list(range(550, 710, 10))
    if ":" in spec:
        parts = [int(p) for p in spec.split(":")]
        st, ed = parts[0], parts[1]
        step = parts[2] if len(parts) > 2 else 10
        return list(range(st, ed + step, step))
    return [int(p) for p in spec.split(",")]


def main(argv=None):
    args = parse_args(argv)

    import torch

    from eegan_tpu_torch import resolve_device
    from eegan_tpu_torch.config import apply_overrides, fresh_config
    from eegan_tpu_torch.data.datasets import TextOnlyDataset
    from eegan_tpu_torch.evaluation.tester import Tester
    from eegan_tpu_torch.models.factory import build_models
    from eegan_tpu_torch.training.checkpoint import CheckpointManager
    from eegan_tpu_torch.training.state import create_train_state
    from eegan_tpu_torch.training.trainer import load_frozen_encoders
    from eegan_tpu_torch.utils.images import mkdir_p

    device = resolve_device(args.device)
    config = fresh_config(args.cfg_file)
    apply_overrides(config, args.overrides)
    if args.batch_size:
        config.TRAIN.BATCH_SIZE = args.batch_size
    if args.debug:
        # Debug sweeps may run without the pretrained DAMSM encoders;
        # production sweeps hard-require them (load_frozen_encoders).
        config.RUNTIME.ALLOW_RANDOM_ENCODERS = True

    out_root = os.path.join(config.SAVE_DIR or ".",
                            args.debug_output_dir if args.debug
                            else (args.output_dir or "eval"))
    gen_root = os.path.join(out_root, "GenImage")
    mkdir_p(gen_root)

    dataset = TextOnlyDataset(config, split="test",
                              regard_sent=args.regard_sent)
    torch.manual_seed(args.manualSeed)
    models = build_models(config, dataset.n_words, device)
    _, init_frozen = create_train_state(config, models)
    frozen = load_frozen_encoders(config, init_frozen)

    ckpt = CheckpointManager(args.model_dir or os.path.join(out_root,
                                                            "Model"))
    epochs = parse_epochs(args.select_epochs)
    available = ckpt.available_generator_epochs()
    epochs = [e for e in epochs if e in available] or available
    print(f"evaluating epochs: {epochs}")
    if not args.saving_image and not args.compare_sim:
        print("note: neither --saving_image nor --compare_sim given — "
              "generating without scoring or writing (reference behaviour)")

    tester = Tester(config, models, frozen, dataset)
    results = tester.sweep(ckpt, epochs, args.repeat_times, gen_root,
                           sampling_nums=args.sampling_nums,
                           compute_r_precision=args.compare_sim,
                           saving_images=args.saving_image)
    for (e, r), res in results.items():
        print(f"Epoch_{e}_{r}: {res}")


if __name__ == "__main__":
    main()
