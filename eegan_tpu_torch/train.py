"""Training CLI of the port (counterpart of the JAX package's ``train.py``).

    python -m eegan_tpu_torch.train --cfg cfg/bird.yml --output_dir my_run \\
        --batch_size 32

Keeps ``train.py``'s flags (reference `train.py:37-56` plus --dtype,
--synthetic, --max_epochs, --max_iters, --profile_steps) and adds --device
(``cuda`` by default; the CPU only with ``--device cpu``). --gpu is
accepted and ignored, as in the JAX CLI. --mesh (default RUNTIME.MESH,
``data:-1``: every visible GPU) of N > 1 ranks (``data:N``, or
``data:D,fsdp:F`` for N = D·F, the train state sharded over each F
consecutive ranks) starts N processes on this host, one per GPU (N CPU
processes with ``--device cpu``), joined by gloo or NCCL through a local
coordinator; --batch_size stays the global batch, split over all N ranks.
--distributed makes this process one rank of a group the environment
describes (``parallel/distributed.py``); the ranks span the mesh's data
and fsdp axes. Any other axis beyond 1 raises ``NotImplementedError``, and
a mesh of more ranks than visible GPUs raises. --profile_steps writes a ``torch.profiler`` trace to
<output_dir>/profile/trace.json (host operations and, on a GPU, the
device's; input shapes are no longer recorded). Beside the operations it holds the port's
spans (``training/logging.py:span``), each named ``eegan.<name>``:
``train.step`` around each step and, under it, its phases ``train.text``,
``train.generator``, ``train.d_hinge.<scale>``, ``train.d_magp.<scale>``,
``train.g_loss``, ``train.update`` (seven a step) and ``train.ema``; the op
entries ``ops.words_similarity.fwd`` / ``.bwd_dr`` / ``.bwd_dw`` and
``ops.affine_mask_relu.fwd`` / ``.bwd`` inside the phase that calls them;
``trainer.data_wait``, ``trainer.save_model`` and ``trainer.save_images``;
and on a mesh ``mesh.average_gradients``, ``fsdp.gather`` and
``fsdp.reduce_scatter``. --eval_overlap scores each generator
snapshot (FID against --fid_stats, R-precision) on a background thread
while training goes on (``evaluation/async_eval.py``).
"""

from __future__ import annotations

import argparse
import datetime
import os
import pprint
import shutil
import sys

import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train an EE-GAN network "
                                     "(PyTorch port)")
    parser.add_argument("--cfg", dest="cfg_file", default="cfg/bird.yml",
                        help="optional config file")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--gpu", dest="gpu_ids", type=str, default="0",
                        help="ignored (kept for CLI compatibility); use "
                             "--device")
    parser.add_argument("--output_dir", dest="output_dir", default="../EE-GAN",
                        help="the path to save models and images")
    parser.add_argument("--debug_output_dir", dest="debug_output_dir",
                        default="Debug",
                        help="the path to save models and images in debug mode")
    parser.add_argument("--debug", action="store_true", help="debug mode: "
                        "in-process data loading, Debug/ output dir")
    parser.add_argument("--manualSeed", type=int, default=3407)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--class_coe", type=float, default=10)
    parser.add_argument("--sim_coe", type=float, default=0.05)
    parser.add_argument("--mesh", type=str, default=None,
                        help="mesh spec, e.g. data:4 or data:2,fsdp:2: one "
                             "process per GPU (CPU processes with --device "
                             "cpu); default: RUNTIME.MESH")
    parser.add_argument("--dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="compute dtype override")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic data (smoke mode)")
    parser.add_argument("--max_epochs", type=int, default=None,
                        help="stop after N epochs (smoke/CI)")
    parser.add_argument("--max_iters", type=int, default=None,
                        help="cap iterations per epoch (smoke/CI)")
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="capture a torch.profiler trace of N steps")
    parser.add_argument("--eval_overlap", action="store_true",
                        help="score each generator snapshot (FID/R-precision)"
                             " on a background thread during training")
    parser.add_argument("--eval_nums", type=int, default=2048,
                        help="images per overlapped evaluation")
    parser.add_argument("--fid_stats", type=str, default="",
                        help="dataset mu/sigma .npz (or real-image folder)"
                             " for overlapped FID")
    parser.add_argument("--distributed", action="store_true",
                        help="this process is one rank of a multi-host group:"
                             " EEGAN_COORDINATOR/NUM_PROCESSES/PROCESS_ID "
                             "(or torchrun's env://)")
    parser.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="KEY=VALUE",
                        help="config override, e.g. --set GAN.GF_DIM=16")
    return parser.parse_args(argv)


def load_config(args):
    from eegan_tpu_torch.config import apply_overrides, fresh_config

    config = fresh_config(args.cfg_file)
    apply_overrides(config, args.overrides)
    config.TRAIN.BATCH_SIZE = args.batch_size
    config.TRAIN.CLASS_COE = args.class_coe
    config.TRAIN.SIM_COE = args.sim_coe
    if args.mesh:
        config.RUNTIME.MESH = args.mesh
    if args.dtype:
        config.RUNTIME.COMPUTE_DTYPE = args.dtype
    return config


def main(argv=None):
    args = parse_args(argv)

    from eegan_tpu_torch import resolve_device
    from eegan_tpu_torch.parallel import distributed
    from eegan_tpu_torch.parallel.mesh import Mesh, check_axes, mesh_shape

    device = resolve_device(args.device)
    config = load_config(args)
    check_axes(config.RUNTIME.MESH)

    if args.distributed:
        distributed.initialize(device=device)
        try:
            rank_device = device
            if device.type == "cuda":
                rank_device = torch.device("cuda", torch.distributed.get_rank()
                                           % torch.cuda.device_count())
                torch.cuda.set_device(rank_device)
            world = torch.distributed.get_world_size()
            data, fsdp = mesh_shape(config.RUNTIME.MESH, world)
            if data * fsdp != world:
                raise ValueError(
                    f"mesh {config.RUNTIME.MESH!r} asks for {data * fsdp} "
                    f"ranks; the process group has {world}")
            train(args, config, rank_device,
                  Mesh.current(rank_device, fsdp=fsdp))
        finally:
            distributed.shutdown()
        return

    visible = torch.cuda.device_count() if device.type == "cuda" else None
    data, fsdp = mesh_shape(config.RUNTIME.MESH, visible)
    ranks = data * fsdp
    if ranks == 1:
        train(args, config, device)
        return
    distributed.spawn(_rank_main, sys.argv[1:] if argv is None else argv,
                      ranks, device, fsdp)


def _rank_main(argv, device, mesh) -> None:
    """One rank of a one-host ``--mesh`` run (``distributed.spawn``)."""
    args = parse_args(argv)
    train(args, load_config(args), device, mesh)


def train(args, config, device, mesh=None) -> None:
    """Build the Trainer (on one rank of ``mesh``, if given) and run it."""
    main_rank = mesh is None or mesh.rank == 0
    if mesh is not None:
        print(f"rank {mesh.rank} of {mesh.size} on {device}, backend "
              f"{torch.distributed.get_backend()}", flush=True)
    if main_rank:
        print("Using config:")
        pprint.pprint(config.to_dict())

    # Output dir layout mirrors the reference (`train.py:529-543`).
    if args.debug:
        output_dir = os.path.join(config.SAVE_DIR or ".", args.debug_output_dir)
    elif args.output_dir == "":
        stamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        output_dir = os.path.join(config.SAVE_DIR or ".",
                                  f"{config.DATASET_NAME}_{stamp}")
    else:
        output_dir = os.path.join(config.SAVE_DIR or ".", args.output_dir)
    if mesh is not None and args.output_dir == "" and not args.debug:
        # Every rank writes under rank 0's time stamp.
        box = [output_dir]
        torch.distributed.broadcast_object_list(box, src=0)
        output_dir = box[0]
    if main_rank:
        os.makedirs(output_dir, exist_ok=True)
        # Run provenance: copy entrypoint + cfg into the output dir.
        try:
            shutil.copy2(sys.argv[0], output_dir)
            shutil.copy2(args.cfg_file, output_dir)
        except (shutil.SameFileError, OSError):
            pass

    from eegan_tpu_torch.training.trainer import Trainer

    dataset = None
    if args.synthetic:
        from eegan_tpu_torch.data.synthetic import SyntheticDataset

        dataset = SyntheticDataset(config)
        # Smoke mode: random frozen encoders are acceptable here and only
        # here (load_frozen_encoders hard-fails otherwise).
        config.RUNTIME.ALLOW_RANDOM_ENCODERS = True

    workers = 0 if args.debug else None
    trainer = Trainer(config, output_dir, dataset=dataset,
                      seed=args.manualSeed, data_workers=workers,
                      device=device, mesh=mesh)
    if args.eval_overlap and main_rank:
        from eegan_tpu_torch.data.datasets import TextOnlyDataset
        from eegan_tpu_torch.evaluation.async_eval import (
            AsyncEvaluator,
            eval_bundle,
        )
        from eegan_tpu_torch.evaluation.tester import Tester

        eval_ds = (dataset if args.synthetic
                   else TextOnlyDataset(config, split="test"))
        tester = Tester(config, eval_bundle(trainer.models,
                                            trainer.state.shards),
                        trainer.frozen,
                        eval_ds, batch_size=config.TRAIN.BATCH_SIZE)
        trainer.async_eval = AsyncEvaluator(
            tester, writer=trainer.writer,
            real_stats=args.fid_stats or None, eval_nums=args.eval_nums,
            compute_r_precision=not args.synthetic)
    try:
        trainer.train(max_epochs=args.max_epochs,
                      max_iters_per_epoch=args.max_iters,
                      profile_steps=args.profile_steps)
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
