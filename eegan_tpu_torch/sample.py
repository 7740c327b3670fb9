"""Sampling CLI of the port (counterpart of the JAX package's ``sample.py``).

    python -m eegan_tpu_torch.sample --from_code --device cuda \\
        --netG netG_600.pth --set TEXT.DAMSM_NAME=text_encoder200.pth

Sources (reference `sample.py:31-51,272-324`):
  --from_txt      free-text file, one caption per line; attributes parsed
                  live with the lexicon tagger
  --from_code     hardcoded example captions
  --from_dataset  a random batch (--batch_size) of --split's captions and
                  attributes, drawn as the JAX CLI draws it; the paired
                  real images and the captions are written beside the
                  samples

Weights come from reference-layout ``.pth`` files: ``--model_dir`` (a
directory of ``netG_<epoch>.pth`` + ``attr_enhance_<epoch>.pth``, as the
port's trainer writes them; ``--epoch``, by default the latest) or
``--netG`` (and ``--attr_enhance``, by default the netG path with ``netG``
replaced by ``attr_enhance``), and ``TEXT.DAMSM_NAME`` for the text
encoder (an AttnGAN ``.pth`` or a ``pretrain_damsm`` directory, as in
training). Without either the generator is random, which makes the run a
smoke run, so the encoders may be random too
(RUNTIME.ALLOW_RANDOM_ENCODERS), as in the JAX CLI. Per caption, the noise
is repeated --noise_times and grids + singles are written under
<SAVE_DIR>/<output_dir>/cap_{i}/.

Runs on ``--device cuda`` (default) and on the CPU only with
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

EXAMPLE_CAPTIONS = [
    "this bird is bright blue with a white belly and a short beak",
    "a small yellow bird with black wings and a pointed orange bill",
    "this large bird has a red crown white breast and long grey tail",
]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Sample images from EE-GAN "
                                     "(PyTorch port)")
    parser.add_argument("--cfg", dest="cfg_file", default="cfg/sample_bird.yml")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--gpu", dest="gpu_ids", type=str, default="0",
                        help="accepted for compatibility; use --device")
    parser.add_argument("--manualSeed", type=int, default=3407)
    parser.add_argument("--output_dir", default="example_bird")
    parser.add_argument("--netG", default="",
                        help="reference netG_{epoch}.pth")
    parser.add_argument("--attr_enhance", default="",
                        help="reference attr_enhance_{epoch}.pth "
                             "(default: derived from --netG)")
    parser.add_argument("--model_dir", default="",
                        help="dir of netG_<epoch>.pth + "
                             "attr_enhance_<epoch>.pth (the trainer's Model)")
    parser.add_argument("--epoch", type=int, default=0,
                        help="the --model_dir epoch (default: the latest)")
    parser.add_argument("--from_code", action="store_true")
    parser.add_argument("--from_dataset", action="store_true")
    parser.add_argument("--from_txt", action="store_true")
    parser.add_argument("--split", default="test")
    parser.add_argument("--txt_file", default="example.txt")
    parser.add_argument("--noise_times", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--taggar_mode", default="lexicon",
                        choices=["lexicon", "perceptron", "stanford"])
    parser.add_argument("--taggar_file_path", default="", type=str)
    parser.add_argument("--jar_file_path", default="", type=str)
    parser.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="KEY=VALUE",
                        help="config override, e.g. --set GAN.GF_DIM=16")
    args = parser.parse_args(argv)
    if args.model_dir and args.netG:
        parser.error("give --model_dir or --netG, not both")
    return args


def captions_to_tokens(captions, wordtoix, words_num):
    """Free text -> padded id arrays (reference `transfer_cap_tokens`,
    sample.py:226-245)."""
    from eegan_tpu_torch.data.prep import tokenize_caption

    caps = np.zeros((len(captions), words_num), np.int32)
    lens = np.ones(len(captions), np.int32)
    for i, text in enumerate(captions):
        ids = [wordtoix[w] for w in tokenize_caption(text) if w in wordtoix]
        ids = ids[:words_num]
        caps[i, :len(ids)] = ids
        lens[i] = max(len(ids), 1)
    return caps, lens


def attrs_to_tokens(attr_lists, wordtoix, max_num, max_len):
    """Parsed attribute phrases -> fixed grids (reference
    `transfer_attr_tokens`, sample.py:247-270)."""
    n = len(attr_lists)
    attrs = np.zeros((n, max_num, max_len), np.int32)
    attr_lens = np.ones((n, max_num), np.int32)
    for i, attr_set in enumerate(attr_lists):
        for j, attr in enumerate(attr_set[:max_num]):
            ids = [wordtoix[w] for w in attr if w in wordtoix][:max_len]
            if not ids:
                continue
            attrs[i, j, :len(ids)] = ids
            attr_lens[i, j] = len(ids)
    return attrs, attr_lens


def dataset_batch(dataset, batch_size: int, seed: int):
    """(caps, cap_lens, attrs, attr_lens, real 256² images) of a random
    batch of ``dataset``, drawn from ``default_rng([seed])`` in the JAX
    CLI's order (the indices, then each sample's draws; JAX
    `sample.py:122-125`)."""
    rng = np.random.default_rng([seed])
    idxs = rng.integers(0, len(dataset), batch_size)
    samples = [dataset.sample(int(i), rng) for i in idxs]
    top = dataset.imsizes[-1]
    return tuple(np.stack([s[k] for s in samples])
                 for k in ("caps", "cap_lens", "attrs", "attr_lens",
                           f"img{top}"))


def load_weights(config, models, netG: str, attr_enhance: str,
                 model_dir: str = "", epoch: int = 0) -> None:
    """Reference ``.pth`` weights into the bundle, or keep the random init
    where the smoke rule allows it."""
    from eegan_tpu_torch.training.checkpoint import CheckpointManager
    from eegan_tpu_torch.training.state import FrozenEncoders
    from eegan_tpu_torch.training.trainer import load_frozen_encoders
    from eegan_tpu_torch.utils.convert import load_state_dict

    if model_dir:
        ckpt = CheckpointManager(model_dir)
        epochs = ckpt.available_generator_epochs()
        epoch = epoch or (epochs[-1] if epochs else 0)
        if epoch not in epochs:
            raise FileNotFoundError(
                f"no netG_{epoch or '<epoch>'}.pth under {model_dir}")
        ckpt.load_generator(epoch, models.generator, models.attr_enhance)
        print(f"loaded generator epoch {epoch} from {model_dir}")
    elif netG:
        models.generator.load_state_dict(load_state_dict(netG))
        attr_path = attr_enhance or os.path.join(
            os.path.dirname(netG),
            os.path.basename(netG).replace("netG", "attr_enhance"))
        models.attr_enhance.load_state_dict(load_state_dict(attr_path))
        print(f"loaded generator {netG} and AttrEnhance {attr_path}")
    else:
        # No generator checkpoint: a smoke run by construction (random G),
        # so the encoders need not be real either (as the JAX CLI does).
        config.RUNTIME.ALLOW_RANDOM_ENCODERS = True
        print("WARNING: no --netG or --model_dir given — sampling from "
              "random weights")

    # The DAMSM encoders as training resolves them (an AttnGAN .pth, or a
    # pretrain_damsm directory); random ones only in smoke mode.
    load_frozen_encoders(config, FrozenEncoders(models.text_encoder,
                                                models.image_encoder))


def main(argv=None):
    args = parse_args(argv)

    import torch

    from eegan_tpu_torch import resolve_device
    from eegan_tpu_torch.config import apply_overrides, fresh_config
    from eegan_tpu_torch.data.attributes import AttributeExtractor
    from eegan_tpu_torch.data.datasets import (
        TextImageDataset,
        load_captions_pickle,
    )
    from eegan_tpu_torch.models.factory import build_models
    from eegan_tpu_torch.training.steps import make_sample_step
    from eegan_tpu_torch.utils.images import (
        mkdir_p,
        save_img_grid,
        save_img_results_one_by_one,
        save_text_results,
    )

    device = resolve_device(args.device)
    config = fresh_config(args.cfg_file)
    apply_overrides(config, args.overrides)
    t = config.TEXT
    visual_dir = os.path.join(config.SAVE_DIR or ".", args.output_dir)
    mkdir_p(visual_dir)

    _, _, ixtoword, wordtoix, n_words = load_captions_pickle(config.DATA_DIR)

    if args.from_dataset:
        caps, cap_lens, attrs, attr_lens, real_imgs = dataset_batch(
            TextImageDataset(config, split=args.split), args.batch_size,
            args.manualSeed)
        texts = [" ".join(ixtoword[int(w)] for w in c[:n])
                 for c, n in zip(caps, cap_lens)]
        # The paired real images (grid + singles) and the captions and
        # attributes, for side-by-side viewing (reference sample.py:280-286).
        real_dir = os.path.join(visual_dir, "real_images")
        save_img_results_one_by_one(
            real_imgs, [f"cap_{i}" for i in range(len(real_imgs))], real_dir)
        save_img_grid(real_imgs, os.path.join(real_dir, "real_images.png"))
        save_text_results(caps, cap_lens, ixtoword,
                          os.path.join(visual_dir, "dataset_example.txt"),
                          attrs, attr_lens)
    else:
        if args.from_txt:
            with open(args.txt_file) as f:
                texts = [line.strip() for line in f if line.strip()]
        else:  # --from_code
            texts = EXAMPLE_CAPTIONS
        extractor = AttributeExtractor(
            config.DATASET_NAME, args.taggar_mode, args.taggar_file_path,
            args.jar_file_path)
        attr_lists = [extractor.parse_caption(text) for text in texts]
        for i, (text, al) in enumerate(zip(texts, attr_lists)):
            print(f"#{i} {text}  | attrs: {['_'.join(a) for a in al]}")
        caps, cap_lens = captions_to_tokens(texts, wordtoix, t.WORDS_NUM)
        attrs, attr_lens = attrs_to_tokens(attr_lists, wordtoix,
                                           t.MAX_ATTR_NUM, t.MAX_ATTR_LEN)

    torch.manual_seed(args.manualSeed)
    models = build_models(config, n_words, device)
    load_weights(config, models, args.netG, args.attr_enhance,
                 args.model_dir, args.epoch)
    sample_step = make_sample_step(config, models)

    for cap_i in range(len(caps)):
        b = args.noise_times
        gen = torch.Generator().manual_seed(args.manualSeed * 7919 + cap_i)
        noise = torch.randn((b, config.GAN.Z_DIM), generator=gen)
        imgs = sample_step(np.repeat(caps[cap_i][None], b, 0),
                           np.repeat(cap_lens[cap_i][None], b, 0),
                           np.repeat(attrs[cap_i][None], b, 0),
                           np.repeat(attr_lens[cap_i][None], b, 0), noise)
        img256 = imgs[-1].cpu().numpy()
        save_dir = os.path.join(visual_dir, f"cap_{cap_i}")
        mkdir_p(save_dir)
        save_img_grid(img256, os.path.join(save_dir, "samples.png"))
        save_img_results_one_by_one(
            img256, [f"sample_{j}" for j in range(b)], save_dir)
        with open(os.path.join(save_dir, "caption.txt"), "w") as f:
            f.write(texts[cap_i] + "\n")
    print(f"saved samples for {len(caps)} captions under {visual_dir}")


if __name__ == "__main__":
    main()
