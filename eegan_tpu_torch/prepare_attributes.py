"""Offline attribute extraction CLI of the port (counterpart of the JAX
package's ``prepare_attributes.py``; reference `prepare_attributes.py`).

Builds ``<data_dir>/attributes/<attr_name>.pickle`` from captions.pickle via
POS tagging + chunk grammars (CPU processes; no accelerator needed). The
default lexicon tagger and the port's own chunker need no nltk.

    python -m eegan_tpu_torch.prepare_attributes --data_dir ../data/birds \\
        --dataset_name bird
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Extract caption attributes")
    parser.add_argument("--data_dir", default="../data/birds", type=str)
    parser.add_argument("--cap_filename", default="captions.pickle", type=str)
    parser.add_argument("--attr_name", default="EE-GAN", type=str)
    parser.add_argument("--dataset_name", default="bird", type=str,
                        choices=["bird", "flower", "coco"])
    parser.add_argument("--taggar_mode", default="lexicon",
                        choices=["lexicon", "perceptron", "stanford"])
    parser.add_argument("--taggar_file_path", default="", type=str)
    parser.add_argument("--jar_file_path", default="", type=str)
    parser.add_argument("--workers", type=int, default=16)
    parser.add_argument("--sampling", type=int, default=0,
                        help="print N parsed examples for eyeballing "
                             "(reference PrepareAttrs.sampling)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from eegan_tpu_torch.data.attributes import (
        AttributeExtractor,
        build_attributes_pickle,
    )

    if args.sampling:
        import numpy as np

        from eegan_tpu_torch.data.datasets import load_captions_pickle

        train_caps, _, ixtoword, wordtoix, _ = load_captions_pickle(args.data_dir)
        ex = AttributeExtractor(args.dataset_name, args.taggar_mode,
                                args.taggar_file_path, args.jar_file_path)
        rng = np.random.RandomState(0)
        for i in rng.randint(0, len(train_caps), args.sampling):
            words = [ixtoword[ix] for ix in train_caps[i]]
            attrs = ex.parse_caption(words)
            print(" ".join(words), "->", ["_".join(a) for a in attrs])
        return

    build_attributes_pickle(args.data_dir, args.dataset_name,
                            attr_name=args.attr_name,
                            tagger_mode=args.taggar_mode,
                            workers=args.workers)


if __name__ == "__main__":
    main()
