"""Checkpoints with full train-state resume (counterpart of
``eegan_tpu/training/checkpoint.py``, on ``torch.save`` in place of Orbax).

Layout under ``model_dir``:

* ``state/<epoch>.pt``: the whole train state — the generator, AttrEnhance
  and discriminator ``state_dict``s (BN running stats included), both
  optimizers' ``state_dict``s, the EMA dicts and ``step`` — so a run
  resumes where it stopped (the reference restarts at epoch 1);
* ``netG_<epoch>.pth`` + ``attr_enhance_<epoch>.pth``: epoch-stamped
  generator snapshots in the reference's state-dict layout (the EMA
  weights when G-EMA is on), which ``python -m eegan_tpu_torch.sample
  --netG`` loads;
* ``frozen_encoders/{text,image}_encoder.pth``: DAMSM encoders in the
  AttnGAN layout (``TEXT.DAMSM_NAME`` may name the directory or its parent
  ``Model`` dir).

Every file is written to a temporary name and renamed, so a crash leaves
the previous checkpoint whole. The state lives in ``nn.Module``s and
optimizers that the step updates in place, so a restore loads into them:
the optimizers keep referring to the modules' parameters. Files hold the
unsharded layout (``training/state.py:full_state_dict``), so a state saved
under one mesh resumes under another. Under FSDP reading the state out is
collective: ``Trainer`` calls ``full_state_dict`` and
``generator_weights`` on every rank and hands rank 0's result here.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from eegan_tpu_torch.training.state import (
    FrozenEncoders,
    TrainState,
    full_state_dict,
    generator_weights,
    load_full_state_dict,
)

FROZEN_DIR = "frozen_encoders"
FROZEN_FILES = {"text_encoder": "text_encoder.pth",
                "image_encoder": "image_encoder.pth"}


def atomic_save(obj, path: str) -> None:
    """``torch.save`` to a temporary file in the same directory, then an
    atomic rename onto ``path``."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=directory)
    os.close(fd)
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, model_dir: str):
        self.model_dir = os.path.abspath(model_dir)
        self.state_dir = os.path.join(self.model_dir, "state")
        os.makedirs(self.model_dir, exist_ok=True)

    # -- full train state (resume) -------------------------------------
    def state_path(self, epoch: int) -> str:
        return os.path.join(self.state_dir, f"{epoch}.pt")

    def saved_epochs(self) -> List[int]:
        out = []
        if not os.path.isdir(self.state_dir):
            return out
        for name in os.listdir(self.state_dir):
            stem, ext = os.path.splitext(name)
            if ext == ".pt" and stem.isdigit():
                out.append(int(stem))
        return sorted(out)

    def save_state(self, epoch: int, state: TrainState,
                   full: Optional[Dict] = None) -> str:
        """Write the state (``full``: its :func:`full_state_dict`, when the
        caller has it) as ``state/<epoch>.pt``."""
        path = self.state_path(epoch)
        full = full_state_dict(state) if full is None else full
        atomic_save(_cpu({"epoch": epoch, **full}), path)
        return path

    def latest_epoch(self) -> Optional[int]:
        epochs = self.saved_epochs()
        return epochs[-1] if epochs else None

    def restore_state(self, state: TrainState, epoch: Optional[int] = None
                      ) -> Tuple[TrainState, int]:
        """Load the checkpoint of ``epoch`` (default: the latest) into
        ``state``'s modules, optimizers and EMA dicts, in place.

        A checkpoint written before TRAIN.G_EMA_DECAY was turned on has no
        EMA: then (and only then) the EMA is seeded from the restored
        parameters. Every other failure — an unreadable file, a mismatched
        module or optimizer, EMA dicts that do not match the state's —
        propagates.
        """
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {self.model_dir}")
        saved = torch.load(self.state_path(epoch), map_location="cpu",
                           weights_only=True)
        load_full_state_dict(state, saved)
        return state, int(epoch)

    # -- epoch-stamped generator snapshots (eval sweep input) ----------
    def generator_paths(self, epoch: int) -> Tuple[str, str]:
        return (os.path.join(self.model_dir, f"netG_{epoch}.pth"),
                os.path.join(self.model_dir, f"attr_enhance_{epoch}.pth"))

    def save_generator(self, epoch: int, state: TrainState,
                       weights: Optional[Tuple[Dict, Dict]] = None) -> str:
        """netG_{epoch}.pth + attr_enhance_{epoch}.pth (reference
        train.py:308-315). They feed sampling and evaluation, so with G-EMA
        on they carry the EMA parameters (the raw ones live in the
        full-state checkpoints); the generator's BN running stats are the
        live ones either way. ``weights``: the state's
        :func:`generator_weights`, when the caller has them."""
        g_path, a_path = self.generator_paths(epoch)
        weights = generator_weights(state) if weights is None else weights
        for module, w, path in ((state.generator, weights[0], g_path),
                                (state.attr_enhance, weights[1], a_path)):
            sd = module.state_dict()
            sd.update(w)
            atomic_save(_cpu(sd), path)
        return g_path

    def load_generator(self, epoch: int, generator: nn.Module,
                       attr_enhance: nn.Module) -> None:
        """Load netG_{epoch} into ``generator`` and ``attr_enhance``."""
        g_path, a_path = self.generator_paths(epoch)
        for module, path in ((generator, g_path), (attr_enhance, a_path)):
            module.load_state_dict(torch.load(path, map_location="cpu",
                                              weights_only=True))

    def available_generator_epochs(self) -> List[int]:
        out = []
        for name in os.listdir(self.model_dir):
            stem, ext = os.path.splitext(name)
            if ext == ".pth" and stem.startswith("netG_") \
                    and stem[5:].isdigit():
                out.append(int(stem[5:]))
        return sorted(out)

    # -- frozen DAMSM encoders -----------------------------------------
    def save_frozen(self, frozen: FrozenEncoders,
                    path: Optional[str] = None) -> str:
        """Both encoders' state dicts, in the AttnGAN key layout, under
        ``path`` (default ``<model_dir>/frozen_encoders``)."""
        path = path or os.path.join(self.model_dir, FROZEN_DIR)
        for attr, name in FROZEN_FILES.items():
            atomic_save(_cpu(getattr(frozen, attr).state_dict()),
                        os.path.join(path, name))
        return path

    def load_frozen(self, frozen: FrozenEncoders,
                    path: Optional[str] = None) -> FrozenEncoders:
        """Load the encoders saved by :meth:`save_frozen` into ``frozen``'s
        modules."""
        return load_frozen_dir(path or os.path.join(self.model_dir,
                                                    FROZEN_DIR), frozen)


def load_frozen_dir(path: str, frozen: FrozenEncoders) -> FrozenEncoders:
    for attr, name in FROZEN_FILES.items():
        getattr(frozen, attr).load_state_dict(torch.load(
            os.path.join(path, name), map_location="cpu", weights_only=True))
    return frozen
