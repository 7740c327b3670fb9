"""Weights into the port: from the JAX package's trees and from ``.pth`` files.

:func:`load_damsm_encoders` loads AttnGAN's ``text_encoder*.pth`` /
``image_encoder*.pth`` (the counterpart of
``eegan_tpu/utils/torch_convert.py::load_damsm_encoders``).

The port's modules carry the reference EE-GAN / AttnGAN state-dict key
names and torch layouts, so a reference ``.pth`` loads with
``load_state_dict`` once the DataParallel ``module.`` prefix is stripped
(:func:`load_state_dict`). The ``from_jax_*`` functions turn the JAX
package's numpy parameter trees (``{"params": ..., "batch_stats": ...}``)
into the port's state dicts — the inverse of
``eegan_tpu/utils/torch_convert.py``:

* conv kernel (kh, kw, I, O)  -> weight (O, I, kh, kw)
* dense kernel (I, O)         -> weight (O, I)
* BN scale/bias + batch_stats mean/var -> weight/bias/running_mean/running_var
  (plus ``num_batches_tracked`` = 0, which the JAX trees do not carry)
* LSTM/GRU weights verbatim (the JAX text encoder stores torch's layout).
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict on the CPU, with ``module.`` prefixes stripped
    (the reference saves G wrapped in DataParallel, train.py:219-220)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k.removeprefix("module."): v for k, v in sd.items()}


def load_reference(module: torch.nn.Module, sd: Dict[str, torch.Tensor],
                    what: str) -> None:
    """A reference state dict into ``module``. Keys the module lacks are
    ignored, as the JAX package's converter ignores them; a missing key
    raises, except BN's ``num_batches_tracked`` (older torch wrote none);
    a shape mismatch raises."""
    own = module.state_dict()
    missing = [k for k in own if k not in sd
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{what}: torch keys {missing[:5]} missing; have e.g. "
                       f"{list(sd)[:5]}")
    module.load_state_dict({k: v for k, v in sd.items() if k in own},
                           strict=False)


def load_damsm_encoders(text_pth: str, frozen):
    """Load both DAMSM encoders from AttnGAN ``.pth`` files into
    ``frozen``'s modules (``training/state.FrozenEncoders``) and return it.

    The image encoder's path follows the reference's substitution rule
    text_encoder -> image_encoder (reference `train.py:242`); when that file
    is missing the image encoder keeps its weights, with a warning, as in
    the JAX package.
    """
    load_reference(frozen.text_encoder, load_state_dict(text_pth), text_pth)
    img_pth = text_pth.replace("text_encoder", "image_encoder")
    if os.path.isfile(img_pth):
        load_reference(frozen.image_encoder, load_state_dict(img_pth),
                        img_pth)
    else:
        print(f"WARNING: {img_pth} not found — image encoder stays random")
    return frozen


def _leaves(tree, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (str(key),))
        else:
            yield path + (str(key),), np.array(value, np.float32)


def _torch_key(path: Tuple[str, ...], collection: str) -> Optional[str]:
    """Flax variable path -> torch state-dict key (before renames)."""
    leaf, prefix = path[-1], ".".join(path[:-1])
    if collection == "batch_stats":
        return {"mean": f"{prefix}.running_mean",
                "var": f"{prefix}.running_var"}.get(leaf)
    if leaf in ("kernel", "scale"):
        return f"{prefix}.weight"
    return f"{prefix}.{leaf}" if prefix else leaf


def _torch_layout(path: Tuple[str, ...], w: np.ndarray) -> np.ndarray:
    if w.ndim == 4:
        return w.transpose(3, 2, 0, 1)
    if path[-1] == "kernel" and w.ndim == 2:
        return w.transpose(1, 0)
    return w


def _gen_rename(tk: str) -> str:
    """JAX generator names -> reference `Gen` keys (the inverse view of
    ``eegan_tpu/utils/torch_convert.py:_gen_rename``)."""
    for head in ("fc_gamma", "fc_beta"):
        for lin in ("linear1", "linear2"):
            tk = tk.replace(f"{head}_{lin}", f"{head}.{lin}")
    for i in range(7):
        tk = tk.replace(f"block{i}.", f"blocks.{i}.")
    for mask_head in ("conv_mask", "init_mask"):
        tk = tk.replace(f"{mask_head}.conv1.", f"{mask_head}.0.")
        tk = tk.replace(f"{mask_head}.bn.", f"{mask_head}.1.")
        tk = tk.replace(f"{mask_head}.conv2.", f"{mask_head}.3.")
    for img_head in ("get_image_64", "get_image_128", "get_image_256"):
        tk = tk.replace(f"{img_head}.bn.", f"{img_head}.0.")
        tk = tk.replace(f"{img_head}.conv.", f"{img_head}.2.")
    for cum in ("cum_64", "cum_128", "cum_256"):
        tk = tk.replace(f"{cum}.up_conv1.", f"{cum}.up_block.0.")
        tk = tk.replace(f"{cum}.up_conv3.", f"{cum}.up_block.2.")
        tk = tk.replace(f"{cum}.fuse.", f"{cum}.fuse_block.")
    return tk


def _convert(variables, rename=None) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, w in _leaves(variables.get(collection, {})):
            key = _torch_key(path, collection)
            if key is None:
                continue
            if rename is not None:
                key = rename(key)
            sd[key] = torch.from_numpy(
                np.ascontiguousarray(_torch_layout(path, w)))
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key.removesuffix("running_mean") + "num_batches_tracked"] = \
            torch.tensor(0)
    return sd


def from_jax_generator(variables) -> Dict[str, torch.Tensor]:
    """JAX ``Generator`` params + batch_stats -> the port's state dict."""
    return _convert(variables, _gen_rename)


def from_jax_attr_enhance(variables) -> Dict[str, torch.Tensor]:
    """JAX ``AttrEnhance`` params -> the port's state dict."""
    return _convert(variables)


def _disc_rename(tk: str) -> str:
    """JAX discriminator names -> reference `Dis*` keys (the inverse view
    of ``eegan_tpu/utils/torch_convert.py:_disc_rename``): ResDown's
    conv_r1/conv_r2 are Sequential indices 0/2 of ``conv_r``, DiscSent's
    joint_conv1/2 indices 0/2 of ``joint_conv``, DiscCond's joinConv index
    0."""
    tk = tk.replace("conv_r1.", "conv_r.0.")
    tk = tk.replace("conv_r2.", "conv_r.2.")
    tk = tk.replace("joint_conv1.", "joint_conv.0.")
    tk = tk.replace("joint_conv2.", "joint_conv.2.")
    return tk.replace("joinConv.", "joinConv.0.")


def from_jax_discriminator(variables) -> Dict[str, torch.Tensor]:
    """JAX ``Discriminator`` params -> the port's state dict."""
    return _convert(variables, _disc_rename)


def from_jax_image_encoder(variables) -> Dict[str, torch.Tensor]:
    """JAX ``ImageEncoder`` params + batch_stats -> the port's (reference
    CNN_ENCODER) state dict: the trunk's keys lose the ``inception.``
    prefix of the JAX tree."""
    return _convert(variables, lambda tk: tk.removeprefix("inception."))


def from_jax_text_encoder(variables) -> Dict[str, torch.Tensor]:
    """JAX ``TextEncoder`` params -> the port's (reference RNN_ENCODER)
    state dict: ``encoder.weight`` and ``rnn.{weight,bias}_{ih,hh}_l0
    [_reverse]``, weights verbatim."""
    params = variables["params"]
    sd = {"encoder.weight": torch.from_numpy(
        np.asarray(params["embedding"], np.float32).copy())}
    for direction in ("rnn_fwd", "rnn_bwd"):
        for name, w in params.get(direction, {}).items():
            kind, rest = name.split("_", 1)  # "w_ih_l0" -> ("w", "ih_l0")
            key = {"w": "weight", "b": "bias"}[kind] + "_" + rest
            sd[f"rnn.{key}"] = torch.from_numpy(
                np.asarray(w, np.float32).copy())
    return sd
