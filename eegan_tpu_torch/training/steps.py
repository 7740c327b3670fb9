"""The train step and the sampling step (counterpart of
``eegan_tpu/training/steps.py``).

One adversarial iteration (reference hot loop `train.py:148-211, 437-502`):

  1. frozen text encoding of caption + unpaired caption + attributes in ONE
     encoder call over 5B sequences;
  2. AttrEnhance + generator forward, ONCE: the D phase takes the images
     detached, the G phase backpropagates through the same graph;
  3. per scale: the hinge D step (real / fake / mismatch / class), an Adam
     update, then the MAGP gradient-penalty step as a SECOND Adam update at
     the freshly updated D parameters (the reference's two-step quirk,
     `train.py:452-459`);
  4. the G update against the *updated* discriminators, plus the DAMSM
     sentence, words and attribute losses through the frozen image encoder
     (`train.py:471-502`). D parameters get no gradient in this phase.

Unlike the JAX step, the noise is an input (JAX and torch random streams
differ, so a test passes the same noise to both), and the modules and
optimizers are updated in place. RUNTIME.PALLAS_AFFINE runs the generator's
affine layers through ``ops/affine.py`` (kernels 1 and 2 for CUDA tensors)
and RUNTIME.PALLAS_DAMSM the words loss through ``ops/damsm.py`` (kernels
3-5); neither is gated on a backend. RUNTIME.REMAT, REMAT_BLOCKS (and
REMAT_D with it) and REMAT_IMAGE_ENCODER are not ported: the step refuses
them. The sampling step runs the generator in eval mode.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from eegan_tpu_torch.config import Config
from eegan_tpu_torch.losses import damsm as damsm_losses
from eegan_tpu_torch.losses import gan as gan_losses
from eegan_tpu_torch.models.attr_enhance import AttrEnhance
from eegan_tpu_torch.models.factory import ModelBundle
from eegan_tpu_torch.ops.damsm import words_loss_fused
from eegan_tpu_torch.training.state import (
    FrozenEncoders,
    TrainState,
    clip_by_global_norm_,
    generator_params,
)

Batch = Dict[str, Any]
ABLATE_KEYS = frozenset({"text", "damsm", "words", "magp", "dsteps", "dcond"})


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def normalize_image_leaves(batch: Batch) -> Batch:
    """uint8 [0, 255] image leaves (RUNTIME.UINT8_TRANSFER) -> float32
    [-1, 1]; other leaves pass through."""
    out = dict(batch)
    for k, v in batch.items():
        if k.startswith("img") and v.dtype == torch.uint8:
            out[k] = v.float() / 127.5 - 1.0
    return out


def encode_text_bundle(frozen: FrozenEncoders, config: Config, batch: Batch,
                       lens_cpu: Batch):
    """One text-encoder call over [caps; unpair_caps; attrs] (5B
    sequences). ``lens_cpu`` holds the length leaves on the host (the
    packed RNN reads them there). Returns words (B, T, D), sent (B, D),
    unpair_sent (B, D) and attrs_emb (B, A, D), without gradient."""
    caps = batch["caps"]
    b, t = caps.shape
    a_num = config.TEXT.MAX_ATTR_NUM
    a_len = config.TEXT.MAX_ATTR_LEN
    attrs = F.pad(batch["attrs"].reshape(b * a_num, a_len), (0, t - a_len))
    attr_lens = lens_cpu["attr_lens"].reshape(b * a_num).clamp_min(1)
    caps_all = torch.cat([caps, batch["unpair_caps"], attrs.to(caps.dtype)])
    lens_all = torch.cat([lens_cpu["cap_lens"], lens_cpu["unpair_cap_lens"],
                          attr_lens.to(lens_cpu["cap_lens"].dtype)])
    with torch.no_grad():
        words_all, sent_all = frozen.text_encoder(caps_all, lens_all)
    return (words_all[:b], sent_all[:b], sent_all[b:2 * b],
            sent_all[2 * b:].reshape(b, a_num, -1))


def _check_runtime(config: Config, ablate) -> None:
    rt = config.RUNTIME
    unported = [k for k, on in (("REMAT", rt.REMAT),
                                ("REMAT_BLOCKS", bool(rt.REMAT_BLOCKS)),
                                ("REMAT_IMAGE_ENCODER",
                                 rt.REMAT_IMAGE_ENCODER)) if on]
    if unported:
        raise NotImplementedError(
            f"RUNTIME.{', RUNTIME.'.join(unported)} (activation "
            "rematerialisation) is not ported to the PyTorch train step")
    unknown = set(ablate) - ABLATE_KEYS
    if unknown:
        raise ValueError(f"unknown ablate keys {sorted(unknown)}")


def _zero_missing_grads(params) -> None:
    """A parameter off the loss's path gets a zero gradient, so Adam
    advances its step count and decays its second moment as optax does
    (``torch.optim.Adam`` skips a parameter whose grad is None)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def _gradient_penalty(disc, img, sent, is_class_scale: bool) -> torch.Tensor:
    """MAGP of one batch (chunk): the input gradients of sum(D(img, sent))
    with create_graph, so the penalty backpropagates into D."""
    img = img.detach().requires_grad_(True)
    sent = sent.detach().requires_grad_(True)
    out = disc.head(disc.features(img), sent)
    if is_class_scale:
        out = out[0]
    gi, gs = torch.autograd.grad(out.float().sum(), (img, sent),
                                 create_graph=True)
    return gan_losses.magp_from_grads(gi, gs)


def build_train_step_fn(config: Config, models: ModelBundle,
                        ablate: frozenset = frozenset()
                        ) -> Callable[..., Tuple[TrainState, Dict]]:
    """-> ``train_step(state, frozen, batch, noise) -> (state, metrics)``.

    ``batch``: the keys of ``data/synthetic.synthetic_batch`` (arrays or
    tensors; images NHWC float32 in [-1, 1], or uint8). ``noise``:
    (B, Z_DIM). ``metrics``: 0-d float32 tensors on the device, the JAX
    step's keys. ``ablate`` removes a phase for measurements only (the keys
    of the JAX step: text, damsm, words, magp, dsteps, dcond).
    """
    _check_runtime(config, ablate)
    n_scales = len(models.scales)
    rt, tr = config.RUNTIME, config.TRAIN
    use_class, class_coe = tr.USE_CLASS, tr.CLASS_COE
    sm = tr.SMOOTH
    dev = models.device

    def d_scale_update(i, disc, opt, real, fake, sent, unpair_sent,
                       class_labels) -> Dict[str, torch.Tensor]:
        """Hinge step, then the MAGP step (reference train.py:437-459)."""
        is_class_scale = use_class and i == n_scales - 1
        params = list(disc.parameters())
        opt.zero_grad(set_to_none=True)
        if rt.DENSE_D:
            # One 2B tower pass and one 3B head pass (D has no cross-batch
            # ops, so this is the separate passes' math).
            b2 = real.shape[0]
            feats = disc.features(torch.cat([real, fake]))
            feat_real, feat_fake = feats[:b2], feats[b2:]
            heads = disc.head(torch.cat([feat_real, feat_real, feat_fake]),
                              torch.cat([sent, unpair_sent, sent]))
            if is_class_scale:
                real_out, unpair_out, fake_out = heads[0].chunk(3)
                real_cls, unpair_cls, fake_cls = heads[1].chunk(3)
            else:
                real_out, unpair_out, fake_out = heads.chunk(3)
        else:
            feat_real = disc.features(real)
            feat_fake = disc.features(fake)
            h_real = disc.head(feat_real, sent)
            h_unpair = disc.head(feat_real, unpair_sent)
            h_fake = disc.head(feat_fake, sent)
            if is_class_scale:
                (real_out, real_cls), (unpair_out, unpair_cls), \
                    (fake_out, fake_cls) = h_real, h_unpair, h_fake
            else:
                real_out, unpair_out, fake_out = h_real, h_unpair, h_fake
        err_real = gan_losses.hinge_real(real_out)
        err_fake = gan_losses.hinge_fake(fake_out)
        err_unpair = gan_losses.hinge_fake(unpair_out)
        loss = gan_losses.d_hinge_total(err_real, err_fake, err_unpair)
        metrics = {"real_sent": err_real, "fake_sent": err_fake,
                   "unpair_sent": err_unpair}
        if is_class_scale:
            err_real_c = gan_losses.bce_with_logits(real_cls, class_labels)
            err_fake_c = gan_losses.bce_with_logits(fake_cls, class_labels)
            err_unpair_c = gan_losses.bce_with_logits(unpair_cls,
                                                      class_labels)
            loss = loss + (err_real_c + err_fake_c + err_unpair_c) / 3.0 \
                * class_coe
            metrics.update(real_class=err_real_c, fake_class=err_fake_c,
                           unpair_class=err_unpair_c)
        loss.backward()
        _zero_missing_grads(params)
        if tr.D_GRAD_CLIP > 0:
            clip_by_global_norm_(params, tr.D_GRAD_CLIP)
        opt.step()
        metrics = {f"errD_{i}/{k}": v.detach() for k, v in metrics.items()}

        # --- MAGP, a second step at the freshly updated parameters ---
        if "magp" in ablate:
            return metrics
        chunks = rt.MAGP_CHUNKS
        b = real.shape[0]
        if b % chunks:
            raise ValueError(f"MAGP_CHUNKS={chunks} must divide batch {b}")
        opt.zero_grad(set_to_none=True)
        # 2*mean(norm^6) over equal chunks is the full-batch mean; each
        # chunk's double-backward graph is freed before the next is built.
        gps = []
        for img_c, sent_c in zip(real.chunk(chunks), sent.chunk(chunks)):
            gp_c = _gradient_penalty(disc, img_c, sent_c, is_class_scale)
            (gp_c / chunks).backward()
            gps.append(gp_c.detach())
        # The class head is off the penalty's path.
        _zero_missing_grads(params)
        if tr.D_GRAD_CLIP > 0:
            clip_by_global_norm_(params, tr.D_GRAD_CLIP)
        opt.step()
        metrics[f"errD_{i}/d_loss_gp"] = torch.stack(gps).mean()
        return metrics

    def downstream_loss(state, frozen, imgs, merged, d_sent, sent, words,
                        batch, class_labels):
        """The G loss against the (updated) discriminators plus the DAMSM
        terms (reference train.py:419-435, 471-502)."""
        aux: Dict[str, torch.Tensor] = {}
        total = torch.zeros((), device=dev)
        for i, disc in enumerate(state.discriminators):
            out = disc.head(disc.features(imgs[i]), d_sent)
            if use_class and i == n_scales - 1:
                pair, cls = out
                err_g = -pair.float().mean()
                err_g_c = gan_losses.bce_with_logits(cls, class_labels)
                total = total + err_g + err_g_c * class_coe
                aux[f"errG/G_{i}_fake_class"] = err_g_c
            else:
                err_g = -out.float().mean()
                total = total + err_g
            aux[f"errG/G_{i}_fake_sent"] = err_g

        # Terms with a zero coefficient are dropped, so an ablated pathway
        # costs nothing and gives no gradient.
        need_s = tr.SENT_COE != 0
        need_w = tr.WORDS_COE != 0 and "words" not in ablate
        need_a = tr.ATTR_COE != 0
        zero = torch.zeros((), device=dev)
        s_loss = w_loss = a_loss = zero
        if "damsm" not in ablate and (need_s or need_w or need_a):
            region, code = frozen.image_encoder(imgs[-1])
            class_ids = batch["class_ids"]
            if need_s:
                s0, s1 = damsm_losses.sent_loss(code, sent, class_ids,
                                                sm.GAMMA3)
                s_loss = (s0 + s1) * sm.LAMBDA * tr.SENT_COE
            if need_w:
                words_loss = (words_loss_fused if rt.PALLAS_DAMSM
                              else damsm_losses.words_loss)
                w0, w1 = words_loss(region, words, batch["cap_lens"],
                                    class_ids, sm.GAMMA1, sm.GAMMA2,
                                    sm.GAMMA3)
                w_loss = (w0 + w1) * sm.LAMBDA * tr.WORDS_COE
            if need_a:
                a0, a1 = damsm_losses.sent_loss(code, merged.float(),
                                                class_ids, sm.GAMMA3)
                a_loss = (a0 + a1) * sm.LAMBDA * tr.ATTR_COE
        total = total + tr.SIM_COE * (s_loss + w_loss + a_loss)
        aux.update({"errG/s_loss": s_loss, "errG/w_loss": w_loss,
                    "errG/a_loss": a_loss, "errG/total": total})
        return total, aux

    def train_step(state: TrainState, frozen: FrozenEncoders, batch: Batch,
                   noise) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        host = {k: _tensor(v) for k, v in batch.items()}
        batch = normalize_image_leaves(
            {k: v.to(dev, non_blocking=True) for k, v in host.items()})
        if rt.BF16_IMAGES:
            # The D phases take bf16 pyramids (one extra bf16 rounding of
            # the images).
            batch = {k: v.to(torch.bfloat16) if k.startswith("img") else v
                     for k, v in batch.items()}
        b = batch["caps"].shape[0]
        if "text" in ablate:
            d = config.TEXT.EMBEDDING_DIM
            words = torch.zeros((b, batch["caps"].shape[1], d), device=dev)
            sent = unpair_sent = torch.zeros((b, d), device=dev)
            attrs_emb = torch.zeros((b, config.TEXT.MAX_ATTR_NUM, d),
                                    device=dev)
        else:
            words, sent, unpair_sent, attrs_emb = encode_text_bundle(
                frozen, config, batch, host)
        if "dcond" in ablate:
            # The discriminators (and MAGP) see zero sentence embeddings.
            d_sent, d_unpair = torch.zeros_like(sent), torch.zeros_like(
                unpair_sent)
        else:
            d_sent, d_unpair = sent, unpair_sent
        noise = _tensor(noise).to(dev, torch.float32)
        class_labels = (gan_losses.one_hot_class_labels(batch["class_ids"],
                                                        tr.CLASS_NUM)
                        if use_class else None)

        # ONE generator forward for the iteration (reference train.py:195).
        state.generator.train()
        state.attr_enhance.train()
        _, attn_attrs = state.attr_enhance(sent, attrs_emb)
        merged = AttrEnhance.attr_merge(attn_attrs)
        fake_imgs = state.generator(noise, sent, merged)
        fake_sg = [im.detach() for im in fake_imgs]
        if rt.BF16_IMAGES:
            fake_sg = [im.to(torch.bfloat16) for im in fake_sg]

        metrics: Dict[str, torch.Tensor] = {}
        if "dsteps" not in ablate:
            for i, (disc, opt) in enumerate(zip(state.discriminators,
                                                state.d_opts)):
                real = batch[f"img{models.scales[i]}"]
                metrics.update(d_scale_update(i, disc, opt, real, fake_sg[i],
                                              d_sent, d_unpair, class_labels))

        # --- G phase against the updated discriminators ---
        params = generator_params(state)
        state.g_opt.zero_grad(set_to_none=True)
        total, g_aux = downstream_loss(state, frozen, fake_imgs, merged,
                                       d_sent, sent, words, batch,
                                       class_labels)
        total.backward(inputs=params)
        _zero_missing_grads(params)
        state.g_opt.step()
        metrics.update({k: v.detach() for k, v in g_aux.items()})

        decay = tr.G_EMA_DECAY
        if decay > 0:
            with torch.no_grad():
                for ema, module in ((state.g_ema, state.generator),
                                    (state.attr_ema, state.attr_enhance)):
                    for name, p in module.named_parameters():
                        ema[name].mul_(decay).add_(p, alpha=1.0 - decay)
        state.step += 1
        return state, metrics

    return train_step


def make_train_step(config: Config, models: ModelBundle,
                    ablate: frozenset = frozenset()):
    """The train step, ``(state, frozen, batch, noise) -> (state,
    metrics)``; PyTorch runs it eagerly, so there is nothing to compile."""
    return build_train_step_fn(config, models, ablate=ablate)


def make_multi_train_step(config: Config, models: ModelBundle):
    """K train steps per call: ``(state, frozen, stacked_batch, noises) ->
    (state, metrics)`` with batch leaves (K, B, ...), noises (K, B, Z_DIM)
    and metrics stacked to (K,). The same step, K times in order."""
    train_step = build_train_step_fn(config, models)

    def multi_step(state, frozen, stacked_batch, noises):
        k = len(noises)
        per_step: List[Dict[str, torch.Tensor]] = []
        for j in range(k):
            batch = {name: v[j] for name, v in stacked_batch.items()}
            state, metrics = train_step(state, frozen, batch, noises[j])
            per_step.append(metrics)
        return state, {name: torch.stack([m[name] for m in per_step])
                       for name in per_step[0]}

    return multi_step


def make_sample_step(config: Config, models: ModelBundle
                     ) -> Callable[..., List[torch.Tensor]]:
    """-> ``sample(caps, cap_lens, attrs, attr_lens, noise)``.

    caps (B, WORDS_NUM) and cap_lens (B,) token ids and lengths; attrs
    (B, MAX_ATTR_NUM, MAX_ATTR_LEN) and attr_lens (B, MAX_ATTR_NUM); noise
    (B, Z_DIM). Arrays or tensors, on any device. Returns [img64, img128,
    img256], NHWC float32 in [-1, 1] on ``models.device``. Puts the three
    modules in eval mode and runs under ``torch.inference_mode()``.
    """
    a_num = config.TEXT.MAX_ATTR_NUM
    a_len = config.TEXT.MAX_ATTR_LEN
    words = config.TEXT.WORDS_NUM
    dev = models.device

    def sample(caps, cap_lens, attrs, attr_lens, noise) -> List[torch.Tensor]:
        caps, attrs = _tensor(caps).long(), _tensor(attrs).long()
        cap_lens, attr_lens = _tensor(cap_lens).long(), _tensor(attr_lens).long()
        b = caps.shape[0]
        # One text-encoder call over the captions and the flattened
        # attributes (padded to WORDS_NUM, lengths clamped to >= 1).
        flat_attrs = F.pad(attrs.reshape(b * a_num, a_len),
                           (0, words - a_len))
        flat_lens = attr_lens.reshape(b * a_num).clamp_min(1)
        caps_all = torch.cat([caps, flat_attrs.to(caps.device)])
        lens_all = torch.cat([cap_lens.cpu(), flat_lens.cpu()])
        for m in (models.text_encoder, models.attr_enhance, models.generator):
            m.eval()
        with torch.inference_mode():
            _, sent_all = models.text_encoder(caps_all.to(dev), lens_all)
            sent = sent_all[:b]
            attrs_emb = sent_all[b:].reshape(b, a_num, -1)
            _, attn_attrs = models.attr_enhance(sent, attrs_emb)
            merged = AttrEnhance.attr_merge(attn_attrs)
            noise = _tensor(noise).to(dev, torch.float32)
            return models.generator(noise, sent, merged)

    return sample
