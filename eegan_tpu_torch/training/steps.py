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
3-5); neither is gated on a backend. RUNTIME.REMAT, REMAT_BLOCKS, REMAT_D
and REMAT_IMAGE_ENCODER checkpoint the modules as the factory built them.
The sampling step runs the generator in eval mode.

Under a running ``torch.profiler`` each step is the span
``eegan.train.step`` (``training/logging.py:span``), and its phases are
sibling spans under it, so each moment of a step has at most one:
``train.text``, ``train.generator``, ``train.d_hinge.<scale>`` (zeroing
the D's gradients through the hinge's backward), ``train.d_magp.<scale>``
(the MAGP's chunks and their backward), ``train.g_loss`` (the G loss and
its backward), ``train.update`` (each of the seven optimizer updates,
with the D's FSDP gather after it) and ``train.ema``. A sampling call is
``sample.step`` holding ``sample.text`` and ``sample.generator``.

On a card without a mesh the D phase (every scale's hinge and MAGP steps
with their Adam updates) runs as CUDA graphs (``training/d_graph.py``),
captured once the D optimizers hold state and replayed every step, each
replay under the span its eager unit runs under and a nested
``train.d_graph``; ``d_graph.eager_reason`` keeps it eager where a replay
could not do what the eager phase does (a mesh, an ablation, a
checkpointed D, an optimizer step hook, another batch shape...).

With a ``mesh`` (``parallel/mesh.py``, one process per device) each rank
takes its rows of the global batch and of the global noise, and the step
computes the JAX step's global-batch math: the generator's batch norms sum
their statistics over the ranks, the DAMSM losses contrast the whole batch,
the gradients are averaged over the ranks before each of the three Adam
updates (and before the D's clipping), and the metrics are averaged so
that each rank returns the global batch's. The discriminators have no
batch norm, so their phase needs only the gradient average. Without a mesh
the step carries no collective.

With an fsdp axis (the state from ``create_train_state(..., mesh)``,
``parallel/fsdp.py``) the modules are empty between steps. The step
gathers the full parameters of every trainable module first; after each
optimizer update whose parameters are used again in the step (the D's
hinge update before its MAGP, the MAGP update before the G phase) it
gathers that module again, so nothing reads a stale gather. Backward fills
the full gradients, which the ranks average and the D's clipping reads as
in the data-parallel step; each rank then keeps its slice of them for
Adam. The EMA update runs on the slices, and the full parameters are
released after the G update (under REMAT, after the backward that
recomputes from them).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from eegan_tpu_torch.config import Config
from eegan_tpu_torch.losses import damsm as damsm_losses
from eegan_tpu_torch.losses import gan as gan_losses
from eegan_tpu_torch.models.attr_enhance import AttrEnhance
from eegan_tpu_torch.models.factory import ModelBundle
from eegan_tpu_torch.models.layers import TorchBatchNorm, input_grads_only
from eegan_tpu_torch.ops.damsm import words_loss_fused
from eegan_tpu_torch.parallel.fsdp import ShardedModule, has_fsdp_axis
from eegan_tpu_torch.parallel.mesh import Mesh, check_axes
from eegan_tpu_torch.training import d_graph
from eegan_tpu_torch.training.logging import span
from eegan_tpu_torch.training.state import (
    FrozenEncoders,
    TrainState,
    clip_by_global_norm_,
    generator_params,
    trained_tensors,
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
    check_axes(config.RUNTIME.MESH)
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


def _apply_update(opt, params, mesh: Optional[Mesh], clip: float,
                  sharded: Sequence[ShardedModule] = ()) -> None:
    """One optimizer update from the gradients in ``params``: zeros for
    parameters off the loss's path, the ranks' average, the global-norm
    clip (``clip`` > 0), then Adam. Under FSDP (``sharded``: the modules
    of ``opt``) each sharded gradient is reduce-scattered into the rank's
    slice (``ShardedModule.reduce_scatter_grads``), the replicated ones
    are averaged over every rank, the clip's norm counts both, and the
    slices' gradients are freed after Adam, so none outlives the step."""
    _zero_missing_grads(params)
    slices = [t for m in sharded for t in m.reduce_scatter_grads()]
    replicated = ([p for m in sharded for p in m.replicated()] if sharded
                  else params)
    if mesh is not None:
        mesh.average_gradients_(replicated)
    if clip > 0:
        clip_by_global_norm_(replicated, clip, slices,
                             mesh.fsdp_group if sharded else None)
    opt.step()
    if sharded:
        opt.zero_grad(set_to_none=True)


def _gradient_penalty(disc, img, sent, is_class_scale: bool) -> torch.Tensor:
    """MAGP of one batch (chunk): the input gradients of sum(D(img, sent))
    with create_graph, so the penalty backpropagates into D. The first
    backward computes no weight gradient (:func:`input_grads_only`), and at
    the class scale the class logits, which the penalty does not read, are
    not computed."""
    img = img.detach().requires_grad_(True)
    sent = sent.detach().requires_grad_(True)
    with input_grads_only():
        feat = disc.features(img)
        out = (disc.COND_DNET.pair_logit(feat, sent) if is_class_scale
               else disc.head(feat, sent))
    gi, gs = torch.autograd.grad(out.float().sum(), (img, sent),
                                 create_graph=True)
    return gan_losses.magp_from_grads(gi, gs)


def build_train_step_fn(config: Config, models: ModelBundle,
                        ablate: frozenset = frozenset(),
                        mesh: Optional[Mesh] = None
                        ) -> Callable[..., Tuple[TrainState, Dict]]:
    """-> ``train_step(state, frozen, batch, noise) -> (state, metrics)``.

    ``batch``: the keys of ``data/synthetic.synthetic_batch`` (arrays or
    tensors; images NHWC float32 in [-1, 1], or uint8). ``noise``:
    (B, Z_DIM). ``metrics``: 0-d float32 tensors on the device, the JAX
    step's keys. ``ablate`` removes a phase for measurements only (the keys
    of the JAX step: text, damsm, words, magp, dsteps, dcond). With a
    ``mesh``, ``batch`` and ``noise`` are this rank's rows of the global
    ones (:meth:`Mesh.shard_batch`) and ``metrics`` the global batch's; the
    generator's batch norms are bound to the mesh.
    """
    _check_runtime(config, ablate)
    if mesh is not None:
        for m in models.generator.modules():
            if isinstance(m, TorchBatchNorm):
                m.mesh = mesh
    n_scales = len(models.scales)
    rt, tr = config.RUNTIME, config.TRAIN
    use_class, class_coe = tr.USE_CLASS, tr.CLASS_COE
    sm = tr.SMOOTH
    dev = models.device
    # The D spans carry their scale in the name (a span's arguments do not
    # reach the Chrome trace); built once, so a step allocates no name.
    hinge_spans = [f"train.d_hinge.{i}" for i in range(n_scales)]
    magp_spans = [f"train.d_magp.{i}" for i in range(n_scales)]

    def hinge_unit(i, disc, opt, real, fake, sent, unpair_sent,
                   class_labels) -> Dict[str, torch.Tensor]:
        """Zero the D's gradients, its hinge loss and the loss's backward:
        the metrics by name."""
        opt.zero_grad(set_to_none=True)
        loss, metrics = hinge_loss(use_class and i == n_scales - 1, disc,
                                   real, fake, sent, unpair_sent,
                                   class_labels)
        loss.backward()
        return {f"errD_{i}/{k}": v.detach() for k, v in metrics.items()}

    def magp_unit(i, disc, opt, real, sent) -> torch.Tensor:
        """Zero the D's gradients, the MAGP over RUNTIME.MAGP_CHUNKS equal
        chunks and each chunk's backward: the penalty. 2*mean(norm^6)
        over equal chunks is the full-batch mean; each chunk's
        double-backward graph is freed before the next is built."""
        chunks = rt.MAGP_CHUNKS
        b = real.shape[0]
        if b % chunks:
            raise ValueError(f"MAGP_CHUNKS={chunks} must divide batch {b}")
        opt.zero_grad(set_to_none=True)
        gps = []
        for img_c, sent_c in zip(real.chunk(chunks), sent.chunk(chunks)):
            gp_c = _gradient_penalty(disc, img_c, sent_c,
                                     use_class and i == n_scales - 1)
            (gp_c / chunks).backward()
            gps.append(gp_c.detach())
        return torch.stack(gps).mean()

    def d_scale_update(i, disc, opt, real, fake, sent, unpair_sent,
                       class_labels, sharded: Sequence[ShardedModule]
                       ) -> Dict[str, torch.Tensor]:
        """Hinge step, then the MAGP step (reference train.py:437-459),
        eagerly. Under FSDP (``sharded``: the D's module) the D is
        gathered again after each update, for the MAGP and for the G
        phase."""
        params = list(disc.parameters())

        def update():
            with span("train.update"):
                _apply_update(opt, params, mesh, tr.D_GRAD_CLIP, sharded)
                for m in sharded:
                    m.gather()

        with span(hinge_spans[i]):
            metrics = hinge_unit(i, disc, opt, real, fake, sent, unpair_sent,
                                 class_labels)
        update()

        # --- MAGP, a second step at the freshly updated parameters ---
        if "magp" in ablate:
            return metrics
        with span(magp_spans[i]):
            metrics[f"errD_{i}/d_loss_gp"] = magp_unit(i, disc, opt, real,
                                                       sent)
        # The class head is off the penalty's path (a zero gradient).
        update()
        return metrics

    def d_phase(state, inputs: d_graph.Inputs, shards
                ) -> Dict[str, torch.Tensor]:
        """Every scale's hinge and MAGP steps: replayed from the state's
        capture of them when :func:`d_graph.eager_reason` allows (captured
        first when there is none), else eagerly."""
        discs, opts = state.discriminators, state.d_opts
        graphs = state.d_graphs
        if graphs is not None and graphs.stale(opts):
            state.d_graphs = graphs = None
        reason = d_graph.eager_reason(
            dev, mesh, ablate, discs, opts, inputs,
            None if graphs is None else graphs.signature)
        d_graph.count(reason)
        if reason is None:
            if graphs is None:
                state.d_graphs = graphs = d_graph.capture(
                    graph_units(discs, opts), inputs, opts)
            return graphs.run(inputs, hinge_spans, magp_spans)
        metrics: Dict[str, torch.Tensor] = {}
        for i, (disc, opt) in enumerate(zip(discs, opts)):
            metrics.update(d_scale_update(
                i, disc, opt, inputs.reals[i], inputs.fakes[i], inputs.sent,
                inputs.unpair_sent, inputs.class_labels,
                () if shards is None else (shards.discriminators[i],)))
        return metrics

    def graph_units(discs, opts) -> d_graph.Units:
        """The units :func:`d_graph.capture` records, as
        :func:`d_scale_update` runs them (no mesh, no FSDP)."""
        params = [list(d.parameters()) for d in discs]

        def hinge(i, x: d_graph.Inputs):
            return hinge_unit(i, discs[i], opts[i], x.reals[i], x.fakes[i],
                              x.sent, x.unpair_sent, x.class_labels)

        def magp(i, x: d_graph.Inputs):
            return magp_unit(i, discs[i], opts[i], x.reals[i], x.sent)

        def update(i):
            _apply_update(opts[i], params[i], None, tr.D_GRAD_CLIP)

        return d_graph.Units(hinge, magp, update)

    def hinge_loss(is_class_scale, disc, real, fake, sent, unpair_sent,
                   class_labels):
        """The D's hinge loss (and at the class scale its class loss):
        (loss, metrics by short name)."""
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
        return loss, metrics

    def downstream_loss(state, frozen, imgs, merged, d_sent, sent, words,
                        batch, class_labels):
        """The G loss against the (updated) discriminators plus the DAMSM
        terms (reference train.py:419-435, 471-502)."""
        aux: Dict[str, torch.Tensor] = {}
        total = torch.zeros((), device=dev)
        for i, disc in enumerate(state.discriminators):
            # The backward fills the generator's gradients only.
            with input_grads_only():
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
                                                sm.GAMMA3, mesh=mesh)
                s_loss = (s0 + s1) * sm.LAMBDA * tr.SENT_COE
            if need_w:
                words_loss = (words_loss_fused if rt.PALLAS_DAMSM
                              else damsm_losses.words_loss)
                w0, w1 = words_loss(region, words, batch["cap_lens"],
                                    class_ids, sm.GAMMA1, sm.GAMMA2,
                                    sm.GAMMA3, mesh=mesh)
                w_loss = (w0 + w1) * sm.LAMBDA * tr.WORDS_COE
            if need_a:
                a0, a1 = damsm_losses.sent_loss(code, merged.float(),
                                                class_ids, sm.GAMMA3,
                                                mesh=mesh)
                a_loss = (a0 + a1) * sm.LAMBDA * tr.ATTR_COE
        total = total + tr.SIM_COE * (s_loss + w_loss + a_loss)
        aux.update({"errG/s_loss": s_loss, "errG/w_loss": w_loss,
                    "errG/a_loss": a_loss, "errG/total": total})
        return total, aux

    def train_step(state: TrainState, frozen: FrozenEncoders, batch: Batch,
                   noise) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with span("train.step"):
            return step(state, frozen, batch, noise)

    def step(state, frozen, batch, noise):
        shards = state.shards
        if (shards is not None) != has_fsdp_axis(mesh):
            raise ValueError("a state sharded over an fsdp axis needs a mesh "
                             "with that axis, and the other way round")
        if shards is not None:
            shards.gather()
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
            with span("train.text"):
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
        with span("train.generator"):
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
            metrics.update(d_phase(state, d_graph.Inputs(
                [batch[f"img{s}"] for s in models.scales], fake_sg, d_sent,
                d_unpair, class_labels), shards))

        # --- G phase against the updated discriminators ---
        params = generator_params(state)
        with span("train.g_loss"):
            state.g_opt.zero_grad(set_to_none=True)
            total, g_aux = downstream_loss(state, frozen, fake_imgs, merged,
                                           d_sent, sent, words, batch,
                                           class_labels)
            total.backward(inputs=params)
        with span("train.update"):
            _apply_update(state.g_opt, params, mesh, 0.0,
                          () if shards is None else (shards.generator,
                                                     shards.attr_enhance))
        if shards is not None:
            shards.release()
        metrics.update({k: v.detach() for k, v in g_aux.items()})
        if mesh is not None:
            metrics = dict(zip(metrics, mesh.average(list(metrics.values()))))

        decay = tr.G_EMA_DECAY
        if decay > 0:
            with span("train.ema"), torch.no_grad():
                for ema, module in ((state.g_ema, state.generator),
                                    (state.attr_ema, state.attr_enhance)):
                    for name, p in trained_tensors(module, shards):
                        ema[name].mul_(decay).add_(p, alpha=1.0 - decay)
        state.step += 1
        return state, metrics

    return train_step


def make_train_step(config: Config, models: ModelBundle,
                    ablate: frozenset = frozenset(),
                    mesh: Optional[Mesh] = None):
    """The train step, ``(state, frozen, batch, noise) -> (state,
    metrics)``; PyTorch runs it eagerly, so there is nothing to compile."""
    return build_train_step_fn(config, models, ablate=ablate, mesh=mesh)


def make_multi_train_step(config: Config, models: ModelBundle,
                          mesh: Optional[Mesh] = None):
    """K train steps per call: ``(state, frozen, stacked_batch, noises) ->
    (state, metrics)`` with batch leaves (K, B, ...), noises (K, B, Z_DIM)
    and metrics stacked to (K,). The same step, K times in order."""
    train_step = build_train_step_fn(config, models, mesh=mesh)

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
        with span("sample.step"):
            return sample_body(caps, cap_lens, attrs, attr_lens, noise)

    def sample_body(caps, cap_lens, attrs, attr_lens, noise):
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
            with span("sample.text"):
                _, sent_all = models.text_encoder(caps_all.to(dev), lens_all)
            sent = sent_all[:b]
            attrs_emb = sent_all[b:].reshape(b, a_num, -1)
            noise = _tensor(noise).to(dev, torch.float32)
            with span("sample.generator"):
                _, attn_attrs = models.attr_enhance(sent, attrs_emb)
                merged = AttrEnhance.attr_merge(attn_attrs)
                return models.generator(noise, sent, merged)

    return sample
