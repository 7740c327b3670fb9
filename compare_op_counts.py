#!/usr/bin/env python
"""Operation counts of the port's train step against the JAX package's, by
part, on the CPU.

    env JAX_PLATFORMS=cpu python compare_op_counts.py [--width 16]
        [--batch 4] [--parts] [--repairs_undone]

For each part, at the same widths and batch (float32, USE_CLASS on with
200 classes, PALLAS_DAMSM and PALLAS_AFFINE off, DENSE_D on,
MAGP_CHUNKS=1, FUSED_UPSAMPLE on):

* ``jax_flops``: XLA's ``compiled.cost_analysis()['flops']`` of the part
  jitted on the CPU (what the JAX package's ``bench.py`` reads);
* ``jax_products``: the products in that compiled program
  (:func:`hlo_products`: every ``convolution`` and ``dot``), counted as
  ``torch.utils.flop_counter`` counts them, so the two packages' products
  compare like for like;
* ``port``: the port's count of the same modules
  (``eegan_tpu_torch/utils/opcount.py``).

The parts: the DAMSM sentence and words losses with their gradients by
the image features, the generator's forward (with AttrEnhance), one D's
forward,
one D's hinge step (loss and weight gradients), one D's MAGP input
gradient, one D's whole MAGP step (that gradient, the penalty and its
backward into the weights), the Inception encoder's forward, the G phase
(the Ds and the DAMSM losses back into the generator), the text encoder
and the whole step. Weights are random on both sides: a count depends on
the shapes alone. The whole step, the MAGP rows and the encoders count the
port's own functions (``make_train_step``, ``steps._gradient_penalty``,
``encode_text_bundle``); the hinge step and the G phase are closures of
the train step that cannot be called alone, so their rows count copies of
that code written here, as the JAX rows count copies of the JAX step's.
``--repairs_undone`` counts the port with the MAGP's repairs undone
(:func:`magp_repairs_undone`): the step as it was before them. Prints one
JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import sys
from typing import Callable, Dict

N_WORDS = 5450


# --------------------------------------------------------------------------
# Products in an XLA program
# --------------------------------------------------------------------------

_DEF = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*\w+\[([\d,]*)\]\S*\s+"
                  r"([\w\-]+)\((.*)$")


def _dims(text: str):
    return [int(d) for d in text.split(",") if d]


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def hlo_products(hlo_text: str) -> Dict[str, int]:
    """Operations of the ``convolution`` and ``dot`` instructions of an
    optimised HLO module, at 2 per multiply-add and over every tap of a
    padded window, as ``torch.utils.flop_counter`` counts a convolution
    (XLA's own count leaves out the taps that fall on padding, and adds the
    elementwise operations). XLA writes the input gradient of a strided
    conv as a conv with an input dilation, and that of a VALID conv as one
    padded by the kernel's size less one: such a conv counts as the conv it
    differentiates, over the positions of its (undilated) input, as
    PyTorch's count of ``convolution_backward`` does. Instructions inside
    a loop body count once."""
    shapes: Dict[str, list] = {}
    rows = []
    for line in hlo_text.splitlines():
        m = _DEF.match(line)
        if not m:
            continue
        name, dims, op, rest = m.groups()
        shapes[name] = _dims(dims)
        if op in ("convolution", "dot"):
            rows.append((op, _dims(dims), rest))
    out = {"convolution": 0, "dot": 0}
    for op, out_shape, rest in rows:
        operands = re.findall(r"%([\w.\-]+)", rest.split(")")[0])
        lhs, rhs = (shapes[o] for o in operands[:2])
        if op == "dot":
            contract = _dims(re.search(r"lhs_contracting_dims=\{([\d,]*)\}",
                                       rest).group(1))
            out["dot"] += 2 * _prod(out_shape) * _prod(lhs[d]
                                                         for d in contract)
            continue
        labels = re.search(r"dim_labels=(\w+)_(\w+)->(\w+)", rest).groups()
        kernel = dict(zip(labels[1], rhs))
        spatial = sorted(k for k in kernel if k.isdigit())
        taps = [kernel[k] for k in spatial]
        ops = 2 * _prod(out_shape) * _prod(taps) * kernel["i"]
        pad = re.search(r"pad=([\d_x\-]+)", rest)
        pads = ([tuple(int(v) for v in p.split("_"))
                 for p in pad.group(1).split("x")] if pad
                else [(0, 0)] * len(taps))
        full = any(min(p) >= k - 1 for p, k in zip(pads, taps) if k > 1)
        if "lhs_dilate" in rest or full:
            # The input gradient of a strided or a VALID conv: count it as
            # that conv, over the positions of its (undilated) input.
            ops = ops * _prod(lhs[labels[0].index(k)] for k in spatial) \
                // _prod(out_shape[labels[2].index(k)] for k in spatial)
        if "batch_group_count" in rest:
            raise NotImplementedError(f"batch groups: {rest[:120]}")
        out["convolution"] += ops
    out["total"] = out["convolution"] + out["dot"]
    return out


def jax_counts(fn: Callable, *args) -> Dict[str, float]:
    """XLA's cost model and the products of ``jax.jit(fn)`` at ``args``
    (compiled, not run)."""
    import jax

    compiled = jax.jit(fn).lower(*args).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    products = hlo_products(compiled.as_text())
    return {"jax_flops": float(cost["flops"]),
            "jax_products": products["total"],
            "jax_products_dot": products["dot"]}


def port_count(fn: Callable) -> Dict[str, float]:
    from eegan_tpu_torch.utils.opcount import OpCounter

    with OpCounter() as counter:
        fn()
    return {"port": counter.total, "port_by_op": dict(counter.by_op)}


@contextlib.contextmanager
def magp_repairs_undone():
    """The port's train step as it was before the MAGP's repairs: weight
    gradients in the MAGP's first backward and in the G phase's D backward
    (``steps.input_grads_only`` made a no-op), PyTorch's own leaky ReLU and
    average pool in the Ds (whose double backward sends zeros into the D's
    forward), the class logits in the MAGP."""
    import torch.nn.functional as F

    from eegan_tpu_torch.models import discriminator, layers
    from eegan_tpu_torch.training import steps

    saved = (steps.input_grads_only, layers.LeakyReLU.forward,
             discriminator.avg_pool_2x, discriminator.DiscCond.pair_logit)
    steps.input_grads_only = contextlib.nullcontext
    layers.LeakyReLU.forward = (
        lambda self, x: F.leaky_relu(x, self.negative_slope))
    discriminator.avg_pool_2x = lambda x: F.avg_pool2d(x, 2, 2)
    discriminator.DiscCond.pair_logit = (
        lambda self, feat, cond: self.forward(feat, cond)[0])
    try:
        yield
    finally:
        (steps.input_grads_only, layers.LeakyReLU.forward,
         discriminator.avg_pool_2x,
         discriminator.DiscCond.pair_logit) = saved


# --------------------------------------------------------------------------
# The two packages at the same settings
# --------------------------------------------------------------------------

def configs(width: int, batch: int):
    from eegan_tpu.config import Config as JaxConfig
    from eegan_tpu_torch.config import Config

    out = []
    for cfg in (Config(), JaxConfig()):
        cfg.GAN.GF_DIM = cfg.GAN.DF_DIM = width
        cfg.TRAIN.USE_CLASS = True
        cfg.TRAIN.CLASS_NUM = 200
        cfg.TRAIN.BATCH_SIZE = batch
        cfg.RUNTIME.COMPUTE_DTYPE = "float32"
        cfg.RUNTIME.PALLAS_DAMSM = False
        cfg.RUNTIME.PALLAS_AFFINE = False
        out.append(cfg)
    return out


def abstract_state(jcfg, jm, create_train_state):
    """The JAX package's (state, frozen) as shapes and dtypes only
    (``jax.eval_shape``): a compile needs no weights, and initialising
    them eagerly on the CPU takes minutes."""
    import jax

    return jax.eval_shape(
        lambda: create_train_state(jcfg, jm, jax.random.PRNGKey(0)))


def jax_step_counts(jcfg, batch: int) -> Dict[str, float]:
    """The JAX package's whole train step (what test_torch_bench holds the
    port's count against)."""
    import jax

    from eegan_tpu.data.synthetic import synthetic_batch
    from eegan_tpu.models.factory import build_models
    from eegan_tpu.training.state import create_train_state
    from eegan_tpu.training.steps import make_train_step

    jm = build_models(jcfg, N_WORDS)
    state, frozen = abstract_state(jcfg, jm, create_train_state)
    step = make_train_step(jcfg, jm, donate=False)
    host = synthetic_batch(jcfg, batch, n_words=N_WORDS)
    compiled = step.lower(state, frozen, host, jax.random.PRNGKey(1)).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    products = hlo_products(compiled.as_text())
    return {"jax_flops": float(cost["flops"]),
            "jax_products": products["total"],
            "jax_products_dot": products["dot"]}


def port_step_count(cfg, batch: int) -> Dict[str, float]:
    """One train step of the port on the CPU under the op counter."""
    import numpy as np

    from eegan_tpu_torch.data.synthetic import synthetic_batch
    from eegan_tpu_torch.models.factory import build_models
    from eegan_tpu_torch.training.state import create_train_state
    from eegan_tpu_torch.training.steps import make_train_step

    models = build_models(cfg, N_WORDS, device="cpu")
    state, frozen = create_train_state(cfg, models)
    step = make_train_step(cfg, models)
    host = synthetic_batch(cfg, batch, n_words=N_WORDS)
    noise = np.random.RandomState(1).randn(batch, cfg.GAN.Z_DIM).astype(
        np.float32)
    return port_count(lambda: step(state, frozen, host, noise))


def part_counts(cfg, jcfg, batch: int) -> Dict[str, dict]:
    """Each part on both sides (module docstring)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from eegan_tpu.data.synthetic import synthetic_batch as jax_batch
    from eegan_tpu.losses import damsm as jax_damsm
    from eegan_tpu.losses import gan as jax_gan
    from eegan_tpu.models.attr_enhance import AttrEnhance as JaxAttrEnhance
    from eegan_tpu.models.factory import build_models as jax_build
    from eegan_tpu.training.state import create_train_state as jax_state
    from eegan_tpu.training.steps import encode_text_bundle as jax_text
    from eegan_tpu_torch.losses import gan as gan_losses
    from eegan_tpu_torch.models.attr_enhance import AttrEnhance
    from eegan_tpu_torch.models.factory import build_models
    from eegan_tpu_torch.training import steps
    from eegan_tpu_torch.training.state import create_train_state

    b = batch
    jm = jax_build(jcfg, N_WORDS)
    js, jf = abstract_state(jcfg, jm, jax_state)
    host = jax_batch(jcfg, b, n_words=N_WORDS)
    emb, a_num = jcfg.TEXT.EMBEDDING_DIM, jcfg.TEXT.MAX_ATTR_NUM
    rs = np.random.RandomState(0)
    noise = rs.randn(b, jcfg.GAN.Z_DIM).astype(np.float32)
    sent = rs.randn(b, emb).astype(np.float32)
    attrs = rs.randn(b, a_num, emb).astype(np.float32)
    words = rs.randn(b, jcfg.TEXT.WORDS_NUM, emb).astype(np.float32)
    scales = jm.scales
    imgs = [host[f"img{s}"] for s in scales]
    classes = np.eye(200, dtype=np.float32)[host["class_ids"] - 1]
    sm = jcfg.TRAIN.SMOOTH

    def jgen(gp, ap, stats, z, s, a):
        _, attn = jm.attr_enhance.apply({"params": ap}, s, a)
        merged = JaxAttrEnhance.attr_merge(attn)
        out, _ = jm.generator.apply({"params": gp, "batch_stats": stats}, z,
                                    s, merged, train=True,
                                    mutable=["batch_stats"])
        return out

    def jd(i):
        d = jm.discriminators[i]

        def fwd(p, x, s):
            return d.apply({"params": p}, d.apply({"params": p}, x,
                                                  method="features"),
                           s, method="head")
        return fwd

    def jpair(i):
        fwd = jd(i)
        cls = jcfg.TRAIN.USE_CLASS and i == len(scales) - 1

        def pair_sum(p, x, s):
            out = fwd(p, x, s)
            return (out[0] if cls else out).sum()
        return pair_sum

    def jhinge(i):
        fwd = jd(i)
        cls = jcfg.TRAIN.USE_CLASS and i == len(scales) - 1

        def loss(p, real, fake, s, us):
            d = jm.discriminators[i]
            feats = d.apply({"params": p}, jnp.concatenate([real, fake]),
                            method="features")
            fr, ff = feats[:b], feats[b:]
            heads = d.apply({"params": p}, jnp.concatenate([fr, fr, ff]),
                            jnp.concatenate([s, us, s]), method="head")
            outs = heads[0] if cls else heads
            r, u, f = jnp.split(outs, 3)
            total = jax_gan.d_hinge_total(jax_gan.hinge_real(r),
                                          jax_gan.hinge_fake(f),
                                          jax_gan.hinge_fake(u))
            if cls:
                rc, uc, fc = jnp.split(heads[1], 3)
                total = total + sum(jax_gan.bce_with_logits(c, classes)
                                    for c in (rc, uc, fc))
            return total
        return lambda p, *a: jax.grad(loss)(p, *a)

    def jmagp(i):
        pair_sum = jpair(i)

        def gp(p, x, s):
            gi, gs = jax.grad(pair_sum, argnums=(1, 2))(p, x, s)
            return jax_gan.magp_from_grads(gi, gs)
        return lambda p, x, s: jax.value_and_grad(gp)(p, x, s)

    def jencoder(v, x):
        return jm.image_encoder.apply(v, x, train=False)

    def jgphase(gp, ap, stats, z, s, a, w, dps, image_vars):
        def loss(gp_ap):
            out = jgen(gp_ap[0], gp_ap[1], stats, z, s, a)
            total = 0.0
            for i in range(len(scales)):
                o = jd(i)(dps[i], out[i], s)
                total = total - (o[0] if isinstance(o, tuple) else o).mean()
            region, code = jencoder(image_vars, out[-1])
            ids = host["class_ids"]
            s0, s1 = jax_damsm.sent_loss(code, s, ids, sm.GAMMA3)
            w0, w1 = jax_damsm.words_loss(region, w, host["cap_lens"], ids,
                                          sm.GAMMA1, sm.GAMMA2, sm.GAMMA3)
            return total + s0 + s1 + w0 + w1
        return jax.grad(loss)((gp, ap))

    region = rs.randn(b, 17, 17, emb).astype(np.float32)
    code = rs.randn(b, emb).astype(np.float32)

    def jdamsm(r, c, w):
        def loss(rc):
            ids = host["class_ids"]
            s0, s1 = jax_damsm.sent_loss(rc[1], sent, ids, sm.GAMMA3)
            w0, w1 = jax_damsm.words_loss(rc[0], w, host["cap_lens"], ids,
                                          sm.GAMMA1, sm.GAMMA2, sm.GAMMA3)
            return s0 + s1 + w0 + w1
        return jax.value_and_grad(loss)((r, c))

    parts = {
        "DAMSM losses": (jdamsm, (region, code, words)),
        "generator forward": (jgen, (js.g_params, js.attr_params,
                                     js.g_stats, noise, sent, attrs)),
        "inception encoder forward": (jencoder, (jf.image_vars, imgs[-1])),
        "text encoder": (lambda f, h: jax_text(jm, f, jcfg, h),
                         (jf, {k: host[k] for k in (
                             "caps", "cap_lens", "unpair_caps",
                             "unpair_cap_lens", "attrs", "attr_lens")})),
        "G phase": (jgphase, (js.g_params, js.attr_params, js.g_stats,
                              noise, sent, attrs, words, js.d_params,
                              jf.image_vars)),
    }
    for i, s in enumerate(scales):
        dp = js.d_params[i]
        parts[f"D{s} forward"] = (jd(i), (dp, imgs[i], sent))
        parts[f"D{s} hinge step"] = (jhinge(i), (dp, imgs[i], imgs[i], sent,
                                                 sent))
        parts[f"D{s} MAGP input gradient"] = (
            jax.grad(jpair(i), argnums=(1, 2)), (dp, imgs[i], sent))
        parts[f"D{s} MAGP step"] = (jmagp(i), (dp, imgs[i], sent))
    out = {name: jax_counts(fn, *args) for name, (fn, args) in parts.items()}

    models = build_models(cfg, N_WORDS, device="cpu")
    state, frozen = create_train_state(cfg, models)
    t = torch.from_numpy
    z, s_t, a_t, w_t = t(noise), t(sent), t(attrs), t(words)
    cap_lens = t(host["cap_lens"])
    ids = t(host["class_ids"])
    labels = t(classes)

    def gen():
        _, attn = models.attr_enhance(s_t, a_t)
        return models.generator(z, s_t, AttrEnhance.attr_merge(attn))

    def gphase():
        fake = gen()
        total = 0.0
        for i, d in enumerate(models.discriminators):
            with steps.input_grads_only():
                o = d.head(d.features(fake[i]), s_t)
            total = total - (o[0] if isinstance(o, tuple) else o).mean()
        region, code = frozen.image_encoder(fake[-1])
        s0, s1 = steps.damsm_losses.sent_loss(code, s_t, ids, sm.GAMMA3)
        w0, w1 = steps.damsm_losses.words_loss(region, w_t, cap_lens, ids,
                                               sm.GAMMA1, sm.GAMMA2,
                                               sm.GAMMA3)
        (total + s0 + s1 + w0 + w1).backward(
            inputs=list(models.generator.parameters())
            + list(models.attr_enhance.parameters()))

    def hinge(i):
        d = models.discriminators[i]
        cls = isinstance(d.head(d.features(t(imgs[i])), s_t), tuple)
        real = t(imgs[i])

        def run():
            feats = d.features(torch.cat([real, real]))
            fr, ff = feats[:b], feats[b:]
            heads = d.head(torch.cat([fr, fr, ff]), torch.cat([s_t] * 3))
            r, u, f = (heads[0] if cls else heads).chunk(3)
            total = gan_losses.d_hinge_total(gan_losses.hinge_real(r),
                                             gan_losses.hinge_fake(f),
                                             gan_losses.hinge_fake(u))
            if cls:
                total = total + sum(gan_losses.bce_with_logits(c, labels)
                                    for c in heads[1].chunk(3))
            total.backward()
        return run

    def magp_grad(i):
        # The penalty from the input gradient is elementwise: no products.
        d = models.discriminators[i]
        cls = i == len(scales) - 1
        return lambda: steps._gradient_penalty(d, t(imgs[i]), s_t, cls)

    def magp_step(i):
        d = models.discriminators[i]
        cls = i == len(scales) - 1
        return lambda: steps._gradient_penalty(d, t(imgs[i]), s_t,
                                               cls).backward()

    def text():
        batch = {k: t(host[k]) for k in ("caps", "unpair_caps", "attrs")}
        lens = {k: t(host[k]) for k in ("cap_lens", "unpair_cap_lens",
                                        "attr_lens")}
        steps.encode_text_bundle(frozen, cfg, batch, lens)

    def damsm():
        r = t(region).requires_grad_(True)
        c = t(code).requires_grad_(True)
        s0, s1 = steps.damsm_losses.sent_loss(c, s_t, ids, sm.GAMMA3)
        w0, w1 = steps.damsm_losses.words_loss(r, w_t, cap_lens, ids,
                                               sm.GAMMA1, sm.GAMMA2,
                                               sm.GAMMA3)
        torch.autograd.grad(s0 + s1 + w0 + w1, (r, c))

    port = {
        "DAMSM losses": damsm,
        "generator forward": gen,
        "inception encoder forward": lambda: frozen.image_encoder(
            t(imgs[-1])),
        "text encoder": text,
        "G phase": gphase,
    }
    for i, s in enumerate(scales):
        d = models.discriminators[i]
        port[f"D{s} forward"] = (lambda d=d, i=i: d.head(
            d.features(t(imgs[i])), s_t))
        port[f"D{s} hinge step"] = hinge(i)
        port[f"D{s} MAGP input gradient"] = magp_grad(i)
        port[f"D{s} MAGP step"] = magp_step(i)
    for name, fn in port.items():
        out[name].update(port_count(fn))
        for m in models.discriminators:
            m.zero_grad(set_to_none=True)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--width", type=int, default=16,
                   help="GF_DIM = DF_DIM (cfg/bird.yml: 32)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--parts", action="store_true",
                   help="count each part too, not only the whole step")
    p.add_argument("--repairs_undone", action="store_true",
                   help="the port's step as before the MAGP's repairs")
    args = p.parse_args(argv)
    import torch

    torch.manual_seed(0)
    cfg, jcfg = configs(args.width, args.batch)
    with (magp_repairs_undone() if args.repairs_undone
          else contextlib.nullcontext()):
        rows = {"whole step": jax_step_counts(jcfg, args.batch)}
        rows["whole step"].update(port_step_count(cfg, args.batch))
        if args.parts:
            rows.update(part_counts(cfg, jcfg, args.batch))
    for row in rows.values():
        row["port_over_jax_flops"] = row["port"] / row["jax_flops"]
        row["port_over_jax_products"] = row["port"] / row["jax_products"]
    print(json.dumps({"width": args.width, "batch": args.batch,
                      "dtype": "float32",
                      "repairs_undone": args.repairs_undone, "parts": rows},
                     indent=1))


if __name__ == "__main__":
    sys.exit(main())
