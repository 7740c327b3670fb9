"""Plain PyTorch reference of one EE-GAN training iteration and of
sampling, over the networks of ``reference/eegan.py``.

The iteration is upstream EE-GAN's ``train.py`` loop: the frozen text
encoder over caption, unpaired caption and attributes; AttrEnhance and
the generator once; per scale the hinge step of the discriminator
(real / fake / mismatched, plus the class terms at the last scale when
USE_CLASS), an Adam update, then the matching-aware gradient penalty
(MAGP) as a second Adam update at the updated parameters; last the
generator's step against the updated discriminators with the DAMSM
sentence, words and attribute losses through the frozen image encoder.
Adam is written out (betas TRAIN.B1, TRAIN.B2, eps 1e-8, optax's update).

``fault`` plants one fault of the kind the check has to catch, for the
readings that set its limits: ``half_batch`` computes every loss over
the first half of the rows only; ``no_magp`` drops the MAGP's gradient
(its Adam update then takes a zero one).

``exchange`` (None in one process) is what several processes, each
holding rows of one global batch, exchange to compute the global
batch's iteration (``reference/eegan_mesh.py``): it averages every
gradient over them before each Adam update, hands the DAMSM losses the
whole batch's rows, and averages the reported losses.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.eegan import imsizes, input_grads_only

NEG_INF = -1e9
EPS = 1e-8


# --- losses ------------------------------------------------------------


def hinge_real(out):
    return torch.relu(1.0 - out).mean()


def hinge_fake(out):
    return torch.relu(1.0 + out).mean()


def bce(logits, targets):
    x = logits
    return (x.clamp_min(0) - x * targets + torch.log1p(torch.exp(-x.abs()))
            ).mean()


def one_hot(class_ids, n):
    idx = class_ids.long() - 1
    valid = (idx >= 0) & (idx < n)
    return F.one_hot(torch.where(valid, idx, 0), n).float() * valid[:, None]


def magp(gi, gs):
    b = gi.shape[0]
    g = torch.cat([gi.reshape(b, -1), gs.reshape(b, -1)], 1)
    return 2.0 * (g.square().sum(1).sqrt() ** 6).mean()


def _ce(logits, labels):
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None])[:, 0]).mean()


def contrastive(sims, class_ids):
    eq = class_ids[:, None] == class_ids[None, :]
    off = eq & ~torch.eye(len(class_ids), dtype=torch.bool,
                          device=sims.device)
    sims = sims.masked_fill(off, NEG_INF)
    labels = torch.arange(sims.shape[0], device=sims.device)
    return _ce(sims, labels) + _ce(sims.T, labels)


def sent_loss(code, rnn, class_ids, gamma3):
    norms = code.norm(dim=-1, keepdim=True) @ rnn.norm(dim=-1,
                                                       keepdim=True).T
    return contrastive(code @ rnn.T / norms.clamp_min(EPS) * gamma3,
                       class_ids)


def word_region_log_sims(regions, words, cap_lens, gamma1, gamma2):
    """(Bi, Bt) log sum over valid words of exp(gamma2 cos(word, context)),
    the context of each word its attention over the image's regions
    (AttnGAN's ``func_attention``: softmax over words, the probabilities
    times gamma1, softmax over regions)."""
    b, h, w, d = regions.shape
    regions = regions.reshape(b, h * w, d)
    steps = torch.arange(words.shape[1], device=words.device)
    mask = (steps[None] < cap_lens[:, None]).to(words.dtype)
    logits = torch.einsum("isd,tld->itsl", regions, words)
    logits = torch.where(mask[None, :, None] > 0, logits,
                         torch.full_like(logits, NEG_INF))
    attn = torch.softmax(torch.softmax(logits, -1) * gamma1, 2)
    ctx = torch.einsum("itsl,isd->itld", attn, regions)
    dots = torch.einsum("tld,itld->itl", words, ctx)
    wn = words.square().sum(-1).clamp_min(EPS * EPS).sqrt()
    cn = ctx.square().sum(-1).clamp_min(EPS * EPS).sqrt()
    sim = torch.exp(dots / (wn[None] * cn).clamp_min(EPS) * gamma2) \
        * mask[None]
    return torch.log(sim.sum(-1).clamp_min(EPS))


# --- the iteration -----------------------------------------------------


class Adam:
    """Adam over named tensors, optax's update: lr * m_hat / (sqrt(v_hat)
    + eps). A tensor without a gradient takes a zero one. ``first`` holds
    the gradient norm of each tensor at the first update; with
    ``keep_second``, ``second`` holds them at the second update and
    ``second_at`` the tensors it started from, on the host (a
    discriminator's second update is its first MAGP)."""

    def __init__(self, named, lr, b1, b2):
        self.named = dict(named)
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.t = 0
        self.m = {n: torch.zeros_like(p) for n, p in self.named.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.named.items()}
        self.first: Optional[Dict[str, torch.Tensor]] = None
        self.keep_second = False
        self.second: Optional[Dict[str, torch.Tensor]] = None
        self.second_at: Dict[str, torch.Tensor] = {}
        self.exchange = None  # reference/eegan_mesh.py's, over processes

    def zero_grad(self):
        for p in self.named.values():
            p.grad = None

    @torch.no_grad()
    def step(self, update=True):
        if self.exchange is not None:
            self.exchange.average_(self.named)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self.named.items()}
        if self.first is None:
            self.first = {n: g.norm() for n, g in grads.items()}
        elif self.keep_second and self.second is None:
            self.second = {n: g.norm() for n, g in grads.items()}
            self.second_at = {n: p.detach().to("cpu", copy=True)
                              for n, p in self.named.items()}
        if not update:
            return
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, p in self.named.items():
            g = grads[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (self.m[n] / c1)
                   / ((self.v[n] / c2).sqrt() + EPS))


def named(nets, key):
    return [(f"{key}.{n}", p) for n, p in nets[key].named_parameters()]


def optimizers(nets, model, exchange=None) -> Tuple[Adam, List[Adam]]:
    tr = model["TRAIN"]
    g = Adam(named(nets, "generator") + named(nets, "attr_enhance"),
             tr["GENERATOR_LR"], tr["B1"], tr["B2"])
    ds = [Adam(named(nets, k), tr["DISCRIMINATOR_LR"], tr["B1"], tr["B2"])
          for k in sorted(k for k in nets if k.startswith("disc"))]
    for o in (g, *ds):
        o.exchange = exchange
    return g, ds


def encode_text(nets, model, batch):
    """words, sent, unpaired sent, attribute embeddings (no gradient)."""
    text = model["TEXT"]
    caps = batch["caps"]
    b, t = caps.shape
    a_num, a_len = text["MAX_ATTR_NUM"], text["MAX_ATTR_LEN"]
    attrs = F.pad(batch["attrs"].reshape(b * a_num, a_len).long(),
                  (0, t - a_len))
    lens = torch.cat([batch["cap_lens"], batch["unpair_cap_lens"],
                      batch["attr_lens"].reshape(-1).clamp_min(1)])
    with torch.no_grad():
        words, sent = nets["text_encoder"](
            torch.cat([caps.long(), batch["unpair_caps"].long(), attrs]),
            lens)
    return (words[:b], sent[:b], sent[b:2 * b],
            sent[2 * b:].reshape(b, a_num, -1))


def magp_loss(disc, real, sent, cls_scale: bool):
    """The MAGP of a discriminator at its parameters: the norms of the
    input gradients of sum(D(real, sent)), kept in the graph."""
    img = real.detach().requires_grad_(True)
    cond = sent.detach().requires_grad_(True)
    with input_grads_only():
        feat = disc.features(img)
        out = (disc.COND_DNET.pair_logit(feat, cond) if cls_scale
               else disc.head(feat, cond))
    gi, gs = torch.autograd.grad(out.sum(), (img, cond), create_graph=True)
    return magp(gi, gs)


def _rows(batch, noise, n):
    return {k: v[:n] for k, v in batch.items()}, noise[:n]


def train_step(nets, model, opts, batch, noise, update=True,
               fault: Optional[str] = None,
               before_g=None, exchange=None) -> Dict[str, torch.Tensor]:
    """One iteration in place; returns the losses by the program's
    metric names. ``batch``: one batch of ``inputs.train_pool``, the
    lengths (``*_lens``) on the host. ``update=False`` computes every
    gradient but moves no parameter (for the operation count).
    ``before_g`` is called between the discriminators' updates and the
    generator's phase. With an ``exchange`` the DAMSM losses are the
    whole batch's and the losses returned are the mean over the
    processes."""
    tr, sm = model["TRAIN"], model["TRAIN"]["SMOOTH"]
    g_opt, d_opts = opts
    if fault == "half_batch":
        batch, noise = _rows(batch, noise, batch["caps"].shape[0] // 2)
    words, sent, unpair, attrs_emb = encode_text(nets, model, batch)
    use_class = tr["USE_CLASS"]
    labels = one_hot(batch["class_ids"], tr["CLASS_NUM"]) if use_class \
        else None
    gen, attr = nets["generator"], nets["attr_enhance"]
    gen.train()
    attn_sent, merged = attr(sent, attrs_emb)
    del attn_sent
    fakes = gen(noise, sent, merged)
    sizes = [f.shape[1] for f in fakes]
    metrics: Dict[str, torch.Tensor] = {}
    n = len(d_opts)
    for i, opt in enumerate(d_opts):
        disc = nets[f"disc{i}"]
        cls_scale = use_class and i == n - 1
        real = batch[f"img{sizes[i]}"]
        opt.zero_grad()
        f_real, f_fake = disc.features(real), disc.features(fakes[i].detach())
        h_real, h_unp, h_fake = (disc.head(f_real, sent),
                                 disc.head(f_real, unpair),
                                 disc.head(f_fake, sent))
        if cls_scale:
            (h_real, c_real), (h_unp, c_unp), (h_fake, c_fake) = \
                h_real, h_unp, h_fake
        e_real, e_fake, e_unp = (hinge_real(h_real), hinge_fake(h_fake),
                                 hinge_fake(h_unp))
        loss = e_real + (e_fake + e_unp) / 2.0
        m = {"real_sent": e_real, "fake_sent": e_fake, "unpair_sent": e_unp}
        if cls_scale:
            er, ef, eu = bce(c_real, labels), bce(c_fake, labels), \
                bce(c_unp, labels)
            loss = loss + (er + ef + eu) / 3.0 * tr["CLASS_COE"]
            m.update(real_class=er, fake_class=ef, unpair_class=eu)
        loss.backward()
        opt.step(update)
        opt.zero_grad()
        gp = magp_loss(disc, real, sent, cls_scale)
        if fault != "no_magp":
            gp.backward()
        opt.step(update)
        m["d_loss_gp"] = gp
        metrics.update({f"errD_{i}/{k}": v.detach() for k, v in m.items()})

    if before_g is not None:
        before_g()
    g_opt.zero_grad()
    total = torch.zeros((), device=noise.device)
    for i in range(n):
        disc = nets[f"disc{i}"]
        with input_grads_only():
            out = disc.head(disc.features(fakes[i]), sent)
        if use_class and i == n - 1:
            pair, cls = out
            err, err_c = -pair.mean(), bce(cls, labels)
            total = total + err + err_c * tr["CLASS_COE"]
            metrics[f"errG/G_{i}_fake_class"] = err_c.detach()
        else:
            err = -out.mean()
            total = total + err
        metrics[f"errG/G_{i}_fake_sent"] = err.detach()
    region, code = nets["image_encoder"](fakes[-1])
    ids = batch["class_ids"]
    cap_lens = batch["cap_lens"].to(region.device)
    if exchange is not None:
        region, code, merged, sent, words, cap_lens, ids = exchange.rows(
            region, code, merged, sent, words, cap_lens, ids)
    s_loss = sent_loss(code, sent, ids, sm["GAMMA3"]) * sm["LAMBDA"] \
        * tr["SENT_COE"]
    w_loss = contrastive(word_region_log_sims(
        region, words, cap_lens, sm["GAMMA1"], sm["GAMMA2"])
        * sm["GAMMA3"], ids) * sm["LAMBDA"] * tr["WORDS_COE"]
    a_loss = sent_loss(code, merged, ids, sm["GAMMA3"]) * sm["LAMBDA"] \
        * tr["ATTR_COE"]
    total = total + tr["SIM_COE"] * (s_loss + w_loss + a_loss)
    total.backward(inputs=list(g_opt.named.values()))
    g_opt.step(update)
    metrics.update({"errG/s_loss": s_loss.detach(),
                    "errG/w_loss": w_loss.detach(),
                    "errG/a_loss": a_loss.detach(),
                    "errG/total": total.detach()})
    if exchange is not None:
        metrics = exchange.mean(metrics)
    return metrics


def train(nets, model, batches, noises, fault: Optional[str] = None,
          exchange=None):
    """``len(batches)`` iterations from the networks' weights. Returns
    (losses per step as floats, the first gradient's norm per tensor,
    the change of each trained tensor over the steps, and what the
    program's readings give beside them: ``d_state``, the
    discriminators' parameters as the first step's generator phase saw
    them; ``magp_state``, as each first MAGP saw them; ``magp_grads``,
    the norm of each first MAGP's gradient per tensor; on the host),
    tensors named ``<network>.<parameter>``. ``batches`` and ``noises``
    hold this process's rows when there is an ``exchange``."""
    for key in ("text_encoder", "image_encoder"):
        nets[key].eval()
        nets[key].requires_grad_(False)
    opts = optimizers(nets, model, exchange)
    g_opt, d_opts = opts
    for o in d_opts:
        o.keep_second = True
    start = {n: p.detach().clone() for o in (g_opt, *d_opts)
             for n, p in o.named.items()}
    d_first = {}

    def keep_d():
        if not d_first:
            d_first.update({n: p.detach().to("cpu", copy=True) for o in d_opts
                            for n, p in o.named.items()})

    losses = []
    for batch, noise in zip(batches, noises):
        m = train_step(nets, model, opts, batch, noise, fault=fault,
                       before_g=keep_d, exchange=exchange)
        losses.append({k: float(v) for k, v in m.items()})
    grads = {n: float(v) for o in (g_opt, *d_opts)
             for n, v in o.first.items()}
    change = {n: float((p.detach() - start[n]).norm())
              for o in (g_opt, *d_opts) for n, p in o.named.items()}
    seen = dict(d_state=d_first,
                magp_state={n: t for o in d_opts
                            for n, t in o.second_at.items()},
                magp_grads={n: float(v) for o in d_opts
                            for n, v in o.second.items()})
    return losses, grads, change, seen


def first_g_grads(nets, model, batch, noise, d_state, exchange=None
                  ) -> Dict[str, float]:
    """The generator's first gradient per tensor, with the
    discriminators' parameters set to ``d_state`` (another run's, as its
    first generator phase saw them) for that phase."""
    for key in ("text_encoder", "image_encoder"):
        nets[key].eval()
        nets[key].requires_grad_(False)
    opts = optimizers(nets, model, exchange)
    g_opt, d_opts = opts

    @torch.no_grad()
    def set_d():
        for o in d_opts:
            for n, p in o.named.items():
                p.copy_(d_state[n])

    train_step(nets, model, opts, batch, noise, update=False, before_g=set_d,
               exchange=exchange)
    return {n: float(v) for n, v in g_opt.first.items()}


def magp_grads(nets, model, batch, d_state, exchange=None
               ) -> Dict[str, float]:
    """The norm of the first MAGP's gradient per discriminator tensor,
    with the discriminators' parameters set to ``d_state`` (another
    run's, as its first MAGP saw them); with an ``exchange``, of the
    gradient averaged over the processes."""
    for key in ("text_encoder", "image_encoder"):
        nets[key].eval()
        nets[key].requires_grad_(False)
    _, sent, _, _ = encode_text(nets, model, batch)
    tr = model["TRAIN"]
    sizes = imsizes(model)
    out = {}
    for i, size in enumerate(sizes):
        named_d = named(nets, f"disc{i}")
        with torch.no_grad():
            for n, p in named_d:
                p.copy_(d_state[n])
                p.grad = None
        gp = magp_loss(nets[f"disc{i}"], batch[f"img{size}"], sent,
                       tr["USE_CLASS"] and i == len(sizes) - 1)
        gp.backward()
        if exchange is not None:
            exchange.average_(dict(named_d))
        out.update({n: 0.0 if p.grad is None else float(p.grad.norm())
                    for n, p in named_d})
    return out


def sample(nets, model, caps, cap_lens, attrs, attr_lens, noise):
    """The 256² images of a batch of captions, NHWC in [-1, 1]; the
    networks in eval mode."""
    text = model["TEXT"]
    b, t = caps.shape
    a_num, a_len = text["MAX_ATTR_NUM"], text["MAX_ATTR_LEN"]
    flat = F.pad(attrs.reshape(b * a_num, a_len).long(), (0, t - a_len))
    lens = torch.cat([cap_lens.cpu(),
                      attr_lens.reshape(-1).clamp_min(1).cpu()])
    for key in ("text_encoder", "attr_enhance", "generator"):
        nets[key].eval()
    with torch.no_grad():
        _, s = nets["text_encoder"](torch.cat([caps.long(), flat]), lens)
        sent = s[:b]
        _, merged = nets["attr_enhance"](sent, s[b:].reshape(b, a_num, -1))
        return nets["generator"](noise, sent, merged)[-1]


def to_uint8(img):
    """[-1, 1] -> uint8 levels, as the served images are delivered."""
    return ((img.float() + 1.0) * 127.5).round().clamp(0, 255).to(
        torch.uint8)

