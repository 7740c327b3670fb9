"""EE-GAN as the benchmark runs it: the program's networks with the seed's
weights, the inputs they take, the check against the plain reference
(``reference/eegan.py``, ``reference/steps.py``), the readings put in
the program's place, and the operation counts.

A configuration names its architecture (``"architecture": "eegan"``);
:func:`benchmark.harness.find_cell` loads ``architectures/<name>.py``
onto the cell, and the drivers call these functions through it. The
drivers keep the window, the pool's K-step calls, the failure count,
the traced call, peak memory and ``setup_s``.

For ``drivers/train.py``:

* ``VALUE``: the step metric whose last value the window reads.
* ``noise_shape(cell, rows)``: one step's (or request's) noise.
* ``train_pool(cell, batches, rows, seed, device)``: the pool of
  batches, leaves (batches, rows, ...), lengths on the host.
* ``build_train(cell, config, seed_w, device)``: (state, frozen, the
  K-step call, the trained tensors at the start on the host).
* ``Capture(cell, state, start, steps)``: optimizer hooks over the first
  call; ``.readings(losses)`` gives (readings, seen) once ``.remove()``
  has run.
* ``numbers(cell, seed_w, readings, seen, batches, noises, device)``: the
  check's numbers and the reference's readings.
* ``KINDS``, ``reference_readings(cell, seed_w, batches, noises, device,
  kind=None)``: the reference's readings, or one of ``KINDS`` put in the
  program's place.
* ``step_ops(cell, rows, batch)``; ``traced_train(cell, pool, first,
  steps, rows)``: the observations the traced call adds.

For ``drivers/generate.py``:

* ``noise_shape`` as above; ``caption_pool(cell, n, seed, device)``.
* ``build_sampler(cell, config, seed_w, device)``: the sampling call.
* ``image_shape(cell, rows)``; ``sample_images(sample, pool, idx,
  dev_idx, noise)``: one request's uint8 images on the device.
* ``IMAGE_KINDS``, ``reference_images(cell, seed_w, pool, requests,
  device, kind=None)``: the reference's images, or one of ``IMAGE_KINDS``
  put in the program's place; ``image_numbers(cell, seed_w, pool,
  requests, images, device)``: the check's numbers.
* ``sample_ops(cell, rows)``; ``traced_generate(cell, pool, idxs,
  rows)``: the observations the traced requests add.
"""

from __future__ import annotations

import gc
import math
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import check, inputs, weights
from benchmark.reference import eegan, steps as ref_steps

VALUE = "errG/total"
PARTS = ("generator", "attr_enhance", "text_encoder")  # sampling's networks


def reference_nets(cell, device, quant=None, parts=None):
    kw = {} if parts is None else {"parts": parts}
    return eegan.build(cell.model, cell.config["n_words"], device, quant,
                       **kw)


def draw_weights(cell, seed: int, device, parts=None):
    """The seed's weights, by the reference's network names."""
    return weights.make(reference_nets(cell, "meta", parts=parts), seed,
                        device)


def noise_shape(cell, rows: int):
    return (rows, cell.model["GAN"]["Z_DIM"])


def _release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# --- training ----------------------------------------------------------


def train_pool(cell, batches: int, rows: int, seed: int, device):
    return inputs.train_pool(cell.model, cell.config["n_words"], batches,
                             rows, seed, device)


def load_program_weights(models, w) -> None:
    weights.load(models.generator, w["generator"])
    weights.load(models.attr_enhance, w["attr_enhance"])
    for i, d in enumerate(models.discriminators):
        weights.load(d, w[f"disc{i}"])
    weights.load(models.text_encoder, w["text_encoder"])
    weights.load(models.image_encoder, w["image_encoder"])


def build_train(cell, config, seed_w: int, device):
    """The program (``models/factory.py::build_models``,
    ``training/state.py::create_train_state``,
    ``training/steps.py::make_multi_train_step``) with the seed's
    weights: (state, frozen, the K-step call, each trained tensor at the
    start on the host)."""
    from eegan_tpu_torch.models.factory import build_models
    from eegan_tpu_torch.training.state import create_train_state
    from eegan_tpu_torch.training.steps import make_multi_train_step

    models = build_models(config, cell.config["n_words"], device=device)
    w = draw_weights(cell, seed_w, device)
    load_program_weights(models, w)
    start = {f"{net}.{n}": t.float().cpu() for net, state in w.items()
             if net not in ("text_encoder", "image_encoder")
             for n, t in state.items()}
    del w
    state, frozen = create_train_state(config, models)
    return state, frozen, make_multi_train_step(config, models), start


def trained_names(state) -> Dict[int, str]:
    """id(parameter) -> ``<network>.<name>``, the reference's leaf names."""
    nets = {"generator": state.generator, "attr_enhance": state.attr_enhance}
    nets.update({f"disc{i}": d for i, d in enumerate(state.discriminators)})
    return {id(p): f"{key}.{n}" for key, net in nets.items()
            for n, p in net.named_parameters()}


class Capture:
    """Optimizer hooks on the program's state for the first call: each
    optimizer's first gradient per tensor, from Adam's first moment after
    its first update; the discriminators' parameters when the generator's
    optimizer makes its first update; each discriminator's parameters
    when its optimizer is about to make its second update (its first
    MAGP's) and that update's gradient per tensor, from Adam's first
    moments; and each trained tensor's change over the first ``steps``
    steps, read when the first discriminator's optimizer is about to make
    its first update of the next step (two updates a step: the hinge's,
    the MAGP's), so as far as that step keeps them."""

    def __init__(self, cell, state, start: Dict[str, torch.Tensor],
                 steps: int):
        self.names = trained_names(state)
        self.start = start  # on the host
        self.b1 = cell.model["TRAIN"]["B1"]
        self.steps = steps
        self.first: Dict[str, float] = {}
        self.change: Optional[Dict[str, float]] = None
        self.d_state: Dict[str, torch.Tensor] = {}
        self.magp_state: Dict[str, torch.Tensor] = {}
        self.magp_grads: Dict[str, float] = {}
        self.m1: Dict[str, torch.Tensor] = {}  # a discriminator's first m
        self.g_opt = state.g_opt
        self.d_params = {self.names[id(p)]: p for o in state.d_opts
                         for g in o.param_groups for p in g["params"]}
        self.updates = {id(o): 0 for o in (state.g_opt, *state.d_opts)}
        self.d0 = state.d_opts[0]
        self.params = [p for o in (state.g_opt, *state.d_opts)
                       for g in o.param_groups for p in g["params"]]
        opts = (state.g_opt, *state.d_opts)
        self.handles = ([o.register_step_post_hook(self.after_step)
                         for o in opts]
                        + [o.register_step_pre_hook(self.before_step)
                           for o in state.d_opts])

    def _moments(self, opt):
        for g in opt.param_groups:
            for p in g["params"]:
                yield self.names[id(p)], p, opt.state.get(p, {}).get(
                    "exp_avg")

    def after_step(self, opt, args, kwargs) -> None:
        self.updates[id(opt)] += 1
        n = self.updates[id(opt)]
        if n == 1:
            if opt is self.g_opt:
                # The discriminators as the first generator phase saw them.
                self.d_state = {
                    k: p.detach().to("cpu", torch.float32, copy=True)
                    for k, p in self.d_params.items()}
            for name, p, m in self._moments(opt):
                self.first[name] = (math.nan if m is None
                                    else float(m.norm()) / (1.0 - self.b1))
                if opt is not self.g_opt and m is not None:
                    self.m1[name] = m.detach().clone()
        elif n == 2 and opt is not self.g_opt:
            # m2 = B1 m1 + (1 - B1) g2: the MAGP's gradient g2.
            for name, p, m in self._moments(opt):
                self.magp_grads[name] = (
                    math.nan if m is None or name not in self.m1
                    else float((m - self.b1 * self.m1.pop(name)).norm())
                    / (1.0 - self.b1))

    def before_step(self, opt, args, kwargs) -> None:
        n = self.updates[id(opt)] + 1  # the update about to be made
        if n == 2:
            # The discriminator as its first MAGP saw it.
            self.magp_state.update({
                name: p.detach().to("cpu", torch.float32, copy=True)
                for name, p, _ in self._moments(opt)})
        if opt is self.d0 and n == 2 * self.steps + 1:
            with torch.no_grad():
                self.change = {
                    self.names[id(p)]: float(
                        (p.detach().float().cpu()
                         - self.start[self.names[id(p)]]).norm())
                    for p in self.params}

    def readings(self, losses):
        """(the run's readings: losses per checked step, first gradients,
        changes; what the reference is held to beside them, the ``seen``
        of ``reference.steps.train``)."""
        return ((losses, self.first, self.change or {}),
                dict(d_state=self.d_state, magp_state=self.magp_state,
                     magp_grads=self.magp_grads))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def _reference(cell, seed_w: int, device, quant=None, d_quant=None):
    """The reference's networks with the seed's weights, float32 with
    TF32 off; rounded by ``quant``, the discriminators alone by
    ``d_quant``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nets = reference_nets(cell, device, quant)
    if d_quant is not None:
        nets.update(reference_nets(cell, device, d_quant,
                                   parts=("discriminators",)))
    w = draw_weights(cell, seed_w, device)
    for key, net in nets.items():
        weights.load(net, w[key])
    return nets


# Readings put in the program's place to set the limits (calibrate.py):
# the control, the reference in float8; faults planted in the float32
# reference: ``half_batch`` (every loss over the first half of the rows),
# ``no_magp`` (the MAGP's gradient dropped), ``fp8_d`` (the
# discriminators alone in float8).
KINDS = {"control": dict(quant=eegan.fp8_round),
         "half_batch": dict(fault="half_batch"),
         "no_magp": dict(fault="no_magp"),
         "fp8_d": dict(d_quant=eegan.fp8_round)}


def reference_readings(cell, seed_w: int, batches, noises, device,
                       kind: Optional[str] = None):
    """The reference's three steps from the seed's weights, float32 or
    as ``KINDS[kind]`` plants: (losses per step, first gradients,
    changes, what ``reference.steps.train``'s ``seen`` holds)."""
    kw = dict(KINDS[kind]) if kind else {}
    fault = kw.pop("fault", None)
    nets = _reference(cell, seed_w, device, **kw)
    out = ref_steps.train(nets, cell.model, batches, noises, fault=fault)
    del nets
    _release(device)
    return out


def numbers(cell, seed_w: int, readings, seen, batches, noises, device):
    """The check's numbers of ``readings`` (losses, first gradients,
    changes) of a run that ``seen`` describes: against the float32
    reference's three steps; the generator's first gradient against the
    reference's at the discriminators the run's first generator phase
    saw; each discriminator's first MAGP gradient against the
    reference's at the parameters the run's first MAGP saw. Returns
    (numbers, the reference's readings)."""
    ref = reference_readings(cell, seed_w, batches, noises, device)
    out = check.train_numbers(readings, ref[:3])

    def on_device(state):
        return {k: v.to(device) for k, v in state.items()}

    nets = _reference(cell, seed_w, device)
    g_ref = ref_steps.first_g_grads(nets, cell.model, batches[0], noises[0],
                                    on_device(seen["d_state"]))
    magp_ref = ref_steps.magp_grads(nets, cell.model, batches[0],
                                    on_device(seen["magp_state"]))
    del nets
    _release(device)
    out["grad_gap_g_pd_median"] = check.pd_gap(readings[1], g_ref)
    out["grad_gap_magp_pd_median"] = check.pd_gap(seen["magp_grads"],
                                                  magp_ref)
    return out, ref


def step_ops(cell, rows: int, batch) -> int:
    """Operations of one step of the reference at the cell's shapes,
    counted on the ``meta`` device (no memory, no device time)."""
    from benchmark.opcount import OpCounter

    meta = torch.device("meta")
    nets = reference_nets(cell, meta)
    for key in ("text_encoder", "image_encoder"):
        nets[key].eval().requires_grad_(False)
    opts = ref_steps.optimizers(nets, cell.model)
    b = {k: v if k.endswith("_lens") else v.to(meta)
         for k, v in batch.items()}
    noise = torch.empty(noise_shape(cell, rows), device=meta)
    with OpCounter() as counter:
        ref_steps.train_step(nets, cell.model, opts, b, noise, update=False)
    return counter.total


def traced_train(cell, pool, first: int, steps: int, rows: int) -> Dict:
    """What the traced call of pool batches ``first`` .. +``steps`` adds
    to the observations: each step's rows and caption lengths, the words
    similarity's shapes (``damsm``), the step's operations."""
    lens = pool["cap_lens"][first:first + steps]
    t = cell.model["TEXT"]
    return dict(
        traced_batches=[dict(rows=rows, cap_lens=l.tolist()) for l in lens],
        damsm=[dict(Bi=rows, Bt=rows, S=17 * 17, L=t["WORDS_NUM"],
                    D=t["EMBEDDING_DIM"], valid_words=int(l.sum()))
               for l in lens],
        ops_per_step=step_ops(cell, rows, inputs.step_batch(
            pool, 0, torch.device("meta"))))


# --- generation --------------------------------------------------------


def caption_pool(cell, n: int, seed: int, device):
    """``n`` captions and attributes from ``seed``, the lengths on the
    host."""
    host = inputs.captions(cell.model, cell.config["n_words"], (n,),
                           np.random.default_rng(seed))
    return {k: torch.from_numpy(v) if k.endswith("_lens")
            else torch.from_numpy(v).to(device) for k, v in host.items()}


def build_sampler(cell, config, seed_w: int, device):
    """The program's sampling call
    (``training/steps.py::make_sample_step``) with the seed's weights."""
    from eegan_tpu_torch.models.factory import build_models
    from eegan_tpu_torch.training.steps import make_sample_step

    models = build_models(config, cell.config["n_words"], device=device)
    w = draw_weights(cell, seed_w, device, PARTS)
    for key in PARTS:
        weights.load(getattr(models, key), w[key])
    del w
    return make_sample_step(config, models)


def image_shape(cell, rows: int):
    """A request's uint8 images, NHWC at the last scale."""
    tree = cell.model["TREE"]
    size = tree["BASE_SIZE"] * 2 ** (tree["BRANCH_NUM"] - 1)
    return (rows, size, size, 3)


def sample_images(sample, pool, idx, dev_idx, noise):
    """The uint8 images of the pool's rows ``idx`` (``dev_idx`` on the
    device) at the last scale."""
    imgs = sample(pool["caps"][dev_idx], pool["cap_lens"][idx],
                  pool["attrs"][dev_idx], pool["attr_lens"][idx], noise)
    return ref_steps.to_uint8(imgs[-1])


# Readings put in the program's place (calibrate.py): the control, the
# reference in float8; the float32 reference with the first image of each
# answer from the second row's noise.
IMAGE_KINDS = ("control", "altered")


def reference_images(cell, seed_w: int, pool, requests, device,
                     kind: Optional[str] = None):
    """The reference's uint8 images of each request: float32, or as
    ``kind`` of ``IMAGE_KINDS`` plants."""
    if kind is not None and kind not in IMAGE_KINDS:
        raise ValueError(f"no reading {kind!r} of a generate cell")
    if kind == "altered":
        moved = []
        for idx, noise in requests:
            noise = noise.clone()
            noise[0] = noise[1]
            moved.append((idx, noise))
        requests = moved
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nets = reference_nets(cell, device,
                          eegan.fp8_round if kind == "control" else None,
                          parts=PARTS)
    w = draw_weights(cell, seed_w, device, PARTS)
    for key, net in nets.items():
        weights.load(net, w[key])
    del w
    out = []
    for idx, noise in requests:
        dev_idx = idx.to(device)
        img = ref_steps.sample(nets, cell.model, pool["caps"][dev_idx],
                               pool["cap_lens"][idx], pool["attrs"][dev_idx],
                               pool["attr_lens"][idx], noise.to(device))
        out.append(ref_steps.to_uint8(img).cpu().numpy())
    return out


def image_numbers(cell, seed_w: int, pool, requests, images, device
                  ) -> Dict[str, float]:
    """The check's number of ``images``, the answers to ``requests``,
    against the float32 reference's."""
    ref = reference_images(cell, seed_w, pool, requests, device)
    return {"image_gap": check.image_gap(images, ref)}


def sample_ops(cell, rows: int) -> int:
    """Operations of the reference's sampling of one request, counted on
    the ``meta`` device."""
    from benchmark.opcount import OpCounter

    meta = torch.device("meta")
    nets = reference_nets(cell, meta, parts=PARTS)
    t = cell.model["TEXT"]
    caps = torch.ones((rows, t["WORDS_NUM"]), dtype=torch.int64,
                      device=meta)
    lens = torch.full((rows,), t["WORDS_NUM"], dtype=torch.int64)
    attrs = torch.ones((rows, t["MAX_ATTR_NUM"], t["MAX_ATTR_LEN"]),
                       dtype=torch.int64, device=meta)
    attr_lens = torch.full((rows, t["MAX_ATTR_NUM"]), t["MAX_ATTR_LEN"])
    noise = torch.empty(noise_shape(cell, rows), device=meta)
    with OpCounter() as counter:
        ref_steps.sample(nets, cell.model, caps, lens, attrs, attr_lens,
                         noise)
    return counter.total


def traced_generate(cell, pool, idxs, rows: int) -> Dict:
    """What the traced requests (the pool's rows ``idxs``, one entry a
    request) add to the observations: each request's rows and caption
    lengths, kernel 1's shapes (``affine``), a request's operations."""
    elem = torch.empty((), dtype=getattr(
        torch, cell.settings["runtime"]["COMPUTE_DTYPE"])).element_size()
    return dict(
        traced_batches=[dict(rows=rows, cap_lens=pool["cap_lens"][i].tolist())
                        for i in idxs],
        affine=dict(B=rows, ngf=cell.model["GAN"]["GF_DIM"], elem=elem),
        ops_per_request=sample_ops(cell, rows))
