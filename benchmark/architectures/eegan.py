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
* ``build_train(cell, config, seed_w, device, mesh=False)``: (state,
  frozen, the K-step call, the trained tensors at the start on the host);
  with ``mesh``, on the data mesh of the process group this process has
  joined (``drivers/train_mesh.py``).
* ``Capture(cell, state, start, steps)``: optimizer hooks over the first
  call; ``.readings(losses)`` gives (readings, seen) once ``.remove()``
  has run.
* ``numbers(cell, seed_w, readings, seen, batches, noises, device,
  mesh=False)``: the check's numbers and the reference's readings.
* ``KINDS``, ``reference_readings(cell, seed_w, batches, noises, device,
  kind=None, mesh=False)``: the reference's readings, or one of ``KINDS``
  put in the program's place. With ``mesh`` every process of the group
  calls them with its rows, and the reference computes the global
  batch's step (``reference/eegan_mesh.py``); its readings put in the
  program's place are ``MESH_KINDS``.
* ``step_ops(cell, rows, batch)``; ``traced_train(cell, pool, first,
  steps, rows, ranks=1)``: the observations the traced call adds (rows
  a card; the pool's global batches of ``rows`` x ``ranks``).

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
from benchmark.reference import eegan, eegan_mesh, steps as ref_steps

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


def build_train(cell, config, seed_w: int, device, mesh: bool = False):
    """The program (``models/factory.py::build_models``,
    ``training/state.py::create_train_state``,
    ``training/steps.py::make_multi_train_step``) with the seed's
    weights: (state, frozen, the K-step call, each trained tensor at the
    start on the host). With ``mesh``, on the data mesh of the process
    group this process has joined (``parallel/mesh.py::Mesh.current``),
    which ``config``'s RUNTIME.MESH has to describe."""
    from eegan_tpu_torch.models.factory import build_models
    from eegan_tpu_torch.training.state import create_train_state
    from eegan_tpu_torch.training.steps import make_multi_train_step

    on = None
    if mesh:
        from eegan_tpu_torch.parallel.mesh import Mesh, mesh_shape

        on = Mesh.current(device)
        if mesh_shape(config.RUNTIME.MESH, on.size) != (on.size, 1):
            raise ValueError(f"RUNTIME.MESH {config.RUNTIME.MESH!r} is not "
                             f"the data mesh of {on.size} processes")
    models = build_models(config, cell.config["n_words"], device=device)
    w = draw_weights(cell, seed_w, device)
    load_program_weights(models, w)
    start = {f"{net}.{n}": t.float().cpu() for net, state in w.items()
             if net not in ("text_encoder", "image_encoder")
             for n, t in state.items()}
    del w
    state, frozen = create_train_state(config, models, on)
    return state, frozen, make_multi_train_step(config, models, mesh=on), start


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
    the MAGP's), so as far as that step keeps them; and the generator's
    batch norms' running statistics when the generator's optimizer has
    made its first update, one forward after the seed's, from which
    :meth:`readings` takes the first step's batch moments."""

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
        self.norms = {f"generator.{n}": m
                      for n, m in state.generator.named_modules()
                      if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}
        self.running: Dict[str, tuple] = {}
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
                self.running = {
                    k: (m.running_mean.detach().to("cpu", torch.float64),
                        m.running_var.detach().to("cpu", torch.float64),
                        m.momentum) for k, m in self.norms.items()}
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

    def batch_moments(self) -> Dict[str, tuple]:
        """Each generator batch norm's first batch (mean, unbiased
        variance) per channel, from its running statistics after one
        forward: running = (1 - momentum) x the seed's + momentum x the
        batch's."""
        out = {}
        for k, (mean, var, mom) in self.running.items():
            m0 = self.start[f"{k}.running_mean"].double()
            v0 = self.start[f"{k}.running_var"].double()
            out[k] = ((mean - (1.0 - mom) * m0) / mom,
                      (var - (1.0 - mom) * v0) / mom)
        return out

    def readings(self, losses):
        """(the run's readings: losses per checked step, first gradients,
        changes; what the reference is held to beside them, the ``seen``
        of ``reference.steps.train``, and the generator's first batch
        moments, ``bn``)."""
        return ((losses, self.first, self.change or {}),
                dict(d_state=self.d_state, magp_state=self.magp_state,
                     magp_grads=self.magp_grads, bn=self.batch_moments()))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def _reference(cell, seed_w: int, device, quant=None, d_quant=None,
               exchange=None):
    """The reference's networks with the seed's weights, float32 with
    TF32 off; rounded by ``quant``, the discriminators alone by
    ``d_quant``; bound to ``exchange``'s global batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nets = reference_nets(cell, device, quant)
    if d_quant is not None:
        nets.update(reference_nets(cell, device, d_quant,
                                   parts=("discriminators",)))
    w = draw_weights(cell, seed_w, device)
    for key, net in nets.items():
        weights.load(net, w[key])
    return nets if exchange is None else exchange.bind(nets)


# Readings put in the program's place to set the limits (calibrate.py):
# the control, the reference in float8; faults planted in the float32
# reference: ``half_batch`` (every loss over the first half of the rows),
# ``no_magp`` (the MAGP's gradient dropped), ``fp8_d`` (the
# discriminators alone in float8).
KINDS = {"control": dict(quant=eegan.fp8_round),
         "half_batch": dict(fault="half_batch"),
         "no_magp": dict(fault="no_magp"),
         "fp8_d": dict(d_quant=eegan.fp8_round)}
# On a data mesh (drivers/train_mesh.py): the control, the reference of
# the global step in float8; faults of the mesh planted in the float32
# reference of the global step (reference/eegan_mesh.py): ``local_bn``,
# ``local_grads``, ``local_damsm``.
MESH_KINDS = {"control": dict(quant=eegan.fp8_round),
              **{f: dict(fault=f) for f in eegan_mesh.FAULTS}}


def reference_readings(cell, seed_w: int, batches, noises, device,
                       kind: Optional[str] = None, mesh: bool = False):
    """The reference's three steps from the seed's weights, float32 or
    as ``KINDS[kind]`` (``MESH_KINDS[kind]`` with ``mesh``) plants:
    (losses per step, first gradients, changes, what
    ``reference.steps.train``'s ``seen`` holds). With ``mesh`` every
    process of the group calls it with its rows, and ``seen`` holds the
    generator's first batch moments too (``bn``)."""
    kw = dict((MESH_KINDS if mesh else KINDS)[kind]) if kind else {}
    fault = kw.pop("fault", None)
    if not mesh:
        nets = _reference(cell, seed_w, device, **kw)
        out = ref_steps.train(nets, cell.model, batches, noises, fault=fault)
    else:
        ex = eegan_mesh.Exchange(fault=fault)
        nets = _reference(cell, seed_w, device, exchange=ex, **kw)
        out = ref_steps.train(nets, cell.model, batches, noises, exchange=ex)
        out[3]["bn"] = ex.moments
    del nets
    _release(device)
    return out


def numbers(cell, seed_w: int, readings, seen, batches, noises, device,
            mesh: bool = False):
    """The check's numbers of ``readings`` (losses, first gradients,
    changes) of a run that ``seen`` describes: against the float32
    reference's three steps; the generator's first gradient against the
    reference's at the discriminators the run's first generator phase
    saw; each discriminator's first MAGP gradient against the
    reference's at the parameters the run's first MAGP saw. With
    ``mesh`` every process of the group calls it with its rows and its
    run's readings, the reference is the global batch's step, and the
    generator's first batch moments are held to the reference's.
    Returns (numbers, the reference's readings)."""
    ref = reference_readings(cell, seed_w, batches, noises, device,
                             mesh=mesh)
    out = check.train_numbers(readings, ref[:3])

    def on_device(state):
        return {k: v.to(device) for k, v in state.items()}

    ex = eegan_mesh.Exchange() if mesh else None
    nets = _reference(cell, seed_w, device, exchange=ex)
    g_ref = ref_steps.first_g_grads(nets, cell.model, batches[0], noises[0],
                                    on_device(seen["d_state"]), exchange=ex)
    magp_ref = ref_steps.magp_grads(nets, cell.model, batches[0],
                                    on_device(seen["magp_state"]),
                                    exchange=ex)
    del nets
    _release(device)
    out["grad_gap_g_pd_median"] = check.pd_gap(readings[1], g_ref)
    out["grad_gap_magp_pd_median"] = check.pd_gap(seen["magp_grads"],
                                                  magp_ref)
    if mesh:
        out["loss_gap_damsm_first_mean"] = check.damsm_first_mean(
            readings[0], ref[0])
        out["bn_gap_first_max"] = max(
            check.bn_gaps(seen.get("bn", {}), ref[3]["bn"]).values())
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


def traced_train(cell, pool, first: int, steps: int, rows: int,
                 ranks: int = 1) -> Dict:
    """What the traced call of pool batches ``first`` .. +``steps`` adds
    to the observations of a card that trains ``rows`` of each batch of
    ``rows`` x ``ranks`` (``pool``: the global batches): each step's
    caption lengths, the words similarity's shapes on the card
    (``damsm``: its images against every text), the card's share of
    the global step's operations."""
    lens = pool["cap_lens"][first:first + steps]
    t = cell.model["TEXT"]
    return dict(
        traced_batches=[dict(rows=rows * ranks, cap_lens=l.tolist())
                        for l in lens],
        damsm=[dict(Bi=rows, Bt=rows * ranks, S=17 * 17, L=t["WORDS_NUM"],
                    D=t["EMBEDDING_DIM"], valid_words=int(l.sum()))
               for l in lens],
        ops_per_step=step_ops(cell, rows * ranks, inputs.step_batch(
            pool, 0, torch.device("meta"))) / ranks)


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
