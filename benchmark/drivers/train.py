"""Traffic of kind ``train``: the program's K-step training call over a
pool of batches drawn from the seed.

The traffic file gives ``batch_per_card``, ``steps_per_call`` (K) and
``pool_batches`` (P, a multiple of K): P batches are drawn once at
set-up, on the device, and call i trains on batches (i·K mod P) .. +K,
with noise drawn on the device for every call. Set-up builds the
program (``models/factory.py::build_models``,
``training/state.py::create_train_state``,
``training/steps.py::make_multi_train_step``) with the benchmark's
weights, runs one call, whose first three steps the check compares, and
one more call. The window then calls until ``--seconds`` have passed on
the host's clock and closes on a value read after the last call.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import check, harness, inputs, weights
from benchmark.reference import eegan, steps as ref_steps

CHECKED_STEPS = 3


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference_nets(cell, device, quant=None, parts=None):
    kw = {} if parts is None else {"parts": parts}
    return eegan.build(cell.model, cell.config["n_words"], device, quant,
                       **kw)


def draw_weights(cell, seed: int, device):
    """The seed's weights, by the reference's network names."""
    return weights.make(reference_nets(cell, "meta"), seed, device)


def load_program_weights(models, w) -> None:
    weights.load(models.generator, w["generator"])
    weights.load(models.attr_enhance, w["attr_enhance"])
    for i, d in enumerate(models.discriminators):
        weights.load(d, w[f"disc{i}"])
    weights.load(models.text_encoder, w["text_encoder"])
    weights.load(models.image_encoder, w["image_encoder"])


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
    moments; and each trained tensor's change over the first
    ``CHECKED_STEPS`` steps, read when the first discriminator's
    optimizer is about to make its first update of the next step (two
    updates a step: the hinge's, the MAGP's), so as far as that step
    keeps them."""

    def __init__(self, state, start: Dict[str, torch.Tensor], b1: float):
        self.names = trained_names(state)
        self.start = start  # on the host
        self.b1 = b1
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
        if opt is self.d0 and n == 2 * CHECKED_STEPS + 1:
            with torch.no_grad():
                self.change = {
                    self.names[id(p)]: float(
                        (p.detach().float().cpu()
                         - self.start[self.names[id(p)]]).norm())
                    for p in self.params}

    def seen(self) -> Dict[str, Dict]:
        """What the reference is held to beside the run's own readings
        (the ``seen`` of ``reference.steps.train``)."""
        return dict(d_state=self.d_state, magp_state=self.magp_state,
                    magp_grads=self.magp_grads)

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


class Program:
    """The program under test, built and driven from the seed."""

    def __init__(self, cell, seed: int, device):
        from eegan_tpu_torch.models.factory import build_models
        from eegan_tpu_torch.training.state import create_train_state
        from eegan_tpu_torch.training.steps import make_multi_train_step

        t = cell.traffic
        self.cell, self.device = cell, device
        self.B, self.K, self.P = (t["batch_per_card"], t["steps_per_call"],
                                  t["pool_batches"])
        if self.P % self.K or self.K <= CHECKED_STEPS:
            raise ValueError("pool_batches must be a multiple of "
                             "steps_per_call, which must be more than "
                             f"{CHECKED_STEPS}")
        self.seed_w, self.seed_in, self.seed_z = harness.seeds(seed, 3)
        self.config = harness.port_config(cell, self.B)
        self.models = build_models(self.config, cell.config["n_words"],
                                   device=device)
        w = draw_weights(cell, self.seed_w, device)
        load_program_weights(self.models, w)
        self.start = {f"{net}.{n}": t.float().cpu() for net, state in w.items()
                      if net not in ("text_encoder", "image_encoder")
                      for n, t in state.items()}
        del w
        self.state, self.frozen = create_train_state(self.config, self.models)
        self.multi = make_multi_train_step(self.config, self.models)
        self.pool = inputs.train_pool(cell.model, cell.config["n_words"],
                                      self.P, self.B, self.seed_in, device)
        self.gen = torch.Generator(device=device).manual_seed(self.seed_z)
        self.calls = 0
        self.z_dim = cell.model["GAN"]["Z_DIM"]

    def call(self):
        """One call of K steps on the next K batches of the pool; returns
        (metrics, the noise it used)."""
        a = (self.calls * self.K) % self.P
        batch = {k: v[a:a + self.K] for k, v in self.pool.items()}
        noise = torch.randn((self.K, self.B, self.z_dim), generator=self.gen,
                            device=self.device)
        self.state, metrics = self.multi(self.state, self.frozen, batch,
                                         noise)
        self.calls += 1
        return metrics, noise

    def first_call(self):
        """The first call, under :class:`Capture`; returns the program's
        readings (losses per checked step, first gradients, changes), what
        its :meth:`Capture.seen` holds, the checked steps' batches and
        noise."""
        cap = Capture(self.state, self.start, self.cell.model["TRAIN"]["B1"])
        try:
            metrics, noise = self.call()
            losses = [{k: float(v[j]) for k, v in metrics.items()}
                      for j in range(min(CHECKED_STEPS, self.K))]
        finally:
            cap.remove()
        self.start = None
        batches = [inputs.step_batch(self.pool, j, self.device)
                   for j in range(CHECKED_STEPS)]
        return ((losses, cap.first, cap.change or {}), cap.seen(),
                batches, noise[:CHECKED_STEPS].clone())

    def free(self) -> None:
        for name in ("state", "frozen", "models", "multi", "pool"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def read_value(metrics) -> float:
    """The last step's ``errG/total`` as a float: waits for the device."""
    return float(metrics["errG/total"][-1])


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
    w = weights.make(reference_nets(cell, "meta"), seed_w, device)
    for key, net in nets.items():
        weights.load(net, w[key])
    return nets


def _release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


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
                       quant=None, d_quant=None, fault=None):
    """The reference's three steps from the seed's weights: (losses per
    step, first gradients, changes, what ``reference.steps.train``'s
    ``seen`` holds)."""
    nets = _reference(cell, seed_w, device, quant, d_quant)
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


def checked_inputs(cell, seed: int, device):
    """What the program's first call draws from the seed for its checked
    steps: (weights' seed, batches, noise), as :class:`Program` draws
    them."""
    t = cell.traffic
    seed_w, seed_in, seed_z = harness.seeds(seed, 3)
    pool = inputs.train_pool(cell.model, cell.config["n_words"],
                             t["pool_batches"], t["batch_per_card"], seed_in,
                             device)
    gen = torch.Generator(device=device).manual_seed(seed_z)
    noise = torch.randn((t["steps_per_call"], t["batch_per_card"],
                         cell.model["GAN"]["Z_DIM"]), generator=gen,
                        device=device)
    return (seed_w, [inputs.step_batch(pool, j, device)
                     for j in range(CHECKED_STEPS)],
            noise[:CHECKED_STEPS].clone())


def readings_of(cell, seed: int, device, kind: str = "program"):
    """(numbers, the run's readings, the reference's) of a sound run
    (``kind="program"``: the program's first call, without a window) or
    of a reading of :data:`KINDS` put in the program's place."""
    if kind == "program":
        prog = Program(cell, seed, device)
        readings, seen, batches, noises = prog.first_call()
        seed_w = prog.seed_w
        prog.free()
    else:
        seed_w, batches, noises = checked_inputs(cell, seed, device)
        *readings, seen = reference_readings(
            cell, seed_w, batches, noises, device, **KINDS[kind])
    out, ref = numbers(cell, seed_w, readings, seen, batches, noises,
                       device)
    return out, readings, ref[:3]


def numbers_of(cell, seed: int, device, kind: str = "program"
               ) -> Dict[str, float]:
    """The check's numbers of :func:`readings_of`."""
    return readings_of(cell, seed, device, kind)[0]


def step_ops(cell, batch_rows: int, batch) -> int:
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
    noise = torch.empty((batch_rows, cell.model["GAN"]["Z_DIM"]),
                        device=meta)
    with OpCounter() as counter:
        ref_steps.train_step(nets, cell.model, opts, b, noise, update=False)
    return counter.total


def run(cell, args, device, t_start: float, log) -> harness.Outcome:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    prog = Program(cell, args.seed, device)
    readings, seen, batches, noises = prog.first_call()
    m, _ = prog.call()  # the second call: nothing is new in the window
    read_value(m)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (B={prog.B}, K={prog.K})")

    kept: List[Dict[str, torch.Tensor]] = []
    returns = []  # host clock as each call returns (the host runs ahead)
    _sync(device)
    t0 = time.perf_counter()
    while True:
        m, _ = prog.call()
        kept.append(m)
        returns.append(time.perf_counter())
        if returns[-1] - t0 >= args.seconds:
            break
    read_value(m)
    window_s = time.perf_counter() - t0
    gaps = np.diff([t0] + returns)
    log("host seconds per call: min %.4f median %.4f max %.4f" % (
        gaps.min(), np.median(gaps), gaps.max()))
    steps = len(kept) * prog.K
    bad = sum(int((~torch.isfinite(torch.stack(list(m.values())))).any(0)
                  .sum()) for m in kept)
    log(f"window {window_s:.3f} s, {len(kept)} calls, {steps} steps")
    e2e = {"train_images_per_s": steps * prog.B / window_s,
           "setup_s": setup_s}
    obs = {"kind": "train", "cell": cell, "steps_per_s": steps / window_s}

    summary = None
    if args.trace:
        from benchmark import trace

        a = (prog.calls * prog.K) % prog.P
        lens = prog.pool["cap_lens"][a:a + prog.K]
        summary = trace.profile(lambda: prog.call(), lambda: _sync(device),
                                args.trace_file)
        t = cell.model["TEXT"]
        obs.update(
            trace=summary, traced_steps=prog.K,
            traced_batches=[dict(rows=prog.B, cap_lens=l.tolist())
                            for l in lens],
            damsm=[dict(Bi=prog.B, Bt=prog.B, S=17 * 17, L=t["WORDS_NUM"],
                        D=t["EMBEDDING_DIM"], valid_words=int(l.sum()))
                   for l in lens],
            ops_per_step=step_ops(cell, prog.B, inputs.step_batch(
                prog.pool, 0, torch.device("meta"))),
            peak_flops=harness.H100_BF16_FLOPS)
    peak = (torch.cuda.max_memory_allocated()
            if device.type == "cuda" else 0)
    e2e["peak_mem_gib"] = peak / 2 ** 30
    seed_w = prog.seed_w
    prog.free()

    found, _ = numbers(cell, seed_w, readings, seen, batches, noises, device)
    return harness.Outcome(
        attempted=steps, failed=bad, end_to_end=e2e, observations=obs,
        peak_bytes=peak, checks=check.checks(found, cell.settings["limits"]),
        trace=summary)
