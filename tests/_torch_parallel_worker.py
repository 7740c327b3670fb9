"""One rank of the port's multi-process CPU tests (see
``test_torch_parallel.py``).

    python _torch_parallel_worker.py TASK COORDINATOR WORLD RANK IN OUT

joins a gloo group through ``eegan_tpu_torch.parallel.distributed
.initialize``, runs TASK on this rank's rows of the global inputs that the
parent saved to IN (``torch.save``), and saves what it got to
``OUT.<rank>``. Tasks:

* ``init``: the env-var path (EEGAN_COORDINATOR et al., arguments unused)
  and a second call that must be a no-op;
* ``bn``: ``TorchBatchNorm`` bound to the mesh, forward and backward, with
  and without ``n_override`` and ``return_stats``, and a generator's
  train-mode forward;
* ``damsm``: the sentence, words (plain and fused) and attribute losses
  over the global batch, and the parameter gradients after the ranks'
  average;
* ``step``: one mesh train step from the saved weights (or K steps
  through ``make_multi_train_step``, with ``fsdp`` > 1 on a state sharded
  over that axis): the metrics, the state in the unsharded layout, and
  under FSDP what each sharded leaf holds at rest and that layout loaded
  back into a fresh sharded state and read out again.
"""

import os
import sys

import torch

from eegan_tpu_torch.parallel import distributed
from eegan_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)


def task_init(mesh, inputs):
    distributed.initialize()
    x = torch.arange(4.0)
    torch.distributed.all_reduce(x)
    return {"world": torch.distributed.get_world_size(), "sum": x}


def task_bn(mesh, inputs):
    from eegan_tpu_torch.models.layers import TorchBatchNorm

    out = {}
    for case in ("plain", "n_override", "stats"):
        bn = TorchBatchNorm(inputs["x"].shape[1])
        bn.load_state_dict(inputs["bn"])
        bn.mesh = mesh
        bn.train()
        x = mesh.rows(inputs["x"]).clone().requires_grad_(True)
        dy = mesh.rows(inputs["dy"])
        if case == "stats":
            mean, var = bn(x, return_stats=True)
            loss = (mean * inputs["dmean"]).sum() + (var * inputs["dvar"]
                                                     ).sum()
            # Every rank holds the global statistics: one rank's share.
            loss = loss / mesh.size
            y = torch.stack([mean, var])
        else:
            b, _, h, w = x.shape
            n = 4 * b * h * w if case == "n_override" else None
            y = bn(x, n_override=n)
            loss = (y * dy).sum()
        loss.backward()
        out[case] = {"y": y.detach(), "dx": x.grad,
                     "state": {k: v.clone() for k, v in
                               bn.state_dict().items()}}
    # The generator's forward in train mode (every batch norm global).
    gen = inputs["generator"]
    for m in gen.modules():
        if isinstance(m, TorchBatchNorm):
            m.mesh = mesh
    with torch.no_grad():
        imgs = gen(*(mesh.rows(v) for v in inputs["gen_inputs"]))
    out["generator"] = {"imgs": imgs, "state": gen.state_dict()}
    return out


def task_damsm(mesh, inputs):
    from eegan_tpu_torch.losses import damsm
    from eegan_tpu_torch.ops.damsm import words_loss_fused

    heads = inputs["heads"]
    losses = damsm_losses(heads, {k: mesh.rows(v)
                                  for k, v in inputs["data"].items()},
                          damsm, words_loss_fused, mesh)
    sum(losses.values()).backward()
    mesh.average_gradients_(heads.parameters())
    return {"losses": {k: v.detach() for k, v in losses.items()},
            "grads": {k: p.grad for k, p in heads.named_parameters()}}


def damsm_losses(heads, data, damsm, words_loss_fused, mesh=None):
    """The four DAMSM terms of the G phase on ``heads``' projections."""
    regions = heads["regions"](data["feats"])
    code = heads["code"](data["pooled"])
    attrs = heads["attrs"](data["attr_feats"])
    args = (data["cap_lens"], data["class_ids"], 4.0, 5.0, 10.0)
    s0, s1 = damsm.sent_loss(code, data["sent"], data["class_ids"], 10.0,
                             mesh=mesh)
    w0, w1 = damsm.words_loss(regions, data["words"], *args, mesh=mesh)
    f0, f1 = words_loss_fused(regions, data["words"], *args, mesh=mesh)
    a0, a1 = damsm.sent_loss(code, attrs, data["class_ids"], 10.0,
                             mesh=mesh)
    return {"s0": s0, "s1": s1, "w0": w0, "w1": w1, "f0": f0, "f1": f1,
            "a0": a0, "a1": a1}


def task_step(mesh, inputs):
    from eegan_tpu_torch.models.factory import build_models
    from eegan_tpu_torch.parallel.fsdp import MIN_SHARD_ELEMS
    from eegan_tpu_torch.training.state import (
        create_train_state,
        full_state_dict,
        load_full_state_dict,
    )
    from eegan_tpu_torch.training.steps import (
        make_multi_train_step,
        make_train_step,
    )

    cfg = inputs["config"]
    models = build_models(cfg, inputs["n_words"], device="cpu")
    for name, sd in inputs["weights"].items():
        module = (models.discriminators[int(name[5:])]
                  if name.startswith("disc_") else getattr(models, name))
        module.load_state_dict(sd)
    state, frozen = create_train_state(
        cfg, models, mesh, inputs.get("min_shard_elems", MIN_SHARD_ELEMS))
    if "steps" in inputs:  # K steps: batch leaves (K, B, ...)
        step = make_multi_train_step(cfg, models, mesh=mesh)
        state, metrics = step(
            state, frozen,
            {k: v[:, slice(*mesh.row_range(v.shape[1]))]
             for k, v in inputs["batch"].items()},
            inputs["noise"][:, slice(*mesh.row_range(
                inputs["noise"].shape[1]))])
    else:
        step = make_train_step(cfg, models, mesh=mesh)
        state, metrics = step(state, frozen,
                              mesh.shard_batch(inputs["batch"]),
                              mesh.rows(inputs["noise"]))
    at_rest = None if state.shards is None else _at_rest(state)
    full = full_state_dict(state)
    reloaded = None
    if state.shards is not None:
        # The unsharded layout back into a fresh sharded state.
        fresh, _ = create_train_state(
            cfg, build_models(cfg, inputs["n_words"], device="cpu"), mesh,
            inputs.get("min_shard_elems", MIN_SHARD_ELEMS))
        load_full_state_dict(fresh, full)
        reloaded = full_state_dict(fresh)
    return {"metrics": {k: v.detach() for k, v in metrics.items()},
            "generator": full["generator"],
            "attr_enhance": full["attr_enhance"],
            "discriminators": full["discriminators"],
            "g_ema": full["g_ema"], "attr_ema": full["attr_ema"],
            "moments": [[s["exp_avg"] for _, s in sorted(o["state"].items())]
                        for o in (full["g_opt"], *full["d_opts"])],
            "second_moments": [[s["exp_avg_sq"] for _, s in
                                sorted(o["state"].items())]
                               for o in (full["g_opt"], *full["d_opts"])],
            "at_rest": at_rest, "full": full, "reloaded": reloaded}


def _at_rest(state):
    """Per sharded module and parameter: the full size, the dim the rule
    shards (None: replicated) and the elements the rank holds of the
    parameter in the module, of its owned tensor, of both Adam moments
    and of its EMA copy."""
    sh = state.shards
    opts = {id(m): opt for m, opt in ((sh.generator, state.g_opt),
                                      (sh.attr_enhance, state.g_opt),
                                      *zip(sh.discriminators, state.d_opts))}
    emas = {id(sh.generator): state.g_ema, id(sh.attr_enhance):
            state.attr_ema}
    out = {}
    for key, m in (("generator", sh.generator),
                   ("attr_enhance", sh.attr_enhance),
                   *((f"disc_{i}", d) for i, d in
                     enumerate(sh.discriminators))):
        opt, ema = opts[id(m)], emas.get(id(m))
        rows = {}
        for j, name in enumerate(m.names):
            owned = m.owned[j]
            moments = opt.state[owned]
            rows[name] = dict(
                full=int(torch.Size(m.shapes[j]).numel()), dim=m.dims[j],
                param=m.params[j].numel(), owned=owned.numel(),
                exp_avg=moments["exp_avg"].numel(),
                exp_avg_sq=moments["exp_avg_sq"].numel(),
                ema=None if ema is None else ema[name].numel(),
                grad=m.params[j].grad is not None)
        out[key] = rows
    return out


TASKS = {"init": task_init, "bn": task_bn, "damsm": task_damsm,
         "step": task_step}


def main():
    task, coordinator, world, rank, in_path, out_path = sys.argv[1:7]
    if task == "init":
        distributed.initialize(device="cpu")
    else:
        distributed.initialize(coordinator, int(world), int(rank),
                               device="cpu")
    try:
        inputs = (torch.load(in_path, weights_only=False)
                  if os.path.exists(in_path) else {})
        mesh = Mesh.current("cpu", fsdp=inputs.get("fsdp", 1))
        result = TASKS[task](mesh, inputs)
        torch.save(result, f"{out_path}.{mesh.rank}")
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
