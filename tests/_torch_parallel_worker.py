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
* ``step``: one mesh train step from the saved weights.
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
    from eegan_tpu_torch.training.state import create_train_state
    from eegan_tpu_torch.training.steps import make_train_step

    cfg = inputs["config"]
    models = build_models(cfg, inputs["n_words"], device="cpu")
    for name, sd in inputs["weights"].items():
        module = (models.discriminators[int(name[5:])]
                  if name.startswith("disc_") else getattr(models, name))
        module.load_state_dict(sd)
    state, frozen = create_train_state(cfg, models)
    step = make_train_step(cfg, models, mesh=mesh)
    state, metrics = step(state, frozen, mesh.shard_batch(inputs["batch"]),
                          mesh.rows(inputs["noise"]))
    return {"metrics": {k: v.detach() for k, v in metrics.items()},
            "generator": state.generator.state_dict(),
            "attr_enhance": state.attr_enhance.state_dict(),
            "discriminators": [d.state_dict() for d in state.discriminators],
            "moments": [[opt.state[p]["exp_avg"] for g in opt.param_groups
                         for p in g["params"]]
                        for opt in (state.g_opt, *state.d_opts)]}


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
        mesh = Mesh.current("cpu")
        inputs = (torch.load(in_path, weights_only=False)
                  if os.path.exists(in_path) else {})
        result = TASKS[task](mesh, inputs)
        torch.save(result, f"{out_path}.{mesh.rank}")
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
