"""Data parallelism in the port (``eegan_tpu_torch/parallel``): the mesh
spec, the process-group set-up, and global-batch semantics on two gloo
ranks on the CPU.

Each multi-process test starts two ``_torch_parallel_worker.py`` processes
on a free port, waits for them with a timeout (and kills them on one), and
compares what rank 0 and rank 1 saved with one process over the global
batch:

* batch norm bound to the mesh: outputs, input gradients and running stats
  within 1e-5 (float32 sums in another order), as
  ``tests/test_train_step.py::test_global_batchnorm_matches_single_device``
  holds the JAX package's sharded generator;
* the DAMSM sentence, words (plain and the fused op's CPU path) and
  attribute losses: values rtol 1e-5, the gradients of the projections
  that feed them, after the ranks' average, within 1e-5 of their largest;
* one mesh train step at global B=4 against the JAX package's step at B=4,
  at ``test_torch_train_step.py``'s bars;
* ``python -m eegan_tpu_torch.train --mesh data:2 --device cpu`` for two
  epochs of one iteration, against one process at the same global batch:
  both iterations' metrics rtol 1e-4; the epoch-1 checkpoint's parameters
  within the Adam bars of one step, its BN running stats within 1e-5, the
  discriminators' Adam moments within 1e-4 relative L2 and the
  generator's within 1e-2. At the CLI's default init (zero residual gates
  and zero-init affine heads, a random Inception) the G phase's DAMSM
  terms amplify rounding: summing the batch norms' statistics over two
  halves of the batch in one process, as the two ranks do, moves the
  generator's moments by 1.5e-3 by itself, and the ranks' moments lie
  1.5e-3 from the one process's.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from eegan_tpu.parallel.mesh import parse_mesh_spec as jax_parse_mesh_spec
from eegan_tpu_torch.data.synthetic import synthetic_batch
from eegan_tpu_torch.models.factory import randomize_
from eegan_tpu_torch.models.generator import Generator
from eegan_tpu_torch.models.layers import TorchBatchNorm
from eegan_tpu_torch.parallel.mesh import (
    Mesh,
    check_axes,
    data_axis_size,
    parse_mesh_spec,
)
from test_torch_train_step import (
    B,
    CLASS_IDS,
    N_WORDS,
    _close_after_adam,
    check_discriminators,
    check_generator,
    check_metrics,
    configs,
    shared_start,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_parallel_worker.py")
RANKS = 2
TIMEOUT_S = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **extra)


def _wait(procs):
    """Wait for every process within TIMEOUT_S; kill them all on a
    timeout or a failure."""
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def run_ranks(task, inputs, tmp_path, ranks=RANKS):
    """``task`` on ``ranks`` gloo ranks; each rank's saved result."""
    in_path, out_path = str(tmp_path / "in.pt"), str(tmp_path / "out")
    torch.save(inputs, in_path)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, task, coord, str(ranks), str(r), in_path,
         out_path], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(ranks)]
    _wait(procs)
    return [torch.load(f"{out_path}.{r}", weights_only=False)
            for r in range(ranks)]


# -- the mesh spec ---------------------------------------------------------

@pytest.mark.parametrize("spec,n", [("data:8", 8), ("data:-1", 4),
                                    ("data:4,fsdp:2", 8), ("data:-1,fsdp:2",
                                                           8), ("data", 3),
                                    (" data:2 , fsdp:1 ", 2)])
def test_parse_mesh_spec_matches_jax(spec, n):
    assert parse_mesh_spec(spec, n) == jax_parse_mesh_spec(spec, n)


@pytest.mark.parametrize("spec,n", [("data:-1,fsdp:-1", 4),
                                    ("data:-1,fsdp:3", 4)])
def test_parse_mesh_spec_errors_match_jax(spec, n):
    with pytest.raises(ValueError):
        jax_parse_mesh_spec(spec, n)
    with pytest.raises(ValueError):
        parse_mesh_spec(spec, n)


def test_data_axis_size():
    assert data_axis_size("data:-1", 4) == 4
    assert data_axis_size("data:-1", None) == 1
    assert data_axis_size("data:3", None) == 3
    assert data_axis_size("data:2,fsdp:1", 2) == 2
    assert data_axis_size("fsdp:1", 8) == 1
    # More ranks than devices raises; it never shrinks.
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        data_axis_size("data:4", 2)


@pytest.mark.parametrize("spec", ["data:2,fsdp:2", "fsdp:-1", "fsdp",
                                  "data:1,model:2"])
def test_unported_axes_raise(spec):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        check_axes(spec)
    with pytest.raises(NotImplementedError):
        data_axis_size(spec, 8)


def test_mesh_rows():
    meshes = [Mesh(3, r, "cpu") for r in range(3)]
    x = np.arange(12).reshape(6, 2)
    assert np.array_equal(np.concatenate([m.rows(x) for m in meshes]), x)
    batch = {"a": x, "b": torch.arange(6)}
    assert meshes[1].shard_batch(batch)["b"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="not divisible"):
        meshes[0].rows(np.zeros(4))
    with pytest.raises(ValueError):
        Mesh(2, 2, "cpu")


def test_initialize_env_path_and_idempotency(tmp_path):
    env = _env(EEGAN_COORDINATOR=f"127.0.0.1:{_free_port()}",
               EEGAN_NUM_PROCESSES="1", EEGAN_PROCESS_ID="0")
    proc = subprocess.Popen(
        [sys.executable, WORKER, "init", "-", "-", "-", "-",
         str(tmp_path / "out")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    _wait([proc])
    out = torch.load(str(tmp_path / "out.0"), weights_only=False)
    assert out["world"] == 1
    assert out["sum"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_initialize_needs_every_address_part(monkeypatch):
    from eegan_tpu_torch.parallel import distributed

    for name in ("EEGAN_COORDINATOR", "EEGAN_NUM_PROCESSES",
                 "EEGAN_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="EEGAN_PROCESS_ID"):
        distributed.initialize("127.0.0.1:1", 2, None, device="cpu")
    assert distributed.default_backend("cpu") == "gloo"
    assert distributed.default_backend("cuda:0") == "nccl"


# -- global batch norm -----------------------------------------------------

def test_global_batchnorm_matches_one_process(tmp_path):
    g = torch.Generator().manual_seed(0)
    C = 6
    bn = randomize_(TorchBatchNorm(C), 1)
    x = (torch.randn(4, C, 3, 5, generator=g) * 2 + 0.5).contiguous(
        memory_format=torch.channels_last)
    dy = torch.randn(4, C, 3, 5, generator=g)
    dmean, dvar = torch.randn(C, generator=g), torch.randn(C, generator=g)
    gen = randomize_(Generator(ngf=2, cond_dim=16, pallas_affine=True,
                               up_fused=True), 2).train()
    gen_inputs = (torch.randn(4, 100, generator=g),
                  torch.randn(4, 16, generator=g),
                  torch.randn(4, 16, generator=g))
    inputs = dict(x=x, dy=dy, dmean=dmean, dvar=dvar, bn=bn.state_dict(),
                  generator=gen, gen_inputs=gen_inputs)
    ranks = run_ranks("bn", inputs, tmp_path)

    for case in ("plain", "n_override", "stats"):
        ref = TorchBatchNorm(C)
        ref.load_state_dict(inputs["bn"])
        xr = x.clone().requires_grad_(True)
        if case == "stats":
            mean, var = ref(xr, return_stats=True)
            ((mean * dmean).sum() + (var * dvar).sum()).backward()
            y_rows = [torch.stack([mean, var])] * RANKS
        else:
            b, _, h, w = x.shape
            y = ref(xr, n_override=4 * b * h * w if case == "n_override"
                    else None)
            (y * dy).sum().backward()
            y_rows = y.detach().chunk(RANKS)
        dx_rows = xr.grad.chunk(RANKS)
        for r, got in enumerate(ranks):
            got = got[case]
            torch.testing.assert_close(got["y"], y_rows[r].detach(),
                                       rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(got["dx"], dx_rows[r], rtol=1e-5,
                                       atol=1e-5)
            for k, v in ref.state_dict().items():
                torch.testing.assert_close(got["state"][k], v, rtol=1e-5,
                                           atol=1e-6)

    with torch.no_grad():
        imgs = gen(*gen_inputs)
    for r, got in enumerate(ranks):
        for a, b in zip(got["generator"]["imgs"], imgs):
            torch.testing.assert_close(a, b.chunk(RANKS)[r], rtol=1e-4,
                                       atol=1e-4)
        for k, v in gen.state_dict().items():
            torch.testing.assert_close(got["generator"]["state"][k].float(),
                                       v.float(), rtol=1e-5, atol=1e-5)


# -- the DAMSM losses over the global batch -------------------------------

def test_damsm_losses_and_gradients_match_one_process(tmp_path):
    from _torch_parallel_worker import damsm_losses

    from eegan_tpu_torch.losses import damsm
    from eegan_tpu_torch.ops.damsm import words_loss_fused

    g = torch.Generator().manual_seed(5)
    nb, S, L, D0, D = 6, 9, 5, 12, 8
    torch.manual_seed(4)
    heads = torch.nn.ModuleDict({
        "regions": torch.nn.Linear(D0, D), "code": torch.nn.Linear(D0, D),
        "attrs": torch.nn.Linear(D0, D)})
    data = {
        "feats": torch.randn(nb, S, D0, generator=g),
        "pooled": torch.randn(nb, D0, generator=g),
        "attr_feats": torch.randn(nb, D0, generator=g),
        "sent": torch.randn(nb, D, generator=g),
        "words": torch.randn(nb, L, D, generator=g),
        "cap_lens": torch.tensor([5, 2, 3, 5, 1, 4]),
        # 0 and 3 share a class across the ranks' halves, 1 and 2 within.
        "class_ids": torch.tensor([7, 2, 2, 7, 1, 9])}
    data["words"] *= (torch.arange(L)[None] < data["cap_lens"][:, None]
                      ).float()[:, :, None]
    ranks = run_ranks("damsm", {"heads": heads, "data": data}, tmp_path,
                      ranks=3)

    losses = damsm_losses(heads, data, damsm, words_loss_fused)
    sum(losses.values()).backward()
    for got in ranks:
        assert set(got["losses"]) == set(losses)
        for k, v in losses.items():
            torch.testing.assert_close(got["losses"][k], v.detach(),
                                       rtol=1e-5, atol=1e-6, msg=k)
        for k, p in heads.named_parameters():
            scale = float(p.grad.abs().max())
            torch.testing.assert_close(got["grads"][k], p.grad, rtol=0,
                                       atol=1e-5 * scale, msg=k)
    torch.testing.assert_close(losses["w0"], losses["f0"])


# -- one train step against the JAX package's ------------------------------

@pytest.fixture(scope="module")
def mesh_step(tmp_path_factory):
    """The JAX step at B=4 and the port's mesh step on two ranks at local
    B=2, from the same weights, batch and noise."""
    import jax
    import jax.numpy as jnp

    from eegan_tpu.data.synthetic import synthetic_batch as jax_batch
    from eegan_tpu.training.steps import make_train_step as jax_step

    cfg, jcfg = configs(dense_d=True, magp_chunks=1)
    models, jm, jstate, jfrozen = shared_start(cfg, jcfg)
    weights = {"generator": models.generator.state_dict(),
               "attr_enhance": models.attr_enhance.state_dict(),
               "text_encoder": models.text_encoder.state_dict(),
               "image_encoder": models.image_encoder.state_dict(),
               **{f"disc_{i}": d.state_dict()
                  for i, d in enumerate(models.discriminators)}}
    batch = synthetic_batch(cfg, B, seed=3, n_words=N_WORDS)
    jbatch = jax_batch(jcfg, B, seed=3, n_words=N_WORDS)
    batch["class_ids"] = jbatch["class_ids"] = CLASS_IDS
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (B, jcfg.GAN.Z_DIM),
                                         jnp.float32))
    jnew, jmetrics = jax_step(jcfg, jm, donate=False)(jstate, jfrozen,
                                                      jbatch, key)
    ranks = run_ranks("step", dict(config=cfg, n_words=N_WORDS,
                                   weights=weights, batch=batch,
                                   noise=noise),
                      tmp_path_factory.mktemp("step"))
    return cfg, models, jnew, jmetrics, ranks


def _as_run(cfg, models, jnew, jmetrics, got):
    for name in ("generator", "attr_enhance"):
        getattr(models, name).load_state_dict(got[name])
    for d, sd in zip(models.discriminators, got["discriminators"]):
        d.load_state_dict(sd)
    return dict(cfg=cfg, state=models, metrics=got["metrics"],
                jstate=jnew, jmetrics=jmetrics)


@pytest.mark.parametrize("rank", range(RANKS))
def test_mesh_step_matches_jax(mesh_step, rank):
    cfg, models, jnew, jmetrics, ranks = mesh_step
    run = _as_run(cfg, models, jnew, jmetrics, ranks[rank])
    check_metrics(run)
    check_generator(run)
    check_discriminators(run)


def test_mesh_step_ranks_agree(mesh_step):
    r0, r1 = mesh_step[-1]
    for a, b in zip(r0["moments"], r1["moments"]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for k, v in r0["generator"].items():
        assert torch.equal(v, r1["generator"][k]), k


# -- the CLI: --mesh data:2 against one process ----------------------------

def _cli_flags(save_dir, run):
    return ["--device", "cpu", "--synthetic", "--cfg",
            os.path.join(ROOT, "cfg", "bird.yml"), "--output_dir", run,
            "--batch_size", "4", "--max_epochs", "2", "--max_iters", "1",
            "--set", f"SAVE_DIR={save_dir}", "--set", "GAN.GF_DIM=4",
            "--set", "GAN.DF_DIM=4", "--set", "TEXT.EMBEDDING_DIM=32",
            "--set", "TRAIN.CLASS_NUM=5", "--set", "RUNTIME.DATA_WORKERS=0",
            "--set", "RUNTIME.COMPUTE_DTYPE=float32",
            "--set", "RUNTIME.PALLAS_AFFINE=true"]


def _metrics(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [{k: v for k, v in row.items() if not k.startswith("perf/")}
            for row in rows]


def test_train_cli_mesh_matches_one_process(tmp_path):
    from eegan_tpu_torch.train import main

    proc = subprocess.Popen(
        [sys.executable, "-m", "eegan_tpu_torch.train",
         *_cli_flags(tmp_path, "mesh"), "--mesh", "data:2"],
        cwd=str(tmp_path), env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    _wait([proc])
    main([*_cli_flags(tmp_path, "one"), "--mesh", "data:1"])

    runs = {name: tmp_path / name for name in ("mesh", "one")}
    for d in runs.values():
        assert (d / "Model" / "netG_1.pth").is_file()
        assert (d / "Image" / "epoch_1_256.png").is_file()
    got, want = (_metrics(d / "writer" / "metrics.jsonl")
                 for d in (runs["mesh"], runs["one"]))
    assert len(got) == len(want) >= 1
    for g_row, w_row in zip(got, want):
        assert set(g_row) == set(w_row)
        for k, v in w_row.items():
            np.testing.assert_allclose(g_row[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    ckpt = {name: torch.load(d / "Model" / "state" / "1.pt",
                             weights_only=False)
            for name, d in runs.items()}
    assert ckpt["mesh"]["step"] == ckpt["one"]["step"] == 1
    _compare_checkpoints(ckpt["mesh"], ckpt["one"])


def _compare_checkpoints(got, want):
    from eegan_tpu_torch.config import fresh_config

    t = fresh_config(os.path.join(ROOT, "cfg", "bird.yml")).TRAIN
    lr_g, lr_d = t.GENERATOR_LR, t.DISCRIMINATOR_LR
    stats = {k for k in want["generator"] if "running_" in k}
    for k in stats:
        torch.testing.assert_close(got["generator"][k], want["generator"][k],
                                   rtol=1e-5, atol=1e-5)
    _close_after_adam({k: v for k, v in got["generator"].items()
                       if k not in stats},
                      {k: v for k, v in want["generator"].items()
                       if k not in stats}, lr_g, "generator")
    for i, (a, b) in enumerate(zip(got["discriminators"],
                                   want["discriminators"])):
        _close_after_adam(a, b, lr_d, f"disc_{i}")
    for name in ("g_opt", *[f"d_opt_{i}" for i in range(3)]):
        a, b = _optimizer_moments(got, name), _optimizer_moments(want, name)
        bar = 1e-2 if name == "g_opt" else 1e-4
        assert float((a - b).norm() / b.norm()) <= bar, name


def _optimizer_moments(ckpt, name):
    opt = (ckpt["g_opt"] if name == "g_opt"
           else ckpt["d_opts"][int(name.rsplit("_", 1)[1])])
    return torch.cat([s["exp_avg"].reshape(-1)
                      for _, s in sorted(opt["state"].items())])
