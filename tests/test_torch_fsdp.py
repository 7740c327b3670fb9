"""FSDP in the port (``eegan_tpu_torch/parallel/fsdp.py``): the sharding
rule and the rank layout against the JAX package's, and the sharded train
step on gloo ranks on the CPU.

* the rule (``fsdp_spec``) on ``tests/test_fsdp.py``'s shapes, and on
  every parameter of the cfg/bird.yml-width generator, AttrEnhance and
  discriminators: the same leaves sharded as JAX's rule shards in its own
  state (shapes from ``jax.eval_shape``), and the same elements per rank;
* the rank layout of ``data:4,fsdp:2`` and ``data:2,fsdp:2``: each rank's
  place, fsdp group, batch rows and parameter slice against where
  ``make_mesh`` and the JAX shardings put them on the 8-device CPU mesh;
* one step on two gloo ranks at ``data:1,fsdp:2``, global B=4, at tiny
  widths with the rule's floor lowered so that leaves really shard:
  against the port's ``data:2`` step (run beside it, same inputs) within
  1e-6, and against JAX's step at B=4 at ``test_torch_parallel.py``'s
  bars; then two steps through ``make_multi_train_step`` with
  TRAIN.D_GRAD_CLIP, TRAIN.G_EMA_DECAY, RUNTIME.REMAT and REMAT_D on,
  against ``data:2``;
* at rest, each sharded leaf's parameter is empty and its owned slice,
  Adam moments and EMA hold 1/F of its elements; the state in the
  unsharded layout loads back into a fresh sharded state bitwise.

The bars of 1e-6 against ``data:2`` are loose: both steps average the same
full gradients with the same all-reduce, and Adam on a slice is the same
elementwise arithmetic, so the results were bitwise equal in every run so
far. ``test_torch_fsdp_cli.py`` drives the ``train`` CLI with an fsdp
axis.

Each group of ranks is a set of ``_torch_parallel_worker.py`` subprocesses
with a timeout that kills them all.
"""

import os
import subprocess
import sys
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from eegan_tpu.config import fresh_config as jax_fresh_config
from eegan_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from eegan_tpu.models.factory import build_models as jax_build_models
from eegan_tpu.parallel.fsdp import fsdp_spec as jax_fsdp_spec
from eegan_tpu.parallel.mesh import batch_sharding, make_mesh
from eegan_tpu.training.state import create_train_state as jax_train_state
from eegan_tpu.training.steps import make_train_step as jax_make_train_step
from eegan_tpu_torch.config import fresh_config
from eegan_tpu_torch.data.synthetic import synthetic_batch
from eegan_tpu_torch.models.factory import build_models
from eegan_tpu_torch.parallel.fsdp import (
    MIN_SHARD_ELEMS,
    fsdp_spec,
    has_fsdp_axis,
    shard_range,
)
from eegan_tpu_torch.parallel.mesh import Mesh, mesh_shape
from eegan_tpu_torch.utils.convert import (
    from_jax_attr_enhance,
    from_jax_discriminator,
    from_jax_generator,
)
from test_torch_parallel import (
    WORKER,
    _as_run,
    _env,
    _free_port,
    _wait,
)
from test_torch_train_step import (
    B,
    CLASS_IDS,
    N_WORDS,
    check_discriminators,
    check_generator,
    check_metrics,
    configs,
    shared_start,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIRD = os.path.join(ROOT, "cfg", "bird.yml")
RANKS = 2
# At the tests' widths (GF_DIM = DF_DIM = 4) only the discriminators'
# heads reach the rule's floor of 2^17 elements: a floor of 1024 shards
# the convs and linears of every module and leaves the biases and BN
# scales whole.
MIN_ELEMS = 1024


# -- the rule --------------------------------------------------------------

def _jax_dim(spec):
    dims = [d for d, axis in enumerate(spec) if axis == "fsdp"]
    return dims[0] if dims else None


@pytest.mark.parametrize("shape,size,min_elems", [
    ((3, 3, 256, 256), 2, None), ((3, 3, 513, 256), 2, None),
    ((256, 256), 2, None), ((64,), 2, None), ((), 2, None),
    ((4097, 4), 2, 1), ((4097, 3, 5), 2, 1), ((512, 512, 3, 3), 4, None),
    ((6, 9), 3, 1)])
def test_fsdp_spec_matches_jax(shape, size, min_elems):
    kw = {} if min_elems is None else {"min_shard_elems": min_elems}
    assert fsdp_spec(shape, size, **kw) == _jax_dim(
        jax_fsdp_spec(shape, size, **kw))


def _indexed(tree, counter):
    """``tree``'s shapes as arrays filled with each leaf's index."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = _indexed(v, counter)
        else:
            counter.append(tuple(v.shape))
            out[k] = np.full(v.shape, len(counter) - 1, np.float32)
    return out


@pytest.fixture(scope="module")
def bird_leaves():
    """(port module, its JAX param shapes by port key) of the cfg/bird.yml
    generator, AttrEnhance and discriminators."""
    jcfg = jax_fresh_config(BIRD)
    jm = jax_build_models(jcfg, N_WORDS)
    jstate, _ = jax.eval_shape(lambda: jax_train_state(
        jcfg, jm, jax.random.PRNGKey(0)))
    models = build_models(fresh_config(BIRD), N_WORDS, device="cpu")
    out = []
    for module, tree, convert in (
            (models.generator, jstate.g_params, from_jax_generator),
            (models.attr_enhance, jstate.attr_params, from_jax_attr_enhance),
            *((d, p, from_jax_discriminator) for d, p in
              zip(models.discriminators, jstate.d_params))):
        shapes = []
        sd = convert({"params": _indexed(tree, shapes)})
        jax_shape = {k: shapes[int(v.reshape(-1)[0])] for k, v in sd.items()}
        out.append((module, jax_shape))
    return out


@pytest.mark.parametrize("size", [2, 4])
def test_bird_sharded_leaves_match_jax(bird_leaves, size):
    n_sharded = n_leaves = 0
    for module, jax_shape in bird_leaves:
        params = dict(module.named_parameters())
        assert set(params) == set(jax_shape)
        for name, p in params.items():
            want = jax_fsdp_spec(jax_shape[name], size)
            got = fsdp_spec(tuple(p.shape), size)
            assert (got is None) == (_jax_dim(want) is None), name
            assert p.numel() == int(np.prod(jax_shape[name])), name
            if got is not None:
                # Elements per rank: JAX's shard against the port's slice.
                jdim = _jax_dim(want)
                j_local = (int(np.prod(jax_shape[name]))
                           // jax_shape[name][jdim] * (jax_shape[name][jdim]
                                                       // size))
                lo, hi = shard_range(p.shape[got], 0, size)
                assert p.numel() // p.shape[got] * (hi - lo) == j_local
                n_sharded += 1
            n_leaves += 1
    # The big kernels shard; the small leaves and biases do not.
    assert 0 < n_sharded < n_leaves
    assert MIN_SHARD_ELEMS == 2 ** 17


# -- the rank layout -------------------------------------------------------

@pytest.mark.parametrize("spec", ["data:4,fsdp:2", "data:2,fsdp:2"])
def test_rank_layout_matches_make_mesh(spec):
    jmesh = make_mesh(spec)
    data, fsdp = mesh_shape(spec, len(jax.devices()))
    assert jmesh.devices.shape == (data, fsdp)
    ranks = data * fsdp
    meshes = {r: Mesh(ranks, r, "cpu", fsdp=fsdp) for r in range(ranks)}
    assert all(has_fsdp_axis(m) for m in meshes.values())
    # Each device's place on the mesh: rank d*F + f.
    for d in range(data):
        group = [int(dev.id) for dev in jmesh.devices[d]]
        for f, r in enumerate(group):
            assert meshes[r].fsdp_index == f and meshes[r].rank // fsdp == d
            assert meshes[r].fsdp_ranks() == group
    # The batch rows each device holds (batch_axes: data x fsdp).
    rows = jax.device_put(np.arange(4 * ranks), batch_sharding(jmesh))
    for shard in rows.addressable_shards:
        lo, hi = meshes[int(shard.device.id)].row_range(4 * ranks)
        assert list(np.asarray(shard.data)) == list(range(lo, hi))
    # A parameter's slice: sharded over fsdp, replicated over data.
    param = jax.device_put(np.arange(6 * fsdp),
                           NamedSharding(jmesh, P("fsdp")))
    for shard in param.addressable_shards:
        m = meshes[int(shard.device.id)]
        lo, hi = shard_range(6 * fsdp, m.fsdp_index, fsdp)
        assert list(np.asarray(shard.data)) == list(range(lo, hi))


@pytest.mark.parametrize("spec,n,err", [
    ("data:-1,fsdp:3", 4, ValueError), ("data:2,fsdp:2", 2, ValueError),
    ("fsdp:2,data:2", 4, NotImplementedError)])
def test_bad_fsdp_specs_raise(spec, n, err):
    with pytest.raises(err):
        mesh_shape(spec, n)


def test_mesh_checks_fsdp_divides_ranks():
    with pytest.raises(ValueError, match="does not divide"):
        Mesh(6, 0, "cpu", fsdp=4)
    # The batch is split over all D*F ranks.
    with pytest.raises(ValueError, match="not divisible by 4 ranks"):
        Mesh(4, 1, "cpu", fsdp=2).row_range(6)
    assert Mesh(4, 3, "cpu", fsdp=2).row_range(8) == (6, 8)
    assert mesh_shape("data:2,fsdp:2", None) == (2, 2)
    assert mesh_shape("fsdp:-1", 4) == (1, 4)


# -- the sharded step ------------------------------------------------------

def _start(task, inputs, path, ranks=RANKS):
    """Start ``task`` on ``ranks`` gloo ranks; returns (processes, the
    results' path)."""
    in_path, out_path = f"{path}.in.pt", f"{path}.out"
    torch.save(inputs, in_path)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, task, coord, str(ranks), str(r), in_path,
         out_path], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(ranks)]
    return procs, out_path


def run_groups(groups, tmp_path):
    """Several groups of ranks at once (name -> step inputs); each group's
    per-rank results."""
    started = {name: _start("step", inputs, str(tmp_path / name))
               for name, inputs in groups.items()}
    try:
        _wait([p for procs, _ in started.values() for p in procs])
    finally:
        for procs, _ in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
    return {name: [torch.load(f"{out}.{r}", weights_only=False)
                   for r in range(RANKS)]
            for name, (_, out) in started.items()}


def _weights(models):
    return {"generator": models.generator.state_dict(),
            "attr_enhance": models.attr_enhance.state_dict(),
            "text_encoder": models.text_encoder.state_dict(),
            "image_encoder": models.image_encoder.state_dict(),
            **{f"disc_{i}": d.state_dict()
               for i, d in enumerate(models.discriminators)}}


@pytest.fixture(scope="module")
def fsdp_steps(tmp_path_factory):
    """JAX's step at B=4; the port's step on two ranks at data:2 and at
    data:1,fsdp:2; and two steps of each with clipping, EMA and REMAT
    on."""
    cfg, jcfg = configs(dense_d=True, magp_chunks=1)
    models, jm, jstate, jfrozen = shared_start(cfg, jcfg)
    batch = synthetic_batch(cfg, B, seed=3, n_words=N_WORDS)
    jbatch = jax_synthetic_batch(jcfg, B, seed=3, n_words=N_WORDS)
    batch["class_ids"] = jbatch["class_ids"] = CLASS_IDS
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (B, jcfg.GAN.Z_DIM),
                                         jnp.float32))
    common = dict(config=cfg, n_words=N_WORDS, weights=_weights(models),
                  min_shard_elems=MIN_ELEMS)

    # Under REMAT the backward recomputes from the gathered parameters.
    ccfg, _ = configs(dense_d=True, magp_chunks=1,
                      runtime=dict(REMAT=True, REMAT_D=True),
                      D_GRAD_CLIP=0.05, G_EMA_DECAY=0.9)
    k_batch = {k: np.stack([v, synthetic_batch(cfg, B, seed=4,
                                               n_words=N_WORDS)[k]])
               for k, v in batch.items()}
    k_noise = np.stack([noise, np.random.RandomState(6).randn(
        *noise.shape).astype(np.float32)])
    multi = dict(common, config=ccfg, batch=k_batch, noise=k_noise,
                 steps=2)
    groups = {"data": dict(common, batch=batch, noise=noise),
              "fsdp": dict(common, batch=batch, noise=noise, fsdp=2),
              "data_k2": multi, "fsdp_k2": dict(multi, fsdp=2)}
    ranks = run_groups(groups, tmp_path_factory.mktemp("fsdp"))
    jnew, jmetrics = jax_make_train_step(jcfg, jm, donate=False)(
        jstate, jfrozen, jbatch, key)
    return cfg, models, jnew, jmetrics, ranks


def _max_gap(a, b):
    """The largest |a - b| over two results' metrics, parameters, BN
    stats, EMA and Adam moments."""
    gaps = [float((a["metrics"][k].double() - v.double()).abs().max())
            for k, v in b["metrics"].items()]
    assert set(a["metrics"]) == set(b["metrics"])
    sds = [(a[n], b[n]) for n in ("generator", "attr_enhance")]
    sds += list(zip(a["discriminators"], b["discriminators"]))
    sds += [(a[n], b[n]) for n in ("g_ema", "attr_ema") if b[n] is not None]
    for x, y in sds:
        assert set(x) == set(y)
        gaps += [float((x[k].double() - y[k].double()).abs().max())
                 for k in y if y[k].numel()]
    for key in ("moments", "second_moments"):
        for xs, ys in zip(a[key], b[key]):
            assert len(xs) == len(ys)
            gaps += [float((x - y).abs().max()) for x, y in zip(xs, ys)]
    return max(gaps)


@pytest.mark.parametrize("run", ["", "_k2"])
@pytest.mark.parametrize("rank", range(RANKS))
def test_fsdp_step_matches_data_parallel(fsdp_steps, run, rank):
    ranks = fsdp_steps[-1]
    got, want = ranks[f"fsdp{run}"][rank], ranks[f"data{run}"][rank]
    assert {k: tuple(v.shape) for k, v in got["generator"].items()} == \
        {k: tuple(v.shape) for k, v in want["generator"].items()}
    assert _max_gap(got, want) <= 1e-6


@pytest.mark.parametrize("rank", range(RANKS))
def test_fsdp_step_matches_jax(fsdp_steps, rank):
    cfg, models, jnew, jmetrics, ranks = fsdp_steps
    run = _as_run(cfg, models, jnew, jmetrics, ranks["fsdp"][rank])
    check_metrics(run)
    check_generator(run)
    check_discriminators(run)


@pytest.mark.parametrize("run", ["fsdp", "fsdp_k2"])
def test_fsdp_state_at_rest_holds_slices(fsdp_steps, run):
    ranks = fsdp_steps[-1][run]
    ema_on = run.endswith("k2")
    for got in ranks:
        full = {"generator": got["generator"],
                "attr_enhance": got["attr_enhance"],
                **{f"disc_{i}": sd
                   for i, sd in enumerate(got["discriminators"])}}
        n_sharded = 0
        for module, rows in got["at_rest"].items():
            for name, row in rows.items():
                numel = row["full"]
                assert full[module][name].numel() == numel
                want_dim = fsdp_spec(tuple(full[module][name].shape), RANKS,
                                     MIN_ELEMS)
                assert row["dim"] == want_dim, (module, name)
                assert not row["grad"], (module, name)
                if want_dim is None:
                    assert row["param"] == row["owned"] == numel
                    continue
                n_sharded += 1
                assert row["param"] == 0, (module, name)
                share = numel // RANKS
                assert row["owned"] == row["exp_avg"] == \
                    row["exp_avg_sq"] == share, (module, name)
                if module in ("generator", "attr_enhance"):
                    assert row["ema"] == (share if ema_on else None)
        assert n_sharded >= 20


def _equal_trees(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal_trees, a, b))
    return a == b


@pytest.mark.parametrize("run", ["fsdp", "fsdp_k2"])
def test_fsdp_state_reloads_from_the_unsharded_layout(fsdp_steps, run):
    """A sharded state loads the unsharded layout (a checkpoint of any
    mesh) and gives it back bitwise: parameters, BN stats, both Adam
    moments, step counts and EMA."""
    for got in fsdp_steps[-1][run]:
        assert got["full"]["step"] == (2 if run.endswith("k2") else 1)
        assert _equal_trees(got["reloaded"], got["full"])
