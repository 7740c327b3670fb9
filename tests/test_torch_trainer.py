"""The port's Trainer (``training/trainer.py``) on the CPU at tiny widths.

* Each of two iterations of ``Trainer.train`` (random weights from
  ``randomize_``) against the JAX package's ``make_train_step`` from the
  same start: the trainer's modules,
  optimizer moments and EMA before the iteration, through the JAX
  package's converters; the JAX pipeline's batch of the same synthetic
  dataset and seed (equal to the trainer's, bit for bit); the JAX
  trainer's noise (``fold_in(PRNGKey(seed), step)``). Every step taken is
  held to PERF.md §2's bars for one step: metrics rtol 1e-4 (atol 1e-5;
  the MAGP values 1e-7), parameters and EMA within 2·lr with at most 1% of
  the entries beyond lr/100, BN running stats within 1e-5. (The two
  trajectories are not held to each other over two steps: Adam's first
  step may put an entry 2·lr away, which moves the next step's losses.)
* Resume: 2 epochs straight give the same bits as 1 epoch + checkpoint +
  a new Trainer + 1 epoch (parameters, BN stats, optimizer moments, EMA,
  step, logged metrics, epoch images); K=2 steps per call the same bits
  as K=1.
* The frozen encoders hard-fail when missing, as in the JAX package.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegan_tpu.config import Config as JaxConfig
from eegan_tpu.data.pipeline import DataPipeline as JaxDataPipeline
from eegan_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from eegan_tpu.models.factory import build_models as jax_build_models
from eegan_tpu.training import state as jax_state
from eegan_tpu.training.steps import make_train_step as jax_make_train_step
from eegan_tpu.utils import torch_convert
from eegan_tpu_torch.config import Config
from eegan_tpu_torch.data.synthetic import SyntheticDataset
from eegan_tpu_torch.models.factory import randomize_
from eegan_tpu_torch.training.state import create_train_state
from eegan_tpu_torch.training.trainer import Trainer, load_frozen_encoders
from eegan_tpu_torch.utils.convert import (
    from_jax_attr_enhance,
    from_jax_discriminator,
    from_jax_generator,
)

torch.set_num_threads(1)

B, N_WORDS, SEED, EMB = 4, 40, 11, 32
STEPS = 2


def configs(**runtime):
    out = []
    for c in (Config(), JaxConfig()):
        c.GAN.GF_DIM = c.GAN.DF_DIM = 4
        c.TEXT.EMBEDDING_DIM = EMB
        c.TRAIN.BATCH_SIZE = B
        c.TRAIN.CLASS_NUM = 5
        c.TRAIN.MAX_EPOCH = 10
        c.TRAIN.WARMUP_EPOCHS = 1
        c.TRAIN.GSAVE_INTERVAL = c.TRAIN.DSAVE_INTERVAL = 1
        c.TRAIN.G_EMA_DECAY = 0.9
        c.RUNTIME.COMPUTE_DTYPE = "float32"
        c.RUNTIME.PALLAS_AFFINE = True
        c.RUNTIME.DATA_WORKERS = 0
        c.RUNTIME.ALLOW_RANDOM_ENCODERS = True
        for k, v in runtime.items():
            setattr(c.RUNTIME, k, v)
        out.append(c)
    return out


def _np(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _template(module, *args, **kw):
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                              **kw))


def snapshot(state):
    """numpy copies of the trainer's state: modules, EMA, and each Adam's
    count and moments by parameter name."""
    def moments(opt, named):
        st = [opt.state.get(p, {}) for _, p in named]
        if not st[0]:
            return None
        return (int(st[0]["step"]),
                {n: s["exp_avg"].numpy().copy() for (n, _), s in zip(named, st)},
                {n: s["exp_avg_sq"].numpy().copy()
                 for (n, _), s in zip(named, st)})

    g_named = list(state.generator.named_parameters())
    a_named = list(state.attr_enhance.named_parameters())
    g_mom = moments(state.g_opt, g_named + a_named)
    split = lambda d: ({n: d[n] for n, _ in g_named},
                       {n: d[n] for n, _ in a_named})
    return dict(
        step=state.step,
        generator=_np(state.generator.state_dict()),
        attr_enhance=_np(state.attr_enhance.state_dict()),
        discs=[_np(d.state_dict()) for d in state.discriminators],
        g_ema=_np(state.g_ema), attr_ema=_np(state.attr_ema),
        g_mom=None if g_mom is None else (g_mom[0], *map(split, g_mom[1:])),
        d_mom=[moments(o, list(d.named_parameters()))
               for d, o in zip(state.discriminators, state.d_opts)])


def jax_state_from(snap, jm, jcfg):
    """The JAX TrainState holding a snapshot of the port's state."""
    z, s = jnp.zeros((2, jcfg.GAN.Z_DIM)), jnp.zeros((2, EMB))
    tg = _template(jm.generator, z, s, s, train=True)
    ta = _template(jm.attr_enhance, s, jnp.zeros((2, 3, EMB)))
    tds = [_template(jd, jnp.zeros((2, sc, sc, 3)), s)
           for jd, sc in zip(jm.discriminators, jm.scales)]
    conv = torch_convert.convert_by_template
    gen_p = lambda sd: conv(tg["params"], sd, "params",
                            rename=torch_convert._gen_rename)
    attr_p = lambda sd: conv(ta["params"], sd, "params")
    disc_p = lambda sd, t: conv(t["params"], sd, "params",
                                rename=torch_convert._disc_rename)
    g_vars = torch_convert.convert_generator(snap["generator"], tg)
    attr_params = attr_p(snap["attr_enhance"])
    d_params = tuple(disc_p(sd, t) for sd, t in zip(snap["discs"], tds))
    g_tx, d_tx = jax_state.make_optimizers(jcfg)

    def adam(tx, params, mom, to_tree):
        opt = tx.init(params)
        if mom is None:
            return opt
        count, mu, nu = mom
        return (opt[0]._replace(count=jnp.int32(count), mu=to_tree(mu),
                                nu=to_tree(nu)), *opt[1:])

    both = lambda m: (gen_p(m[0]), attr_p(m[1]))
    return jax_state.TrainState(
        step=jnp.int32(snap["step"]),
        g_params=g_vars["params"], attr_params=attr_params,
        g_stats=g_vars["batch_stats"],
        g_opt=adam(g_tx, (g_vars["params"], attr_params), snap["g_mom"],
                   both),
        d_params=d_params,
        d_opts=tuple(adam(d_tx, p, m, lambda sd, t=t: disc_p(sd, t))
                     for p, m, t in zip(d_params, snap["d_mom"], tds)),
        g_ema=gen_p(snap["g_ema"]), attr_ema=attr_p(snap["attr_ema"]))


def jax_frozen(models, jcfg, jm):
    text_vars = torch_convert.convert_text_encoder(
        _np(models.text_encoder.state_dict()), _template(
            jm.text_encoder, jnp.zeros((2, jcfg.TEXT.WORDS_NUM), jnp.int32),
            jnp.ones((2,), jnp.int32)))
    image_vars = torch_convert.convert_image_encoder(
        _np(models.image_encoder.state_dict()),
        _template(jm.image_encoder, jnp.zeros((2, 64, 64, 3))))
    return jax_state.FrozenEncoders(text_vars=text_vars,
                                    image_vars=image_vars)


def jax_noise(step, b, z_dim):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
    return np.array(jax.random.normal(key, (b, z_dim), jnp.float32))


@pytest.fixture(scope="module")
def against_jax(tmp_path_factory):
    """The trainer's iterations, each beside a JAX step from the same
    start."""
    cfg, jcfg = configs()
    trainer = Trainer(cfg, str(tmp_path_factory.mktemp("run")),
                      dataset=SyntheticDataset(cfg, size=8, n_words=N_WORDS),
                      seed=SEED, device="cpu")
    # Random weights everywhere (randomize_): at the default init the
    # residual gammas are 0, so the SAGB convs' first gradients are 0 and
    # their second ones near Adam's eps, where a float32 rounding moves the
    # update by more than lr/100.
    models = trainer.models
    for i, m in enumerate((models.generator, models.attr_enhance,
                           *models.discriminators, models.text_encoder,
                           models.image_encoder)):
        randomize_(m, SEED + i)
    with torch.no_grad():
        for ema, m in ((trainer.state.g_ema, models.generator),
                       (trainer.state.attr_ema, models.attr_enhance)):
            for name, p in m.named_parameters():
                ema[name].copy_(p)
    jm = jax_build_models(jcfg, N_WORDS)
    jfrozen = jax_frozen(models, jcfg, jm)

    trainer.step_noise = lambda step, b: torch.from_numpy(
        jax_noise(step, b, cfg.GAN.Z_DIM))
    snaps, batches, port_metrics = [], [], []
    step_fn = trainer.train_step

    def recording_step(state, frozen, batch, noise):
        snaps.append(snapshot(state))
        batches.append(batch)
        state, metrics = step_fn(state, frozen, batch, noise)
        port_metrics.append({k: float(v) for k, v in metrics.items()})
        return state, metrics

    trainer.train_step = recording_step
    trainer.train(max_epochs=1, max_iters_per_epoch=STEPS)
    trainer.close()
    snaps.append(snapshot(trainer.state))

    jstep = jax_make_train_step(jcfg, jm, donate=False)
    jpipe = JaxDataPipeline(JaxSyntheticDataset(jcfg, size=8,
                                                n_words=N_WORDS),
                            B, seed=SEED, num_workers=0)
    jax_batches, jax_metrics, jax_states = [], [], []
    for step, batch in zip(range(STEPS), jpipe.epoch(1)):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
        jnew, m = jstep(jax_state_from(snaps[step], jm, jcfg), jfrozen,
                        batch, key)
        jax_batches.append(batch)
        jax_metrics.append({k: float(v) for k, v in m.items()})
        jax_states.append(jnew)
    return dict(cfg=cfg, trainer=trainer, snaps=snaps, batches=batches,
                port_metrics=port_metrics, jax_batches=jax_batches,
                jax_metrics=jax_metrics, jax_states=jax_states)


def test_trainer_batches_match_jax(against_jax):
    got, want = against_jax["batches"], against_jax["jax_batches"]
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_trainer_metrics_match_jax(against_jax):
    got, want = against_jax["port_metrics"], against_jax["jax_metrics"]
    assert len(got) == len(want) == STEPS
    for k_step, (g, w) in enumerate(zip(got, want), start=1):
        assert set(g) == set(w)
        for key in w:
            atol = 1e-7 if key.endswith("d_loss_gp") else 1e-5
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=atol,
                                       err_msg=f"step {k_step} {key}")


def _close_after_adam(got_sd, want_sd, lr, what):
    n = n_off = 0
    for k, want in want_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        err = np.abs(got_sd[k] - np.asarray(want))
        assert err.max() <= 2 * lr + 1e-6, (what, k, float(err.max()))
        n += err.size
        n_off += int((err > lr / 100).sum())
    assert n_off <= 0.01 * n, (what, n_off, n)


def test_trainer_parameters_match_jax(against_jax):
    cfg = against_jax["cfg"]
    g_lr, d_lr = cfg.TRAIN.GENERATOR_LR, cfg.TRAIN.DISCRIMINATOR_LR
    assert against_jax["trainer"].state.step == STEPS
    for k_step, jnew in enumerate(against_jax["jax_states"], start=1):
        got = against_jax["snaps"][k_step]
        assert got["step"] == int(jnew.step) == k_step
        want = {k: v.numpy() for k, v in from_jax_generator(
            {"params": jnew.g_params, "batch_stats": jnew.g_stats}).items()}
        stats = {k for k in want if "running_" in k}
        for k in stats:  # a forward, no Adam
            np.testing.assert_allclose(got["generator"][k], want[k],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        what = f"step {k_step}"
        _close_after_adam(got["generator"],
                          {k: v for k, v in want.items() if k not in stats},
                          g_lr, f"{what} generator")
        _close_after_adam(got["attr_enhance"], from_jax_attr_enhance(
            {"params": jnew.attr_params}), g_lr, f"{what} attr_enhance")
        want_ema = from_jax_generator({"params": jnew.g_ema,
                                       "batch_stats": jnew.g_stats})
        _close_after_adam(got["g_ema"], {k: want_ema[k] for k in got["g_ema"]},
                          g_lr, f"{what} g_ema")
        for i, (sd, p) in enumerate(zip(got["discs"], jnew.d_params)):
            _close_after_adam(sd, from_jax_discriminator({"params": p}), d_lr,
                              f"{what} disc_{i}")


def test_trainer_writes_its_artefacts(against_jax):
    trainer = against_jax["trainer"]
    out = trainer.output_dir
    for name in ("sampling_text.txt", "sample_image_64.png",
                 "epoch_1_64.png", "epoch_1_256.png"):
        assert os.path.isfile(os.path.join(out, "Image", name)), name
    assert trainer.ckpt.available_generator_epochs() == [1]
    assert trainer.ckpt.latest_epoch() == 1
    with open(os.path.join(out, "writer", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    # Logged on the persistent step, after the first iteration.
    assert [r["step"] for r in records] == [1]
    assert "errG/total" in records[0] and "errD_2/d_loss_gp" in records[0]
    assert "perf/data_wait_ms" in records[0]
    assert trainer.data_waits == STEPS


def run(out, cfg, epochs, iters=2):
    trainer = Trainer(cfg, out, dataset=SyntheticDataset(cfg, size=8,
                                                         n_words=N_WORDS),
                      seed=SEED, device="cpu")
    start = trainer.start_epoch
    trainer.train(max_epochs=epochs, max_iters_per_epoch=iters)
    trainer.close()
    return trainer, start


def final_state(trainer):
    s = trainer.state
    mods = {"generator": s.generator, "attr_enhance": s.attr_enhance,
            **{f"disc_{i}": d for i, d in enumerate(s.discriminators)}}
    out = {k: {n: v.clone() for n, v in m.state_dict().items()}
           for k, m in mods.items()}
    out["g_opt"] = s.g_opt.state_dict()["state"]
    out.update({f"d_opt_{i}": o.state_dict()["state"]
                for i, o in enumerate(s.d_opts)})
    out["g_ema"], out["attr_ema"] = s.g_ema, s.attr_ema
    return out


def assert_same_bits(a, b, what=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            assert_same_bits(a[k], b[k], f"{what}.{k}")
    else:
        assert a == b, what


def test_resume_equals_straight_run(tmp_path):
    cfg, _ = configs()
    straight, start = run(str(tmp_path / "straight"), cfg, epochs=2)
    assert start == 1 and straight.state.step == 4

    first, start = run(str(tmp_path / "resumed"), cfg, epochs=1)
    assert start == 1 and first.state.step == 2
    resumed, start = run(str(tmp_path / "resumed"), cfg, epochs=1)
    assert start == 2 and resumed.state.step == 4

    assert_same_bits(final_state(resumed), final_state(straight))
    logs = []
    for name in ("straight", "resumed"):
        with open(tmp_path / name / "writer" / "metrics.jsonl") as f:
            logs.append([{k: v for k, v in json.loads(line).items()
                          if k not in ("time",) and not k.startswith("perf/")}
                         for line in f])
    assert [r["step"] for r in logs[0]] == [1, 3]
    assert logs[0] == logs[1]
    for scale in (64, 256):
        name = f"epoch_2_{scale}.png"
        with open(tmp_path / "straight" / "Image" / name, "rb") as a, \
                open(tmp_path / "resumed" / "Image" / name, "rb") as b:
            assert a.read() == b.read(), name

    # K=2 steps per call: the same steps in order, so the same bits.
    cfg2, _ = configs(STEPS_PER_DISPATCH=2)
    grouped, _ = run(str(tmp_path / "grouped"), cfg2, epochs=2)
    assert grouped.state.step == 4
    assert_same_bits(final_state(grouped), final_state(straight))


def test_missing_encoders_hard_fail():
    """A production run must not silently train with random frozen
    encoders (reference train.py:233-248 hard-requires the DAMSM .pth)."""
    from eegan_tpu_torch.models.factory import build_models

    c, _ = configs()
    c.RUNTIME.ALLOW_RANDOM_ENCODERS = False
    _, init_frozen = create_train_state(c, build_models(c, 20, device="cpu"))
    with pytest.raises(RuntimeError, match="ALLOW_RANDOM_ENCODERS"):
        load_frozen_encoders(c, init_frozen)
    c.TEXT.DAMSM_NAME = "/nonexistent/damsm.pth"
    with pytest.raises(FileNotFoundError):
        load_frozen_encoders(c, init_frozen)
    c.TEXT.DAMSM_NAME = ""
    c.RUNTIME.ALLOW_RANDOM_ENCODERS = True
    assert load_frozen_encoders(c, init_frozen) is init_frozen
    # Explicit smoke mode downgrades a configured-but-absent path to a
    # warning.
    c.TEXT.DAMSM_NAME = "/nonexistent/damsm.pth"
    assert load_frozen_encoders(c, init_frozen) is init_frozen


def test_every_adam_entry_advances_like_optax(against_jax):
    """optax counts one step per update for the whole tree and decays the
    second moment of a zero gradient; the port's steps give a parameter off
    a loss's path (the class head in the MAGP step) a zero gradient, so
    torch's Adam advances it too."""
    state = against_jax["trainer"].state
    for opt, want in ((state.g_opt, STEPS),
                      *((o, 2 * STEPS) for o in state.d_opts)):
        steps = {int(s["step"]) for s in opt.state.values()}
        assert steps == {want}
        assert len(opt.state) == sum(len(g["params"])
                                     for g in opt.param_groups)
