"""The port's checkpoints (``training/checkpoint.py``): the full train state
round trip (bitwise), generator snapshots (EMA weights when on), the
pre-EMA restore, the failures that must propagate, and the frozen DAMSM
encoders, as ``tests/test_checkpoint.py`` holds the JAX package's."""

import json
import os

import numpy as np
import pytest
import torch

from eegan_tpu_torch.config import Config
from eegan_tpu_torch.models.factory import build_models, randomize_
from eegan_tpu_torch.training.checkpoint import CheckpointManager, atomic_save
from eegan_tpu_torch.training.logging import MetricWriter, StepTimer, trace
from eegan_tpu_torch.training.state import create_train_state, generator_params
from eegan_tpu_torch.training.trainer import load_frozen_encoders

torch.set_num_threads(1)


def make_state(seed=0, ema=False):
    c = Config()
    c.GAN.GF_DIM = c.GAN.DF_DIM = 4
    c.TRAIN.CLASS_NUM = 5
    c.TEXT.EMBEDDING_DIM = 16
    c.RUNTIME.COMPUTE_DTYPE = "float32"
    c.TRAIN.G_EMA_DECAY = 0.9 if ema else 0.0
    models = build_models(c, 30, device="cpu")
    for i, m in enumerate((models.generator, models.attr_enhance,
                           *models.discriminators, models.text_encoder,
                           models.image_encoder)):
        randomize_(m, seed + i)
    state, frozen = create_train_state(c, models)
    return c, state, frozen


def take_adam_steps(state, n=2):
    """Fill both kinds of optimizer state (a stand-in loss, no model
    forward)."""
    for _ in range(n):
        for params, opt in ((generator_params(state), state.g_opt),
                            *((list(d.parameters()), o) for d, o in
                              zip(state.discriminators, state.d_opts))):
            opt.zero_grad()
            sum((p * p).sum() for p in params).backward()
            opt.step()


def modules(state):
    return {"generator": state.generator, "attr_enhance": state.attr_enhance,
            **{f"disc_{i}": d for i, d in enumerate(state.discriminators)}}


def assert_tree_equal(a, b, what=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            assert_tree_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


def test_full_state_roundtrip(tmp_path):
    _, state, _ = make_state(0, ema=True)
    take_adam_steps(state)
    state.step = 42
    for ema, module in ((state.g_ema, state.generator),
                        (state.attr_ema, state.attr_enhance)):
        for k, p in module.named_parameters():
            ema[k].copy_(p.detach() + 0.5)
    mgr = CheckpointManager(str(tmp_path / "Model"))
    mgr.save_state(7, state)
    assert mgr.latest_epoch() == 7
    assert os.listdir(tmp_path / "Model" / "state") == ["7.pt"]

    _, fresh, _ = make_state(1, ema=True)  # other weights, empty optimizers
    restored, epoch = mgr.restore_state(fresh)
    assert restored is fresh and epoch == 7 and fresh.step == 42
    for name, m in modules(state).items():
        assert_tree_equal(m.state_dict(), modules(fresh)[name].state_dict(),
                          name)
    for a, b in ((state.g_opt, fresh.g_opt),
                 *zip(state.d_opts, fresh.d_opts)):
        assert_tree_equal(a.state_dict(), b.state_dict(), "opt")
    assert_tree_equal(state.g_ema, fresh.g_ema, "g_ema")
    assert_tree_equal(state.attr_ema, fresh.attr_ema, "attr_ema")
    # The optimizers still train the modules' own parameters.
    assert all(p is q for p, q in zip(fresh.g_opt.param_groups[0]["params"],
                                      generator_params(fresh)))
    before = [p.detach().clone() for p in generator_params(fresh)]
    take_adam_steps(fresh, n=1)
    take_adam_steps(state, n=1)
    for p, q, b in zip(generator_params(fresh), generator_params(state),
                       before):
        assert torch.equal(p, q) and not torch.equal(p, b)


def test_saved_epochs_and_atomic_writes(tmp_path):
    """Epochs sort as numbers; a write leaves no temporary file, and a
    failed write leaves the previous checkpoint."""
    _, state, _ = make_state()
    mgr = CheckpointManager(str(tmp_path / "Model"))
    assert mgr.latest_epoch() is None
    for epoch in (10, 2, 9):
        mgr.save_state(epoch, state)
    assert mgr.saved_epochs() == [2, 9, 10] and mgr.latest_epoch() == 10
    before = open(mgr.state_path(10), "rb").read()
    with pytest.raises(AttributeError):  # a local function: not picklable
        atomic_save(lambda: None, mgr.state_path(10))
    assert open(mgr.state_path(10), "rb").read() == before
    assert sorted(os.listdir(tmp_path / "Model" / "state")) == [
        "10.pt", "2.pt", "9.pt"]


def test_metric_writer_timer_and_trace(tmp_path):
    writer = MetricWriter(str(tmp_path / "writer"))
    writer.write_scalars(3, {"a": torch.tensor(1.5), "b": 2})
    writer.close()
    with open(tmp_path / "writer" / "metrics.jsonl") as f:
        record = json.loads(f.read())
    assert record["step"] == 3 and record["a"] == 1.5 and record["b"] == 2.0
    timer = StepTimer(batch_size=4, warmup=2)
    timer.tick()
    assert timer.images_per_sec is None
    timer.tick()
    timer.tick()
    assert timer.images_per_sec > 0
    with trace(str(tmp_path / "profile")):
        torch.ones(3).sum()
    with open(tmp_path / "profile" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


@pytest.mark.parametrize("ema", [False, True])
def test_generator_snapshot_roundtrip(tmp_path, ema):
    """netG_{epoch}: the EMA weights when G-EMA is on, the live BN stats."""
    _, state, _ = make_state(0, ema=ema)
    if ema:
        for v in (*state.g_ema.values(), *state.attr_ema.values()):
            v.add_(1.0)
    mgr = CheckpointManager(str(tmp_path / "Model"))
    mgr.save_generator(550, state)
    mgr.save_generator(560, state)
    assert mgr.available_generator_epochs() == [550, 560]
    _, other, _ = make_state(5)
    mgr.load_generator(550, other.generator, other.attr_enhance)
    for module, ema_dict, got in (
            (state.generator, state.g_ema, other.generator),
            (state.attr_enhance, state.attr_ema, other.attr_enhance)):
        want = module.state_dict()
        if ema_dict is not None:
            want.update(ema_dict)
        assert_tree_equal(got.state_dict(), want)


def test_restore_pre_ema_checkpoint_into_ema_state(tmp_path):
    """Turning G-EMA on over a run saved without it seeds the EMA from the
    restored parameters."""
    _, state, _ = make_state(0)
    assert state.g_ema is None
    mgr = CheckpointManager(str(tmp_path / "Model"))
    mgr.save_state(3, state)
    _, ema_state, _ = make_state(1, ema=True)
    restored, epoch = mgr.restore_state(ema_state)
    assert epoch == 3
    assert_tree_equal(restored.generator.state_dict(),
                      state.generator.state_dict())
    for ema, module in ((restored.g_ema, restored.generator),
                        (restored.attr_ema, restored.attr_enhance)):
        assert_tree_equal(ema, {k: p.detach() for k, p in
                                module.named_parameters()})


def test_restore_failures_propagate(tmp_path):
    """A checkpoint that DOES hold the EMA is never 'fixed' by reseeding:
    a mismatched EMA, an unreadable file and EMA turned off all raise."""
    _, ema_state, _ = make_state(0, ema=True)
    mgr = CheckpointManager(str(tmp_path / "Model"))
    mgr.save_state(5, ema_state)

    _, bad, _ = make_state(1, ema=True)
    bad.g_ema = {"bogus": torch.zeros(2, 2)}
    with pytest.raises(KeyError):
        mgr.restore_state(bad)
    _, plain, _ = make_state(1)
    with pytest.raises(KeyError, match="G_EMA_DECAY"):
        mgr.restore_state(plain)

    path = mgr.state_path(5)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    _, other, _ = make_state(1, ema=True)
    with pytest.raises(Exception):
        mgr.restore_state(other)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "Empty")).restore_state(other)


def test_frozen_roundtrip_and_parent_model_dir(tmp_path):
    """save_frozen writes <model_dir>/frozen_encoders; TEXT.DAMSM_NAME may
    name that directory or its parent Model dir."""
    c, _, frozen = make_state(0)
    mgr = CheckpointManager(str(tmp_path / "Model"))
    path = mgr.save_frozen(frozen)
    assert sorted(os.listdir(path)) == ["image_encoder.pth",
                                        "text_encoder.pth"]
    for name in (str(tmp_path / "Model"), path):
        _, _, other = make_state(9)
        c.TEXT.DAMSM_NAME = name
        got = load_frozen_encoders(c, other)
        assert got is other
        for attr in ("text_encoder", "image_encoder"):
            assert_tree_equal(getattr(got, attr).state_dict(),
                              getattr(frozen, attr).state_dict(), attr)
    _, _, other = make_state(9)
    mgr.load_frozen(other)
    assert_tree_equal(other.text_encoder.state_dict(),
                      frozen.text_encoder.state_dict())
    # The encoders stay frozen after a load.
    assert not any(p.requires_grad for p in other.image_encoder.parameters())
    assert np.isfinite(float(next(other.image_encoder.parameters()).sum()))
