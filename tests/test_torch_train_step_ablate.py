"""The train step's other settings: the ablations, BF16_IMAGES, the
settings it refuses, and the K-step form.

One ablated step (``dcond``, ``words`` and ``magp`` together) is held
against ``eegan_tpu.training.steps.make_train_step`` on the CPU, with the
set-up and tolerances of ``test_torch_train_step.py``. The others are
checked on the port alone at the same tiny width: what an ablation removes
does not run (a forward hook counts the calls), and the K-step form gives
the K single steps' results exactly.
"""

import numpy as np
import pytest
import torch
from test_torch_train_step import (
    B,
    N_WORDS,
    check_discriminators,
    check_generator,
    check_metrics,
    configs,
    run_both,
)

from eegan_tpu_torch.data.synthetic import synthetic_batch
from eegan_tpu_torch.models.factory import build_models
from eegan_tpu_torch.training.state import create_train_state
from eegan_tpu_torch.training.steps import (
    make_multi_train_step,
    make_train_step,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run():
    return run_both(dense_d=True, magp_chunks=1,
                    ablate=frozenset({"dcond", "words", "magp"}))


def test_ablated_metrics_match_jax(run):
    check_metrics(run)
    assert not any(k.endswith("d_loss_gp") for k in run["metrics"])
    assert float(run["metrics"]["errG/w_loss"]) == 0.0


def test_ablated_generator_matches_jax(run):
    check_generator(run)


def test_ablated_discriminators_match_jax(run):
    check_discriminators(run)


def _port(seed=0, **runtime):
    cfg = configs(True, 1)[0]
    for k, v in runtime.items():
        setattr(cfg.RUNTIME, k, v)
    torch.manual_seed(seed)
    models = build_models(cfg, N_WORDS, device="cpu")
    batch = synthetic_batch(cfg, B, seed=1, n_words=N_WORDS)
    noise = np.random.RandomState(2).randn(B, cfg.GAN.Z_DIM).astype(
        np.float32)
    return cfg, models, batch, noise


def _calls(module):
    calls = []
    module.register_forward_hook(lambda *a: calls.append(1))
    return calls


@pytest.mark.parametrize("runtime,ablate,error", [
    (dict(MESH="fsdp:2,data:2"), (), NotImplementedError),
    (dict(MESH="tensor:-1"), (), NotImplementedError),
    (dict(MESH="data:1,model:2"), (), NotImplementedError),
    (dict(), ("nope",), ValueError)])
def test_unported_settings_are_refused(runtime, ablate, error):
    cfg, models, _, _ = _port(**runtime)
    with pytest.raises(error, match="not ported|unknown ablate"):
        make_train_step(cfg, models, frozenset(ablate))


def test_ablate_dsteps_leaves_the_discriminators():
    cfg, models, batch, noise = _port()
    before = [{k: v.clone() for k, v in d.state_dict().items()}
              for d in models.discriminators]
    g_before = {k: v.clone() for k, v in models.generator.state_dict().items()}
    state, frozen = create_train_state(cfg, models)
    state, metrics = make_train_step(cfg, models, frozenset({"dsteps"}))(
        state, frozen, batch, noise)
    assert not any(k.startswith("errD") for k in metrics)
    for d, sd in zip(state.discriminators, before):
        for k, v in d.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    assert any(not torch.equal(v, g_before[k])
               for k, v in state.generator.state_dict().items())


@pytest.mark.parametrize("key,encoder", [("damsm", "image_encoder"),
                                         ("text", "text_encoder")])
def test_ablation_skips_its_encoder(key, encoder):
    cfg, models, batch, noise = _port()
    calls = _calls(getattr(models, encoder))
    state, frozen = create_train_state(cfg, models)
    _, metrics = make_train_step(cfg, models, frozenset({key}))(
        state, frozen, batch, noise)
    assert not calls
    assert all(np.isfinite(float(v)) for v in metrics.values())
    if key == "damsm":
        for k in ("s_loss", "w_loss", "a_loss"):
            assert float(metrics[f"errG/{k}"]) == 0.0


def test_bf16_images_reach_the_discriminators_in_bf16():
    cfg, models, batch, noise = _port(BF16_IMAGES=True)
    seen = []
    for d in models.discriminators:
        d.conv_img.register_forward_pre_hook(
            lambda mod, args: seen.append(args[0].dtype))
    state, frozen = create_train_state(cfg, models)
    _, metrics = make_train_step(cfg, models)(state, frozen, batch, noise)
    # The D and MAGP phases take bf16 images; the G phase takes the
    # generator's float32 output.
    assert set(seen) == {torch.bfloat16, torch.float32}
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_multi_step_is_k_single_steps():
    k = 2
    cfg, models, batch, noise = _port(seed=3)
    batches = [batch, synthetic_batch(cfg, B, seed=7, n_words=N_WORDS)]
    noises = np.stack([noise, noise[::-1].copy()])
    state, frozen = create_train_state(cfg, models)
    stacked = {name: np.stack([b[name] for b in batches])
               for name in batch}
    state, stacked_metrics = make_multi_train_step(cfg, models)(
        state, frozen, stacked, noises)
    multi = {n: v.clone() for n, v in state.generator.state_dict().items()}

    _, models2, _, _ = _port(seed=3)  # the same initial weights
    state2, frozen2 = create_train_state(cfg, models2)
    step = make_train_step(cfg, models2)
    singles = []
    for j in range(k):
        state2, m = step(state2, frozen2, batches[j], noises[j])
        singles.append(m)
    assert state.step == state2.step == k
    for name, v in stacked_metrics.items():
        assert tuple(v.shape) == (k,)
        for j in range(k):
            assert float(v[j]) == float(singles[j][name]), (name, j)
    for n, v in state2.generator.state_dict().items():
        torch.testing.assert_close(multi[n], v, rtol=0, atol=0)
