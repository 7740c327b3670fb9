"""Port parity of the train step with DENSE_D off and MAGP_CHUNKS=2 (the
separate-pass D and the chunked gradient penalty), with the G-EMA on
(TRAIN.G_EMA_DECAY=0.9), a D gradient clip (TRAIN.D_GRAD_CLIP=0.01) and
uint8 image leaves, against ``eegan_tpu.training.steps.make_train_step``
on the CPU. The set-up and the tolerances are those of
``test_torch_train_step.py``; the EMA copies, which move by a tenth of the
parameters' step, are held to the parameters' bars.
"""

import pytest
import torch
from test_torch_train_step import (
    _close_after_adam,
    check_discriminators,
    check_generator,
    check_metrics,
    run_both,
)

from eegan_tpu_torch.utils.convert import (
    from_jax_attr_enhance,
    from_jax_generator,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run():
    return run_both(dense_d=False, magp_chunks=2, uint8_images=True,
                    G_EMA_DECAY=0.9, D_GRAD_CLIP=0.01)


def test_metrics_match_jax(run):
    check_metrics(run)


def test_generator_matches_jax(run):
    check_generator(run)


def test_discriminators_match_jax(run):
    check_discriminators(run)


def test_ema_matches_jax(run):
    state, jnew, lr = run["state"], run["jstate"], \
        run["cfg"].TRAIN.GENERATOR_LR
    want = from_jax_generator({"params": jnew.g_ema,
                               "batch_stats": jnew.g_stats})
    assert set(state.g_ema) == {k for k, _ in
                                state.generator.named_parameters()}
    _close_after_adam(state.g_ema, {k: want[k] for k in state.g_ema}, lr,
                      "g_ema")
    _close_after_adam(state.attr_ema,
                      from_jax_attr_enhance({"params": jnew.attr_ema}), lr,
                      "attr_ema")
