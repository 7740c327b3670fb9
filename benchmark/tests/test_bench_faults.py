"""The check fails what it has to fail: a run of a tiny cell with the
timed path broken underneath (the chip's look skipped) comes out not
correct, once for each fault its cell can have, and for the D phase's
own (the MAGP's gradient dropped; the discriminators in float8); so does
the control, the reference in float8 put in the program's place. A
sound run comes out correct."""

import argparse
import time

import pytest
import torch

from benchmark import harness, run
from benchmark.reference import eegan


def run_tiny(root, cell, seed=2 ** 35 + 11):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.01,
                              trace=0)
    torch.manual_seed(0)
    return run.run_cell(args, torch.device("cpu"), time.perf_counter(),
                        root)[1]


def unchanged_state(monkeypatch):
    """Each step puts every trained tensor back as it found it."""
    import eegan_tpu_torch.training.steps as steps

    real = steps.build_train_step_fn

    def build(config, models, ablate=frozenset(), mesh=None):
        step = real(config, models, ablate=ablate, mesh=mesh)

        def broken(state, frozen, batch, noise):
            params = [p for m in (state.generator, state.attr_enhance,
                                  *state.discriminators)
                      for p in m.parameters()]
            saved = [p.detach().clone() for p in params]
            state, metrics = step(state, frozen, batch, noise)
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
            return state, metrics

        return broken

    monkeypatch.setattr(steps, "build_train_step_fn", build)


def half_batch(monkeypatch):
    """Each step trains on the first half of its rows only."""
    import eegan_tpu_torch.training.steps as steps

    real = steps.build_train_step_fn

    def build(config, models, ablate=frozenset(), mesh=None):
        step = real(config, models, ablate=ablate, mesh=mesh)

        def broken(state, frozen, batch, noise):
            n = len(noise) // 2
            return step(state, frozen, {k: v[:n] for k, v in batch.items()},
                        noise[:n])

        return broken

    monkeypatch.setattr(steps, "build_train_step_fn", build)


def dropped_magp(monkeypatch):
    """The MAGP's gradient is dropped: its Adam update takes a zero one."""
    import eegan_tpu_torch.training.steps as steps

    real = steps._gradient_penalty
    monkeypatch.setattr(steps, "_gradient_penalty",
                        lambda *a: real(*a) * 0.0)


def _fp8_operands(mod, inp):
    """A forward pre-hook: the layer's input and weight in float8 for this
    call (the weight put back by :func:`_fp8_output`)."""
    mod.saved_weight = mod._parameters.pop("weight")
    mod.weight = eegan.fp8_round(mod.saved_weight)
    return (eegan.fp8_round(inp[0]), *inp[1:])


def _fp8_output(mod, inp, out):
    del mod.weight
    mod._parameters["weight"] = mod.saved_weight
    return eegan.fp8_round(out)


def fp8_discriminators(monkeypatch):
    """The discriminators' convolutions and linear layers in float8 (e4m3
    operands and outputs, one scale per tensor; e5m2 gradients back): the
    D phase and the generator's pass through D in float8."""
    import eegan_tpu_torch.models.factory as factory

    real = factory.build_models

    def build(*a, **kw):
        models = real(*a, **kw)
        for d in models.discriminators:
            for m in d.modules():
                if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                    m.register_forward_pre_hook(_fp8_operands)
                    m.register_forward_hook(_fp8_output)
        return models

    monkeypatch.setattr(factory, "build_models", build)


def altered_image(monkeypatch):
    """One image of each answer comes from another row's noise."""
    import eegan_tpu_torch.training.steps as steps

    real = steps.make_sample_step

    def make(config, models):
        sample = real(config, models)

        def broken(caps, cap_lens, attrs, attr_lens, noise):
            noise = noise.clone()
            noise[0] = noise[1]
            return sample(caps, cap_lens, attrs, attr_lens, noise)

        return broken

    monkeypatch.setattr(steps, "make_sample_step", make)


@pytest.mark.parametrize("cell", ["bird-train-b32", "bird-generate-b128"])
def test_a_sound_run_is_correct(tiny_root, cell):
    out = run_tiny(tiny_root, cell)
    assert harness.correct(out.checks), out.checks


@pytest.mark.parametrize("cell,fault", [
    ("bird-train-b32", unchanged_state), ("bird-train-b32", half_batch),
    ("coco-train-b24", half_batch), ("bird-train-b32", dropped_magp),
    ("coco-train-b24", dropped_magp), ("bird-train-b32", fp8_discriminators),
    ("coco-train-b24", fp8_discriminators),
    ("bird-generate-b128", altered_image)])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                            fault):
    fault(monkeypatch)
    out = run_tiny(tiny_root, cell)
    assert not harness.correct(out.checks), out.checks


@pytest.mark.parametrize("cell", ["bird-train-b32", "coco-train-b24",
                                  "bird-generate-b128"])
def test_the_control_is_not_correct(tiny_root, cell):
    found = harness.find_cell(cell, tiny_root)
    numbers = harness.driver(found.traffic["kind"]).numbers_of(
        found, 2 ** 33 + 5, torch.device("cpu"), "control")
    limits = found.settings["limits"]
    assert any(numbers[k] > limits[k] for k in limits), (numbers, limits)


def test_fp8_rounding_keeps_three_bits():
    t = torch.linspace(-3, 3, 1001)
    q = eegan.fp8_round(t)
    rel = ((q - t).abs() / t.abs().clamp_min(1e-3))[t.abs() > 0.1]
    assert 0.01 < rel.max() <= 2 ** -4 + 1e-6
