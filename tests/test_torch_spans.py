"""The port's spans (``training/logging.py:span``) in a profiler's trace.

* With no profiler running a span does no profiler work: a train step and
  a sampling call run with ``record_function`` made to raise.
* Under ``torch.profiler`` (host activity only) a tiny CPU call of two
  train steps, with PALLAS_DAMSM and PALLAS_AFFINE on (both op entries
  take their plain paths inside their spans), holds each step's spans
  once, the phases as disjoint siblings under ``train.step``, and the op
  entries inside the phase that calls them; a sampling call holds
  ``sample.step`` with ``sample.text`` and ``sample.generator`` inside.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eegan_tpu_torch.config import Config
from eegan_tpu_torch.data.synthetic import synthetic_batch
from eegan_tpu_torch.models.factory import build_models, randomize_
from eegan_tpu_torch.training.logging import SPAN_PREFIX, span
from eegan_tpu_torch.training.state import create_train_state
from eegan_tpu_torch.training.steps import (
    make_multi_train_step,
    make_sample_step,
)

B, N_WORDS, WIDTH, CLASS_NUM, K = 4, 40, 4, 10, 2
PHASES = ("train.text", "train.generator", "train.d_hinge", "train.d_magp",
          "train.g_loss", "train.update", "train.ema")


def _config():
    cfg = Config()
    cfg.GAN.GF_DIM = cfg.GAN.DF_DIM = WIDTH
    cfg.TRAIN.CLASS_NUM = CLASS_NUM
    cfg.RUNTIME.COMPUTE_DTYPE = "float32"
    cfg.RUNTIME.PALLAS_AFFINE = True
    cfg.RUNTIME.PALLAS_DAMSM = True
    return cfg


def _models(cfg):
    models = build_models(cfg, N_WORDS, device="cpu")
    for i, m in enumerate((models.generator, models.attr_enhance,
                           models.text_encoder, models.image_encoder,
                           *models.discriminators)):
        randomize_(m, i)
    return models


def _train_call(cfg, models):
    """One call of K steps: -> run() that makes it."""
    state, frozen = create_train_state(cfg, models)
    multi = make_multi_train_step(cfg, models)
    batches = [synthetic_batch(cfg, B, seed=j, n_words=N_WORDS)
               for j in range(K)]
    stacked = {k: torch.from_numpy(np.stack([b[k] for b in batches]))
               for k in batches[0]}
    noise = torch.randn((K, B, cfg.GAN.Z_DIM),
                        generator=torch.Generator().manual_seed(0))
    return lambda: multi(state, frozen, stacked, noise)


def _sample_call(cfg, models):
    sample = make_sample_step(cfg, models)
    b = synthetic_batch(cfg, B, seed=9, n_words=N_WORDS)
    noise = torch.randn((B, cfg.GAN.Z_DIM),
                        generator=torch.Generator().manual_seed(1))
    return lambda: sample(b["caps"], b["cap_lens"], b["attrs"],
                          b["attr_lens"], noise)


@pytest.fixture(scope="module")
def cfg_models():
    torch.manual_seed(0)
    cfg = _config()
    return cfg, _models(cfg)


def _spans(prof):
    """(name without the prefix, start us, end us) of every span, by
    start."""
    out = [(e.name[len(SPAN_PREFIX):], e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith(SPAN_PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(a, b):
    return b[1] <= a[1] and a[2] <= b[2]


def _family(name):
    """A phase's name without its scale (``train.d_hinge.2`` ->
    ``train.d_hinge``)."""
    head, _, tail = name.rpartition(".")
    return head if tail.isdigit() else name


def test_span_does_no_profiler_work_without_a_profiler(cfg_models,
                                                       monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    # span()'s own route in; torch's optimizers keep theirs.
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with span("test.off") as entered:
        assert entered is None
    cfg, models = cfg_models
    _, metrics = _train_call(cfg, models)()
    assert torch.isfinite(metrics["errG/total"]).all()
    imgs = _sample_call(cfg, models)()
    assert len(imgs) == 3


def test_train_step_spans(cfg_models):
    cfg, models = cfg_models
    run = _train_call(cfg, models)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = _spans(prof)
    steps = [s for s in spans if s[0] == "train.step"]
    assert len(steps) == K
    for step in steps:
        inside = [s for s in spans if s is not step and _inside(s, step)]
        counts = collections.Counter(s[0] for s in inside
                                     if not s[0].startswith("ops."))
        assert counts == {
            "train.text": 1, "train.generator": 1, "train.g_loss": 1,
            "train.update": 7, "train.d_hinge.0": 1, "train.d_hinge.1": 1,
            "train.d_hinge.2": 1, "train.d_magp.0": 1, "train.d_magp.1": 1,
            "train.d_magp.2": 1}, counts
    phases = [s for s in spans if _family(s[0]) in PHASES]
    # Every phase lies in a step, and no phase in another.
    for p in phases:
        assert sum(_inside(p, s) for s in steps) == 1, p
        assert not any(q is not p and _inside(p, q) for q in phases), p
    # The op entries inside the phase that calls them.
    for name, phase, each in (("ops.words_similarity.fwd", "train.g_loss", 1),
                              ("ops.affine_mask_relu.fwd", "train.generator",
                               14)):
        ops = [s for s in spans if s[0] == name]
        assert len(ops) == K * each, name
        for o in ops:
            assert [p[0] for p in phases if _inside(o, p)] == [phase], name


def test_sample_step_spans(cfg_models):
    cfg, models = cfg_models
    run = _sample_call(cfg, models)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = _spans(prof)
    steps = [s for s in spans if s[0] == "sample.step"]
    assert len(steps) == 1
    names = collections.Counter(s[0] for s in spans
                                if s is not steps[0] and _inside(s, steps[0]))
    assert names == {"sample.text": 1, "sample.generator": 1,
                     "ops.affine_mask_relu.fwd": 14}, names
    gen = [s for s in spans if s[0] == "sample.generator"][0]
    assert all(_inside(s, gen) for s in spans
               if s[0] == "ops.affine_mask_relu.fwd")
    assert len(spans) == 1 + names.total()
