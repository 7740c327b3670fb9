"""The D phase as CUDA graphs (``training/d_graph.py``), on the CPU.

Graphs are captured and replayed only on a card (``chip_smoke.py``'s
``phase_d_graph`` holds the replay to the eager phase there). Here:

* the engagement rule, one case per reason it gives, each from a state
  that would replay but for that one thing (the device passed as a
  value: nothing runs);
* a capture goes stale when an optimizer's state or a parameter's
  storage is replaced, or the TF32 settings change;
* a train call on the CPU runs its D phase eagerly, counts
  ``d_graph.eager["device"]`` once a step, and returns each step's own D
  metrics;
* an optimizer keeps its own ``capturable`` and puts its step counts
  where that flag keeps them when it loads another's state.
"""

import types

import numpy as np
import pytest
import torch
from torch.optim import optimizer as optim_mod

from eegan_tpu_torch.config import Config
from eegan_tpu_torch.data.synthetic import synthetic_batch
from eegan_tpu_torch.models.factory import build_models, randomize_
from eegan_tpu_torch.training import d_graph
from eegan_tpu_torch.training.state import (
    _load_optimizer,
    create_train_state,
)
from eegan_tpu_torch.training.steps import make_multi_train_step

torch.set_num_threads(1)

CUDA = torch.device("cuda")
B, N_WORDS, WIDTH, CLASS_NUM, K = 4, 40, 4, 10, 3


def _ready():
    """The arguments of :func:`d_graph.eager_reason` for a step that may
    capture: a card, no mesh, nothing ablated, no checkpointed D, capturable
    optimizers holding state, no hook."""
    params = [torch.nn.Parameter(torch.ones(3)) for _ in range(2)]
    opts = []
    for p in params:
        opt = torch.optim.Adam([p], capturable=True)
        opt.state[p] = {"step": torch.ones(())}
        opts.append(opt)
    inputs = d_graph.Inputs(
        reals=[torch.zeros(B, 8, 8, 3), torch.zeros(B, 16, 16, 3)],
        fakes=[torch.zeros(B, 8, 8, 3), torch.zeros(B, 16, 16, 3)],
        sent=torch.zeros(B, 6), unpair_sent=torch.zeros(B, 6),
        class_labels=torch.zeros(B, CLASS_NUM))
    discs = [types.SimpleNamespace(remat=False) for _ in params]
    return dict(device=CUDA, mesh=None, ablate=frozenset(),
                discriminators=discs, d_opts=opts, inputs=inputs,
                captured=None)


def _half_batch(kw):
    x = kw["inputs"]
    kw["captured"] = d_graph.signature(x)
    kw["inputs"] = d_graph.Inputs(
        [t[:2] for t in x.reals], [t[:2] for t in x.fakes], x.sent[:2],
        x.unpair_sent[:2], x.class_labels[:2])


def _own_hook(kw, which):
    opt = kw["d_opts"][1]
    register = (opt.register_step_pre_hook if which == "pre"
                else opt.register_step_post_hook)
    register(lambda *a: None)


class _Mode(torch.utils._python_dispatch.TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


CASES = {
    # case: (what changes, the reason)
    "cpu": (lambda kw: kw.update(device=torch.device("cpu")), "device"),
    "mesh": (lambda kw: kw.update(mesh=object()), "mesh"),
    "ablate": (lambda kw: kw.update(ablate=frozenset({"words"})), "ablate"),
    "remat": (lambda kw: setattr(kw["discriminators"][0], "remat", True),
              "remat"),
    "own_pre_hook": (lambda kw: _own_hook(kw, "pre"), "step_hook"),
    "own_post_hook": (lambda kw: _own_hook(kw, "post"), "step_hook"),
    "global_pre_hook": ("global_pre", "step_hook"),
    "global_post_hook": ("global_post", "step_hook"),
    "dispatch_mode": ("mode", "dispatch_mode"),
    "shape": (_half_batch, "shape"),
    "not_capturable": (lambda kw: kw["d_opts"][0].param_groups[0].update(
        capturable=False), "optimizer"),
    "first_step": (lambda kw: kw["d_opts"][1].state.clear(), "first_step"),
    "profiler": ("profiler", "profiler"),
}


def test_eager_reason_none_when_ready():
    kw = _ready()
    assert d_graph.eager_reason(**kw) is None
    kw["captured"] = d_graph.signature(kw["inputs"])
    assert d_graph.eager_reason(**kw) is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_reason(case):
    change, reason = CASES[case]
    kw = _ready()
    if callable(change):
        change(kw)
        assert d_graph.eager_reason(**kw) == reason
    elif change.startswith("global"):
        register = (optim_mod.register_optimizer_step_pre_hook
                    if change == "global_pre" else
                    optim_mod.register_optimizer_step_post_hook)
        handle = register(lambda *a: None)
        try:
            assert d_graph.eager_reason(**kw) == reason
        finally:
            handle.remove()
        assert d_graph.eager_reason(**kw) is None
    elif change == "mode":
        with _Mode():
            assert d_graph.eager_reason(**kw) == reason
    else:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            assert d_graph.eager_reason(**kw) == reason
            # A capture's replays run under a profiler.
            kw["captured"] = d_graph.signature(kw["inputs"])
            assert d_graph.eager_reason(**kw) is None


@pytest.mark.parametrize("replace", ["optimizer_state", "storage",
                                     "settings"])
def test_capture_goes_stale(replace):
    kw = _ready()
    opts = kw["d_opts"]
    graphs = d_graph.DPhaseGraphs(kw["inputs"], [], [], [], opts,
                                  d_graph.signature(kw["inputs"]))
    assert not graphs.stale(opts)
    p = opts[1].param_groups[0]["params"][0]
    saved = torch.backends.cuda.matmul.allow_tf32
    if replace == "optimizer_state":
        opts[1].load_state_dict(opts[1].state_dict())
    elif replace == "storage":
        p.data = p.data.clone()
    else:
        torch.backends.cuda.matmul.allow_tf32 = not saved
    try:
        assert graphs.stale(opts)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _config():
    cfg = Config()
    cfg.GAN.GF_DIM = cfg.GAN.DF_DIM = WIDTH
    cfg.TRAIN.CLASS_NUM = CLASS_NUM
    cfg.RUNTIME.COMPUTE_DTYPE = "float32"
    return cfg


def test_cpu_call_runs_eagerly_with_each_steps_metrics():
    torch.manual_seed(0)
    cfg = _config()
    models = build_models(cfg, N_WORDS, device="cpu")
    for i, m in enumerate((models.generator, models.attr_enhance,
                           models.text_encoder, models.image_encoder,
                           *models.discriminators)):
        randomize_(m, i)
    state, frozen = create_train_state(cfg, models)
    assert not any(g["capturable"] for o in state.d_opts
                   for g in o.param_groups)
    multi = make_multi_train_step(cfg, models)
    batches = [synthetic_batch(cfg, B, seed=j, n_words=N_WORDS)
               for j in range(K)]
    stacked = {k: torch.from_numpy(np.stack([b[k] for b in batches]))
               for k in batches[0]}
    noise = torch.randn((K, B, cfg.GAN.Z_DIM),
                        generator=torch.Generator().manual_seed(0))
    replays, eager = d_graph.replays, dict(d_graph.eager)
    state, metrics = multi(state, frozen, stacked, noise)
    assert d_graph.replays == replays
    assert d_graph.eager["device"] - eager.get("device", 0) == K
    assert state.d_graphs is None
    n = len(models.scales)
    d_keys = [k for k in metrics if k.startswith("errD_")]
    assert {f"errD_{i}/d_loss_gp" for i in range(n)} <= set(d_keys)
    assert f"errD_{n - 1}/real_class" in d_keys
    for k in d_keys:
        v = metrics[k]
        assert v.shape == (K,) and torch.isfinite(v).all(), k
        # Each step's own: the steps saw other batches and parameters.
        assert len(set(v.tolist())) == K, (k, v)


@pytest.mark.parametrize("saved_capturable", [True, False])
def test_optimizer_keeps_its_own_capturable(saved_capturable):
    p = torch.nn.Parameter(torch.ones(3))
    src = torch.optim.Adam([p], capturable=False)
    p.grad = torch.ones(3)
    src.step()
    sd = src.state_dict()
    sd["param_groups"][0]["capturable"] = saved_capturable
    q = torch.nn.Parameter(torch.ones(3))
    for own in (False, True):
        dst = torch.optim.Adam([q], capturable=own)
        _load_optimizer(dst, sd)
        assert dst.param_groups[0]["capturable"] is own
        step = dst.state[q]["step"]
        assert step.dtype == torch.float32 and float(step) == 1.0
        assert step.device == q.device
        assert torch.equal(dst.state[q]["exp_avg"], src.state[p]["exp_avg"])
    # The flag is the loading optimizer's: it steps on the CPU.
    dst = torch.optim.Adam([q], capturable=False)
    _load_optimizer(dst, sd)
    q.grad = torch.ones(3)
    dst.step()
    assert float(dst.state[q]["step"]) == 2.0
