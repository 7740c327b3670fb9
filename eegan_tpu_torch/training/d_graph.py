"""The discriminators' phase of the train step as CUDA graphs.

Per scale the D phase (``training/steps.py``) is four units: the hinge
(zero the D's gradients, the loss, its backward), its Adam update, the
MAGP (zero the gradients, the chunks' penalty, its backward) and a second
update. It reads the step's real and detached fake images, the sentence
codes and the class labels; it writes the discriminators' parameters,
their Adam state and the D metrics. It draws no random number, reads
nothing on the host and has no autograd link to the rest of the step. So
:func:`capture` records each unit once as a ``torch.cuda.CUDAGraph`` (the
four of every scale in one memory pool, in the order they run) and
:meth:`DPhaseGraphs.run` replays them: the same kernels in the same order
and dtypes, from twelve graph launches instead of the thousands of
operations the host dispatches for the eager phase.

:func:`eager_reason` says whether a step may replay. It looks only at
what the step can observe; otherwise the step runs its D phase eagerly,
as it always did, and ``eager[reason]`` counts it:

- ``device``: not a CUDA device;
- ``mesh``: a mesh (its collectives and FSDP's gathers stay eager);
- ``ablate``: a phase ablated;
- ``remat``: a checkpointed discriminator (RUNTIME.REMAT with REMAT_D);
- ``step_hook``: a step hook on a D optimizer, or a global one (a replay
  cannot call Python);
- ``dispatch_mode``: a ``TorchDispatchMode`` is active (an operation
  counter has to see every operation);
- ``shape``: the inputs' shapes, dtypes or device differ from those at
  capture (a short last batch; there is no capture per shape);
- before a capture only: ``optimizer`` (a D optimizer is not
  ``capturable``), ``first_step`` (a D optimizer holds no state yet: Adam
  makes it at its first update) and ``profiler`` (no capture while a
  ``torch.profiler`` session runs; replays under one are traced).

A capture belongs to one train state (``TrainState.d_graphs``), so every
step function over that state shares it. It keeps the parameters' storage
and the optimizers' state it writes alive, and :meth:`DPhaseGraphs.stale`
sees either replaced (``load_full_state_dict`` makes new optimizer state),
or the TF32 and determinism settings that chose its kernels changed: the
step then drops it and captures again.

Counters: ``replays`` counts the steps whose D phase replayed, ``eager``
those that ran it eagerly, by reason.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from eegan_tpu_torch.training.logging import span

GRAPH_SPAN = "train.d_graph"

replays = 0
eager: collections.Counter = collections.Counter()


def count(reason: Optional[str]) -> None:
    """Count one step's D phase: replayed (``reason`` None) or eager."""
    global replays
    if reason is None:
        replays += 1
    else:
        eager[reason] += 1


class Inputs(NamedTuple):
    """What the D phase reads: by scale the real and the fake images, then
    the sentence codes, the mismatched ones and the class labels (None
    without a class head)."""

    reals: Sequence[torch.Tensor]
    fakes: Sequence[torch.Tensor]
    sent: torch.Tensor
    unpair_sent: torch.Tensor
    class_labels: Optional[torch.Tensor]

    def tensors(self) -> List[Optional[torch.Tensor]]:
        return [*self.reals, *self.fakes, self.sent, self.unpair_sent,
                self.class_labels]


class Units(NamedTuple):
    """The step's D units at scale ``i``: ``hinge(i, inputs)`` -> the
    hinge metrics by name, ``magp(i, inputs)`` -> the penalty,
    ``update(i)``."""

    hinge: Callable[[int, Inputs], Dict[str, torch.Tensor]]
    magp: Callable[[int, Inputs], torch.Tensor]
    update: Callable[[int], None]


def has_step_hook(opt: torch.optim.Optimizer) -> bool:
    """Whether ``opt.step()`` would call a Python hook: its own or a
    global one."""
    from torch.optim import optimizer as optim_mod

    return bool(getattr(opt, "_optimizer_step_pre_hooks", None)
                or getattr(opt, "_optimizer_step_post_hooks", None)
                or optim_mod._global_optimizer_pre_hooks
                or optim_mod._global_optimizer_post_hooks)


def settings() -> Tuple:
    """The backend settings that choose the kernels a capture records."""
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.are_deterministic_algorithms_enabled())


def signature(inputs: Inputs) -> Tuple:
    """Each input's shape, dtype and device."""
    return tuple(None if t is None else (t.shape, t.dtype, t.device)
                 for t in inputs.tensors())


def eager_reason(device, mesh, ablate, discriminators,
                 d_opts: Sequence[torch.optim.Optimizer], inputs: Inputs,
                 captured: Optional[Tuple] = None) -> Optional[str]:
    """Why this step's D phase runs eagerly, or None when it may replay
    (``captured``: the :func:`signature` of the capture it would replay;
    None when it would capture first)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    if torch.device(device).type != "cuda":
        return "device"
    if mesh is not None:
        return "mesh"
    if ablate:
        return "ablate"
    if any(getattr(d, "remat", False) for d in discriminators):
        return "remat"
    if any(has_step_hook(o) for o in d_opts):
        return "step_hook"
    if _get_current_dispatch_mode() is not None:
        return "dispatch_mode"
    if captured is not None:
        return "shape" if signature(inputs) != captured else None
    if not all(g.get("capturable", False) for o in d_opts
               for g in o.param_groups):
        return "optimizer"
    if not all(o.state for o in d_opts):
        return "first_step"
    if torch.autograd._profiler_enabled():
        return "profiler"
    return None


def _params(d_opts) -> List[torch.Tensor]:
    return [p for o in d_opts for g in o.param_groups for p in g["params"]]


class DPhaseGraphs:
    """One capture of the D phase: the static inputs, four graphs a scale
    and the metric tensors they write."""

    def __init__(self, static: Inputs, graphs: List[List], names: List[str],
                 outputs: List[torch.Tensor], d_opts, signature_: Tuple):
        self.static = static
        self.graphs = graphs
        self.names = names
        self.outputs = outputs
        self.signature = signature_
        self.settings = settings()
        params = _params(d_opts)
        # What the graphs write, kept alive: the parameters' storage (a
        # detached alias) and each optimizer's state.
        self.storage = [p.detach() for p in params]
        self.ptrs = [p.data_ptr() for p in params]
        self.states = [o.state for o in d_opts]

    def stale(self, d_opts) -> bool:
        """Whether a parameter's storage or an optimizer's state is no
        longer the one the graphs write, or the settings changed."""
        return (any(o.state is not s for o, s in zip(d_opts, self.states))
                or [p.data_ptr() for p in _params(d_opts)] != self.ptrs
                or settings() != self.settings)

    def run(self, inputs: Inputs, hinge_spans: Sequence[str],
            magp_spans: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Copy ``inputs`` in and replay each scale's units under the
        spans its eager units run under: the metrics, this step's own."""
        s = self.static
        for i, g in enumerate(self.graphs):
            with span(hinge_spans[i]):
                s.reals[i].copy_(inputs.reals[i])
                s.fakes[i].copy_(inputs.fakes[i])
                if i == 0:
                    s.sent.copy_(inputs.sent)
                    s.unpair_sent.copy_(inputs.unpair_sent)
                    if s.class_labels is not None:
                        s.class_labels.copy_(inputs.class_labels)
                with span(GRAPH_SPAN):
                    g[0].replay()
            with span("train.update"), span(GRAPH_SPAN):
                g[1].replay()
            with span(magp_spans[i]), span(GRAPH_SPAN):
                g[2].replay()
            with span("train.update"), span(GRAPH_SPAN):
                g[3].replay()
        return dict(zip(self.names, torch.stack(self.outputs).unbind()))


def capture(units: Units, inputs: Inputs, d_opts) -> DPhaseGraphs:
    """Capture the D phase at ``inputs``. A capture runs nothing: the
    caller replays it for this step."""
    labels = inputs.class_labels
    static = Inputs([t.clone() for t in inputs.reals],
                    [t.clone() for t in inputs.fakes], inputs.sent.clone(),
                    inputs.unpair_sent.clone(),
                    None if labels is None else labels.clone())
    n = len(static.reals)
    stream = torch.cuda.Stream()
    # Warm-up on the capture stream, as torch's capture rules ask: the
    # units that write only gradients (the hinge zeroes them again).
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for i in range(n):
            units.hinge(i, static)
            units.magp(i, static)
    torch.cuda.current_stream().wait_stream(stream)
    # cuBLAS keeps a workspace per handle and stream for the life of the
    # process. Cleared here and after the captures (as torch's own CUDA
    # graph trees do), the capture stream's workspaces are made during the
    # capture, in the graphs' private pool, which keeps that memory for
    # the graphs once the second clear frees it; the eager ones are made
    # again by the next eager matmul.
    torch._C._cuda_clearCublasWorkspaces()

    pool = None

    def record(fn, *args):
        nonlocal pool
        g = torch.cuda.CUDAGraph()
        # thread_local: a data loader's thread may copy meanwhile.
        with torch.cuda.graph(g, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            out = fn(*args)
        pool = g.pool()
        return g, out

    graphs, names, outputs = [], [], []
    for i in range(n):
        g_hinge, metrics = record(units.hinge, i, static)
        g_update, _ = record(units.update, i)
        g_magp, gp = record(units.magp, i, static)
        g_update2, _ = record(units.update, i)
        graphs.append([g_hinge, g_update, g_magp, g_update2])
        names += [*metrics, f"errD_{i}/d_loss_gp"]
        outputs += [*metrics.values(), gp]
    torch._C._cuda_clearCublasWorkspaces()
    return DPhaseGraphs(static, graphs, names, outputs, d_opts,
                        signature(inputs))
