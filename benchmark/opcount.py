"""Operation counts of a region of PyTorch code.

Frozen copy of ``eegan_tpu_torch/utils/opcount.py`` at git 310df21 (the
port's counter over ``torch.utils.flop_counter``'s registry, cuDNN's LSTM
by formula). The benchmark runs it over its own reference step on the
``meta`` device, so the count is of the cell's shapes and never of what
the program dispatches.

:class:`OpCounter` is a ``TorchDispatchMode`` that sums
``torch.utils.flop_counter.flop_registry`` over the aten operations it
sees: the products (convolutions and their backward, ``mm``, ``addmm``,
``bmm``, ``baddbmm``, attention) at 2 operations per multiply-add. It
tracks no modules: ``FlopCounterMode``'s module hooks raise inside the
gradient penalty's ``torch.autograd.grad``. cuDNN's LSTM
(``aten._cudnn_rnn``) runs past the registry and is counted from its
shapes, at 2 · 4H · (I + H) per valid time step, sequence, layer and
direction.
"""

from __future__ import annotations

import collections
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


def cudnn_rnn_ops(args) -> int:
    inp, weights = args[0], args[1]
    mode, hidden, proj, layers = args[6], args[7], args[8], args[9]
    bidirectional, batch_sizes = args[13], args[14]
    if mode != 2 or proj:  # 2: cuDNN's LSTM; no projection
        raise NotImplementedError(f"_cudnn_rnn mode {mode}, proj {proj}")
    if batch_sizes is not None and len(batch_sizes):
        steps = int(sum(int(b) for b in batch_sizes))
    else:
        steps = inp.shape[0] * inp.shape[1]
    dirs = 2 if bidirectional else 1
    per_layer = len(weights) // (layers * dirs)
    total = 0
    for k in range(0, len(weights), per_layer):
        w_ih = weights[k]  # (4H, I)
        total += 2 * steps * w_ih.shape[0] * (w_ih.shape[1] + hidden)
    return total


FORMULA_OPS = {torch.ops.aten._cudnn_rnn: cudnn_rnn_ops}


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: ...`` -> ``c.by_op``: operations per aten
    op name; ``c.total``."""

    def __init__(self):
        super().__init__()
        self.by_op: Dict[str, int] = collections.Counter()
        self.formula: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        count = flop_registry.get(packet)
        if count is not None:
            self.by_op[str(packet)] += int(count(*args, **kwargs,
                                                 out_val=out))
        elif packet in FORMULA_OPS:
            self.by_op[str(packet)] += FORMULA_OPS[packet](args)
            self.formula.add(str(packet))
        return out

    @property
    def total(self) -> int:
        return sum(self.by_op.values())
