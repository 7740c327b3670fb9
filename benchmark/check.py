"""The numbers that decide ``correct``, from the program's readings and
the reference's.

Training: the first steps of the window's own call against the
reference's same steps from the same weights, batches and noise. A
tensor's gap is |program - reference| over the larger of the
reference's value and the median tensor's of the same optimizer.

* ``grad_gap_g_pd_median``: the median generator tensor's gap in the
  norm of its first gradient: the program's as Adam got it (from Adam's
  first moment after one update, m / (1 - B1)), the reference's taken at
  the discriminators the program's first generator phase saw
  (:func:`pd_gap`). Both sides then differ by the step's rounding
  alone.
* ``grad_gap_magp_pd_median``: the same for the discriminators' tensors
  and their first MAGP's gradient (from Adam's first moments after the
  second update), the reference's taken at the parameters the program's
  first MAGP saw: the MAGP's double backward at every scale.
* ``loss_gap_first_mean``: the mean gap of the first step's
  discriminator hinge and class losses, computed on both sides from the
  same weights before any update: the generator's and the
  discriminators' forward passes against the reference's own.
* ``change_gap_median``: the median trained tensor's gap in the norm of
  its change over the checked steps, leaving out the tensors whose
  reference gradient is under a thousandth of the median tensor's (Adam
  moves them by its rounding).
* ``loss_gap_damsm_first_mean`` (a data mesh's cells): the mean gap of
  the first step's DAMSM sentence, words and attribute losses, computed
  on both sides from the seed's weights before any generator update and
  over the whole batch's grid of images and texts, which the mesh's
  processes hold in parts (:func:`damsm_first_mean`).
* ``bn_gap_first_max`` (a data mesh's cells): the generator's batch
  norms' first batch moments, the program's (from its running
  statistics) against the reference's over the whole batch; per norm
  the root mean square over channels of the mean's and the standard
  deviation's gaps in units of the reference's standard deviation, and
  the largest over the norms (:func:`bn_gaps`).

Read by ``calibrate.py`` only, not compared (sound runs spread too far on
some seeds): the largest gap of any loss or tensor. A hinge sample at
its kink flips with rounding, and Adam's first update moves every entry
by about the learning rate whatever its gradient, so rounding flips the
direction of entries whose gradient is near zero, which the
discriminators' next outputs (the MAGP's sixth power above all) and a
residual gate's cancelling gradient sum amplify.

Generation: ``image_gap``, over the sampled requests' images, the worst
image's mean absolute difference from the reference's, in 8-bit levels.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Mapping

import numpy as np

TINY_GRAD = 1e-3  # of the median tensor's gradient


def optimizer_of(leaf: str) -> str:
    net = leaf.split(".", 1)[0]
    return "g" if net in ("generator", "attr_enhance") else net


def _finite(x) -> bool:
    return x is not None and math.isfinite(x)


def loss_gaps(prog: List[Mapping[str, float]],
              ref: List[Mapping[str, float]]) -> Dict[str, float]:
    """Per step and loss (``<step>:<name>``) its gap."""
    out = {}
    for i, r in enumerate(ref):
        p = prog[i] if i < len(prog) else {}
        floor = statistics.median(abs(v) for v in r.values())
        for k, rv in r.items():
            pv = p.get(k)
            out[f"{i}:{k}"] = (abs(pv - rv) / max(abs(rv), floor, 1e-30)
                               if _finite(pv) else math.inf)
    return out


def _by_optimizer(values: Mapping[str, float]) -> Dict[str, float]:
    groups: Dict[str, List[float]] = {}
    for leaf, v in values.items():
        groups.setdefault(optimizer_of(leaf), []).append(v)
    return {g: statistics.median(vs) for g, vs in groups.items()}


def leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float],
              leaves=None) -> Dict[str, float]:
    """Per leaf, |program - reference| over max(reference, the median
    leaf of its optimizer)."""
    medians = _by_optimizer(ref)
    out = {}
    for leaf in (ref if leaves is None else leaves):
        pv, rv = prog.get(leaf), ref[leaf]
        out[leaf] = (abs(pv - rv) / max(rv, medians[optimizer_of(leaf)],
                                        1e-30) if _finite(pv) else math.inf)
    return out


def moved_leaves(ref_grads: Mapping[str, float]) -> List[str]:
    medians = _by_optimizer(ref_grads)
    return [leaf for leaf, g in ref_grads.items()
            if g >= TINY_GRAD * medians[optimizer_of(leaf)]]


def first_forward(losses: Mapping[str, float]) -> Dict[str, float]:
    """The first step's discriminator hinge and class losses: computed
    before any parameter moved, so both sides differ by the forward's
    rounding alone."""
    return {k: v for k, v in losses.items()
            if k.startswith("errD_") and not k.endswith("d_loss_gp")}


DAMSM_LOSSES = ("errG/s_loss", "errG/w_loss", "errG/a_loss")


def damsm_first_mean(prog: List[Mapping[str, float]],
                     ref: List[Mapping[str, float]]) -> float:
    """The mean gap of the first step's DAMSM losses (losses per step, as
    ``reference.steps.train`` returns them)."""
    def first(losses):
        return [{k: v for k, v in losses[0].items() if k in DAMSM_LOSSES}] \
            if losses else []

    return statistics.fmean(loss_gaps(first(prog), first(ref)).values())


BN_EPS = 1e-5


def bn_gaps(prog: Mapping[str, tuple], ref: Mapping[str, tuple]
            ) -> Dict[str, float]:
    """Per batch norm of ``ref`` ((mean, unbiased variance) per channel,
    by name), sqrt(mean over channels of ((mean_p - mean_r)^2 + (std_p -
    std_r)^2) / std_r^2), std = sqrt(variance + ``BN_EPS``); infinite
    where ``prog`` lacks the norm or reads a value that is not
    finite."""
    out = {}
    for name, (m_r, v_r) in ref.items():
        if name not in prog:
            out[name] = math.inf
            continue
        m_p, v_p = (t.double() for t in prog[name])
        m_r, v_r = m_r.double(), v_r.double()
        s_r = (v_r + BN_EPS).sqrt()
        s_p = (v_p.clamp_min(0.0) + BN_EPS).sqrt()
        gap = float(((((m_p - m_r) / s_r).square()
                      + ((s_p - s_r) / s_r).square()).mean()).sqrt())
        out[name] = gap if math.isfinite(gap) else math.inf
    return out


def _median(gaps: Mapping[str, float]) -> float:
    return statistics.median(gaps.values()) if gaps else math.inf


def train_numbers(prog, ref) -> Dict[str, float]:
    """The numbers the train cells compare, but those taken at the
    program's own parameters (:func:`pd_gap`). ``prog`` and
    ``ref``: (losses per step, first gradient norms, change norms), as
    ``reference.steps.train`` returns them."""
    p_loss, p_grad, p_change = prog
    r_loss, r_grad, r_change = ref
    changes = leaf_gaps(p_change, r_change, moved_leaves(r_grad))
    first = loss_gaps([first_forward(p_loss[0])] if p_loss else [],
                      [first_forward(r_loss[0])])
    return {
        "loss_gap_first_mean": statistics.fmean(first.values()),
        "change_gap_median": _median(changes),
    }


def pd_gap(prog_grads: Mapping[str, float],
           ref_grads: Mapping[str, float]) -> float:
    """The median tensor's gradient gap over the tensors of
    ``ref_grads``: the reference's gradient taken where the program's
    was, at the program's own parameters."""
    return _median(leaf_gaps(prog_grads, ref_grads))


def image_gap(prog: List[np.ndarray], ref: List[np.ndarray]) -> float:
    """The worst image's mean |program - reference| in levels, over
    batches of uint8 images (B, H, W, 3)."""
    if len(prog) != len(ref) or not prog:
        return math.inf
    worst = 0.0
    for p, r in zip(prog, ref):
        if p.shape != r.shape:
            return math.inf
        d = np.abs(p.astype(np.int16) - r.astype(np.int16))
        worst = max(worst, float(d.reshape(len(d), -1).mean(1).max()))
    return worst


def checks(numbers: Mapping[str, float], limits: Mapping[str, float]
           ) -> Dict[str, Dict[str, float]]:
    """Each number the cell file's ``limits`` name, beside its limit."""
    return {k: {"value": float(numbers.get(k, math.inf)),
                "limit": float(limits[k])} for k in limits}
