"""Readings that set the limits of the correctness check, on the card.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \
        [--reading control:1,2,3] [--reading no_magp:4,5,6] [--detail]

For each seed of ``--seeds``, the check's numbers of a sound run (the
program's first call against the reference, no window); for each
``--reading <kind>:<seeds>``, of that reading put in the program's
place, as the cell's architecture (``architectures/<name>.py``) plants
it: ``control`` (the reference in float8) and, for a train cell, the
other kinds of its ``KINDS``, for a generate cell ``altered``; for a
cell whose traffic kind runs several cards (``train_mesh``), the kinds
of its ``MESH_KINDS``, read by as many ranks as a run has, this process
the first. A reading the cell's architecture does not have is refused
before anything runs. One JSON line per reading on standard output;
with ``--detail`` (train cells) also the largest gap of any loss or
tensor and the largest contributions to each. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import torch

from benchmark import check, harness
from benchmark.drivers import generate, train
from benchmark.run import ROOT, log, set_caches


def ints(text):
    return [int(x) for x in text.split(",") if x]


def worst(prog, ref, n: int = 8) -> Dict[str, List]:
    """The largest gap of any loss or tensor, and the ``n`` largest
    contributions to each with the program's and the reference's values:
    what a reader needs to tell rounding from a fault; on a mesh also
    each generator batch norm's gap of its first batch moments.
    ``prog``, ``ref``: (losses, first gradients, changes, seen)."""
    p_loss, p_grad, p_change, p_seen = prog
    r_loss, r_grad, r_change, r_seen = ref
    out = {}
    if "bn" in r_seen:
        out["bn_gap"] = check.bn_gaps(p_seen.get("bn", {}), r_seen["bn"])
    for name, gaps, pv, rv in (
            ("loss_gap", check.loss_gaps(p_loss, r_loss),
             {f"{i}:{k}": v for i, d in enumerate(p_loss)
              for k, v in d.items()},
             {f"{i}:{k}": v for i, d in enumerate(r_loss)
              for k, v in d.items()}),
            ("grad_gap", check.leaf_gaps(p_grad, r_grad), p_grad, r_grad),
            ("change_gap", check.leaf_gaps(p_change, r_change,
                                           check.moved_leaves(r_grad)),
             p_change, r_change)):
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        out[name + "_worst"] = top[0][1] if top else None
        out[name] = [[k, g, pv.get(k), rv.get(k)] for k, g in top]
    return out


def main(argv=None) -> int:
    set_caches()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=ints, default=[])
    p.add_argument("--reading", action="append", default=[],
                   help="<kind>:<seed>,<seed>...")
    p.add_argument("--detail", action="store_true")
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload, ROOT)
    drv = harness.driver(cell.traffic["kind"])
    mesh = drv.CARDS > 1
    is_train = cell.traffic["kind"] in ("train", "train_mesh")
    kinds = getattr(cell.arch, "MESH_KINDS" if mesh else
                    "KINDS" if is_train else "IMAGE_KINDS", {})
    runs = [("program", s) for s in args.seeds]
    for spec in args.reading:
        kind, seeds = spec.split(":")
        if kind not in kinds:
            p.error(f"{cell.name}'s architecture has no reading {kind!r}: "
                    f"{', '.join(kinds)}")
        runs += [(kind, s) for s in ints(seeds)]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(0)
    if mesh:
        found = drv.readings(cell, runs, dev, log)
    elif is_train:
        found = ((k, s, train.readings_of(cell, s, dev, k)) for k, s in runs)
    else:
        found = ((k, s, (generate.numbers_of(cell, s, dev, k),))
                 for k, s in runs)
    t0 = time.perf_counter()
    for kind, seed, read in found:
        line = {"cell": cell.name, "reading": kind, "seed": seed,
                "numbers": read[0], "seconds": time.perf_counter() - t0}
        if is_train and args.detail:
            line["detail"] = worst(read[1], read[2])
        print(json.dumps(line), flush=True)
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
