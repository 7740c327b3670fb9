"""The port's benchmark: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` (and with ``--trace 1``
the ``breakdown`` of the traced stretch), and last ``check``: each number
that decided ``correct`` beside its limit. Those numbers are also the
last lines of standard error. The traced run writes its Chrome trace to
``benchmark_out/<cell>-<seed>.trace.json`` in the checkout.

It refuses to run (exit 2, no result) without as many CUDA devices as
the cell asks for, or when the driver of the cell's traffic kind
(``drivers/<kind>.py``, its ``CARDS``) runs another number of cards; and
exits 3 with no result when the process, or another process of the run,
holds a module of the JAX package or of JAX once the window has closed.
A driver of several cards runs this process as its first rank, on card
0. Build and kernel caches live at fixed paths inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "build/inductor",
          "CUDA_CACHE_PATH": "build/nv_compute_cache"}
OUT_DIR = "benchmark_out"


def set_caches(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path in the checkout (the
    port's own nvcc builds already go to ``build/eegan_tpu_torch``)."""
    for key, rel in CACHES.items():
        os.environ[key] = str(root / rel)
    os.environ["USE_FLAX"] = "0"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed takes a non-negative whole number")
    return args


def run_cell(args, device, t_start: float, root: Path = ROOT):
    """The cell's driver over ``device``: (cell, Outcome)."""
    from benchmark import harness

    cell = harness.find_cell(args.workload, root)
    args.trace_file = (root / OUT_DIR / f"{cell.name}-{args.seed}.trace.json"
                       if args.trace else None)
    drv = harness.driver(cell.traffic["kind"])
    return cell, drv.run(cell, args, device, t_start, log)


def main(argv=None, root: Path = ROOT) -> int:
    set_caches(root)
    sys.path.insert(0, str(ROOT))
    args = parse_args(argv)
    import torch

    from benchmark import harness

    cell = harness.find_cell(args.workload, root)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " visible")
        return 2
    kind = cell.traffic["kind"]
    cards = harness.driver(kind).CARDS
    if cards != cell.chips:
        log(f"{cell.name} asks for {cell.chips} card(s); its traffic kind "
            f"{kind!r} runs {cards}")
        return 2
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    torch.cuda.init()
    card = harness.power_limit()
    log(f"card: {card}")
    cell, out = run_cell(args, torch.device("cuda", 0), T_START, root)
    found = sorted(set(harness.forbidden_modules()) | set(out.modules))
    if found:
        log(f"the process holds {found}: the benchmark runs the port alone")
        return 3
    line = harness.result_line(cell, out, bool(args.trace), cell.chips)
    for name, c in line["check"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
