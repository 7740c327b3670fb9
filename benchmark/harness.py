"""What every cell shares: finding a cell, its configuration, its traffic
and its per-layer metrics by name; the program's configuration; seeds;
the device's record; the check on what the process imported; the result
line.

Everything of one cell is data found by name: ``BENCHMARK.json``'s
entries, ``configs/<config>.json`` (the model's sizes, as upstream
publishes them, and the name of its architecture),
``architectures/<name>.py`` (the architecture's networks, weights,
inputs, check and operation counts, which the drivers call),
``workloads/<cell>.json`` (the program's RUNTIME
settings and the limits of the correctness check), ``traffic/<mix>.json``
(the parameters that the generator of its ``kind``, ``drivers/<kind>.py``,
reads) and ``metrics/<metric>.py`` (one per-layer metric's reader).

A reader's ``read(obs)`` gets the driver's observations: always ``kind``
and ``cell`` (the :class:`Cell`: its model, traffic and RUNTIME settings
give any count from shapes); with ``--trace 1`` also ``trace`` (the traced
stretch's :class:`benchmark.trace.Summary`) and ``traced_batches`` (the
rows and caption lengths of each traced step or request); and what the
driver adds for the metrics it has.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names the process that prints a result may not hold
# once the window has closed: the JAX package and what it runs on. Each
# is compared whole with the part of a module's name before the first
# dot, so the port (``eegan_tpu_torch``) is not ``eegan_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "eegan_tpu")
H100_BF16_FLOPS = 989e12  # dense, NVIDIA's H100 SXM data sheet, at 700 W
H100_FP32_FLOPS = 67e12  # outside the tensor cores
H100_HBM_BYTES_S = 3.35e12


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    """One entry of ``workloads``, with the files it names."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict  # configs/<config>.json
    settings: Dict  # workloads/<cell>.json
    traffic: Dict  # traffic/<mix>.json
    end_to_end: List[Dict]  # the end-to-end metrics this cell reports
    per_layer: List[Dict]  # the per-layer metrics read in this cell
    root: Path = ROOT  # the checkout that holds BENCHMARK.json
    arch: Any = None  # architectures/<config's "architecture">.py

    @property
    def model(self) -> Dict:
        """The configuration's model groups (TREE, TRAIN, GAN, TEXT)."""
        return self.config["model"]


def applies(metric: Dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def find_cell(name: str, root: Path = ROOT) -> Cell:
    spec = benchmark_spec(root)
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    here = root / HERE.name
    e2e = [m for m in spec["end_to_end"] if applies(m, name, ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if applies(m, name, e2e_names)]
    settings = load_json(here / "workloads" / f"{name}.json")
    config_path = here / "configs" / f"{w['config']}.json"
    config = load_json(config_path)
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                traffic_name=w["traffic"], config=config, settings=settings,
                traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer, root=root,
                arch=architecture(config, config_path, root))


def _load(path: Path, prefix: str, name: str):
    """The module in the file ``path``, under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        prefix + "".join(c if c.isalnum() else "_" for c in name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def architecture(config: Dict, config_path: Path, root: Path = ROOT):
    """``architectures/<name>.py`` of the configuration's
    ``architecture``: the benchmark's own choice of networks, weights,
    check and counts, whatever the port's configuration holds."""
    name = config.get("architecture")
    if not isinstance(name, str) or not name.isidentifier():
        raise KeyError(f"{config_path}: no \"architecture\" names an "
                       "architectures/<name>.py")
    path = root / HERE.name / "architectures" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no such architecture, named by "
                                f"{config_path}")
    return _load(path, "benchmark_architecture_", name)


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``metrics/<name>.py``'s ``read(obs) -> float | None``."""
    return _load(root / HERE.name / "metrics" / f"{name}.py",
                 "benchmark_metric_", name).read


def driver(kind: str):
    """``drivers/<kind>.py``: the generator and runner of a traffic kind;
    its ``CARDS`` is the number of cards a run of it uses."""
    return importlib.import_module(f"benchmark.drivers.{kind}")


def port_config(cell: Cell, batch: int):
    """The program's configuration: the model groups of the cell's
    configuration file, then its RUNTIME settings, at ``batch`` rows."""
    from eegan_tpu_torch.config import Config

    config = Config()
    config.merge_dict(json.loads(json.dumps(cell.model)))
    config.merge_dict({"RUNTIME": dict(cell.settings["runtime"])})
    config.TRAIN.BATCH_SIZE = batch
    return config


def seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from the run's ``--seed`` (any
    non-negative whole number)."""
    import numpy as np

    words = np.random.SeedSequence(int(seed)).generate_state(2 * n, np.uint32)
    return [int(words[2 * i]) << 31 | int(words[2 * i + 1]) >> 1
            for i in range(n)]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def device_record(count: int, peak_bytes: int) -> Dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of card 0, for the log."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


@dataclass
class Outcome:
    """What a driver measured in one run."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]  # by metric name
    observations: Dict[str, Any]  # what the per-layer readers read
    peak_bytes: int
    checks: Dict[str, Dict[str, float]] = field(default_factory=dict)
    trace: Any = None  # trace.Summary of the traced stretch, or None
    # The forbidden modules the run's other processes held once the
    # window had closed (a driver that runs several).
    modules: List[str] = field(default_factory=list)


BIG = 1e300  # what the line says for a number that is not finite


def correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())


def result_line(cell: Cell, out: Outcome, trace: bool, count: int) -> Dict:
    """The JSON object of the run's last line of standard output."""
    device = device_record(count, out.peak_bytes)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"], cell.root)(out.observations)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    line = {"correct": correct(out.checks), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = out.trace.breakdown()
    line["check"] = {k: {"value": c["value"] if math.isfinite(c["value"])
                         else BIG, "limit": c["limit"]}
                     for k, c in out.checks.items()}
    return line
