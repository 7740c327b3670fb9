"""A tiny copy of the benchmark for CPU runs: the cells' files under a
temporary root, at GF_DIM = DF_DIM = 4, a 50-word vocabulary, float32 and
a few rows (the published widths run on the card only)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_TRAFFIC = {
    "train_b32_k8": dict(batch_per_card=4, steps_per_call=4, pool_batches=4),
    "train_b24_k4": dict(batch_per_card=4, steps_per_call=4, pool_batches=8),
    "train_mesh_b32x4_k8": dict(batch_per_card=2, steps_per_call=4,
                                pool_batches=4),
    "generate_b128": dict(batch=4, pool=32, warmup=1, kept=2,
                          traced_requests=1),
}


def make_tiny(dst: Path) -> Path:
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for p in (dst / "benchmark" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["model"]["GAN"]["GF_DIM"] = c["model"]["GAN"]["DF_DIM"] = 4
        c["n_words"] = 50
        p.write_text(json.dumps(c))
    for name, kv in TINY_TRAFFIC.items():
        p = dst / "benchmark" / "traffic" / f"{name}.json"
        t = json.loads(p.read_text())
        t.update(kv)
        p.write_text(json.dumps(t))
    for p in (dst / "benchmark" / "workloads").glob("*.json"):
        w = json.loads(p.read_text())
        w["runtime"]["COMPUTE_DTYPE"] = "float32"
        p.write_text(json.dumps(w))
    return dst


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny(tmp_path)
