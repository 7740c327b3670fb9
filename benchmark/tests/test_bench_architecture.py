"""A second architecture is new files alone: an architecture module, a
configuration that names it, a traffic mix and a cell, and entries in
``BENCHMARK.json``. No file that is there changes, and the train driver
runs the cell through the new module to a correct result."""

import argparse
import json
import time

import torch

from benchmark import harness, run
from benchmark.tests.test_bench_registry import digests

TWIN = '''"""EE-GAN's functions under another name."""

from benchmark.architectures.eegan import *  # noqa: F401,F403
'''


def add_architecture(root):
    here = root / "benchmark"
    (here / "architectures" / "eegan_twin.py").write_text(TWIN)
    config = json.loads((here / "configs" / "eegan-bird.json").read_text())
    config["architecture"] = "eegan_twin"
    (here / "configs" / "twin-bird.json").write_text(json.dumps(config))
    (here / "traffic" / "train_b2_k4_twin.json").write_text(json.dumps(
        {"kind": "train", "batch_per_card": 2, "steps_per_call": 4,
         "pool_batches": 4}))
    (here / "workloads" / "twin-train-b2.json").write_text(
        (here / "workloads" / "bird-train-b32.json").read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "twin-bird", "source": "test",
                            "file": "benchmark/configs/twin-bird.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "twin-train-b2", "config": "twin-bird",
                              "traffic": "train_b2_k4_twin", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_images_per_s":
            m["workloads"].append("twin-train-b2")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_a_second_architecture_added_as_files_runs(tiny_root):
    before = digests(tiny_root)
    add_architecture(tiny_root)
    after = digests(tiny_root)
    assert all(after[p] == d for p, d in before.items())

    cell = harness.find_cell("twin-train-b2", tiny_root)
    assert cell.arch.__file__ == str(
        tiny_root / "benchmark" / "architectures" / "eegan_twin.py")
    args = argparse.Namespace(workload="twin-train-b2", seed=2 ** 41 + 9,
                              seconds=0.01, trace=0)
    torch.manual_seed(0)
    cell, out = run.run_cell(args, torch.device("cpu"), time.perf_counter(),
                             tiny_root)
    assert out.attempted == 4 and out.failed == 0
    assert out.end_to_end["train_images_per_s"] > 0
    assert harness.correct(out.checks), out.checks
