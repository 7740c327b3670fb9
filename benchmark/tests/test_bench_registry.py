"""Cells, configurations, traffic mixes and per-layer metrics are found
by name in files of their own: a new one is new files and new entries in
``BENCHMARK.json``, and no file that is there changes."""

import argparse
import hashlib
import json
import time

import pytest
import torch

from benchmark import harness, run

NEW_METRIC = '''"""steps_per_s.train: the window's steps per second."""

LAYER = "train step, training/steps.py"
UNIT = "steps/s"
MOVES = "train_images_per_s"


def read(obs):
    return obs.get("steps_per_s")
'''


# A count from the cell's shapes alone: kernel 1's launches in one
# generator forward, the bytes they must move at the cell's batch.
SHAPES_METRIC = '''"""affine_fwd_bytes.train: kernel 1's bytes in one generator forward
at the cell's batch, in MB."""

import torch

from benchmark.counts import affine_bytes, affine_launch_shapes

LAYER = "kernel 1, ops/affine.py"
UNIT = "MB"
MOVES = "train_images_per_s"


def read(obs):
    cell = obs.get("cell")
    if obs.get("kind") != "train" or cell is None:
        return None
    elem = torch.empty((), dtype=getattr(
        torch, cell.settings["runtime"]["COMPUTE_DTYPE"])).element_size()
    B = cell.traffic["batch_per_card"]
    return 1e-6 * sum(affine_bytes(B, C, h, w, up, elem) for C, h, w, up
                      in affine_launch_shapes(cell.model["GAN"]["GF_DIM"]))
'''


def digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def add_cell(root):
    """A configuration, a traffic mix, a cell and a per-layer metric, as a
    later change would add them."""
    here = root / "benchmark"
    config = json.loads((here / "configs" / "eegan-bird.json").read_text())
    config["model"]["TRAIN"]["BATCH_SIZE"] = 2
    (here / "configs" / "eegan-bird-b2.json").write_text(json.dumps(config))
    (here / "traffic" / "train_b2_k4.json").write_text(json.dumps(
        {"kind": "train", "batch_per_card": 2, "steps_per_call": 4,
         "pool_batches": 4}))
    settings = json.loads(
        (here / "workloads" / "bird-train-b32.json").read_text())
    (here / "workloads" / "bird-train-b2.json").write_text(
        json.dumps(settings))
    (here / "metrics" / "steps_per_s.train.py").write_text(NEW_METRIC)
    (here / "metrics" / "affine_fwd_bytes.train.py").write_text(
        SHAPES_METRIC)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "eegan-bird-b2", "source": "test",
                            "file": "benchmark/configs/eegan-bird-b2.json",
                            "reduced": ["TRAIN"]})
    spec["workloads"].append({"name": "bird-train-b2",
                              "config": "eegan-bird-b2",
                              "traffic": "train_b2_k4", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_images_per_s":
            m["workloads"].append("bird-train-b2")
    spec["per_layer"].append({"name": "steps_per_s.train", "unit": "steps/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "train step, training/steps.py",
                              "moves": "train_images_per_s",
                              "workloads": ["bird-train-b2"]})
    spec["per_layer"].append({"name": "affine_fwd_bytes.train", "unit": "MB",
                              "better": "lower", "source": "program_counter",
                              "layer": "kernel 1, ops/affine.py",
                              "moves": "train_images_per_s",
                              "workloads": ["bird-train-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_every_entry_has_its_files():
    spec = harness.benchmark_spec()
    for c in spec["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        name = json.loads((harness.ROOT / c["file"]).read_text())[
            "architecture"]
        assert (harness.HERE / "architectures" / f"{name}.py").is_file()
    for w in spec["workloads"]:
        cell = harness.find_cell(w["name"])
        kind = cell.traffic["kind"]
        assert (harness.HERE / "drivers" / f"{kind}.py").is_file(), kind
        assert callable(harness.driver(kind).run), kind
        assert harness.driver(kind).CARDS == cell.chips, (kind, cell.chips)
        assert cell.arch.__file__ == str(
            harness.HERE / "architectures"
            / f"{cell.config['architecture']}.py")
        assert set(cell.settings) == {"runtime", "limits"}
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                        "peak_mem_gib"}
        assert cell.per_layer
    for m in spec["per_layer"]:
        path = harness.HERE / "metrics" / f"{m['name']}.py"
        text = path.read_text()
        assert f'UNIT = "{m["unit"]}"' in text
        assert f'MOVES = "{m["moves"]}"' in text
        assert f'LAYER = "{m["layer"]}"' in text
        assert harness.metric_reader(m["name"])({}) is None


def test_a_cell_and_a_metric_added_as_files_run(tiny_root):
    before = digests(tiny_root)
    add_cell(tiny_root)
    after = digests(tiny_root)
    assert all(after[p] == d for p, d in before.items())

    cell = harness.find_cell("bird-train-b2", tiny_root)
    assert [m["name"] for m in cell.per_layer] == [
        "steps_per_s.train", "affine_fwd_bytes.train"]
    assert cell.traffic["batch_per_card"] == 2
    args = argparse.Namespace(workload="bird-train-b2", seed=2 ** 40 + 3,
                              seconds=0.01, trace=0)
    torch.manual_seed(0)
    cell, out = run.run_cell(args, torch.device("cpu"), time.perf_counter(),
                             tiny_root)
    assert out.attempted == 4 and out.failed == 0
    assert out.end_to_end["train_images_per_s"] > 0
    read = harness.metric_reader("steps_per_s.train", tiny_root)
    assert read(out.observations) == pytest.approx(
        out.end_to_end["train_images_per_s"] / 2)
    # GF_DIM=4, B=2, float32: the 14 launches written out.
    shapes = harness.metric_reader("affine_fwd_bytes.train", tiny_root)
    assert shapes(out.observations) == pytest.approx(
        1e-6 * sum(4 * (2 * C * h * w + 4 * C + 2 * (4 if up else 1) * h * w
                        * (1 + C)) + 8 * C
                   for C, h, w, up in [(32, 4, 4, False)] * 2
                   + [(32, 4, 4, True), (32, 8, 8, False),
                      (32, 8, 8, True), (32, 16, 16, False),
                      (32, 16, 16, True), (32, 32, 32, False),
                      (32, 32, 32, True), (16, 64, 64, False),
                      (16, 64, 64, True), (8, 128, 128, False),
                      (8, 128, 128, True), (4, 256, 256, False)]))
    assert harness.correct(out.checks), out.checks


@pytest.mark.parametrize("named", [None, "attngan"])
def test_a_configuration_without_its_architecture_fails_at_find_cell(
        tiny_root, named):
    """A configuration that names no architecture, or one with no file,
    fails where the cell is found, naming the file at fault."""
    path = tiny_root / "benchmark" / "configs" / "eegan-bird.json"
    config = json.loads(path.read_text())
    if named is None:
        del config["architecture"]
        missing = path
    else:
        config["architecture"] = named
        missing = tiny_root / "benchmark" / "architectures" / f"{named}.py"
    path.write_text(json.dumps(config))
    with pytest.raises((KeyError, FileNotFoundError)) as err:
        harness.find_cell("bird-train-b32", tiny_root)
    assert str(missing) in str(err.value)
