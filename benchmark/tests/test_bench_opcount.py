"""The benchmark counts a step's operations from its own reference at the
cell's shapes; the count agrees with the port's own count of the same
step (``eegan_tpu_torch/utils/opcount.py`` over the program's step, on
the CPU, where the DAMSM kernels' plain versions run)."""

import numpy as np
import pytest
import torch

from benchmark import harness, inputs


def port_step_ops(cell, batch_rows, pool):
    from eegan_tpu_torch.models.factory import build_models
    from eegan_tpu_torch.training.state import create_train_state
    from eegan_tpu_torch.training.steps import make_train_step
    from eegan_tpu_torch.utils.opcount import OpCounter

    config = harness.port_config(cell, batch_rows)
    torch.manual_seed(0)
    models = build_models(config, cell.config["n_words"], device="cpu")
    state, frozen = create_train_state(config, models)
    step = make_train_step(config, models)
    batch = {k: v[0] for k, v in pool.items()}
    noise = torch.randn(batch_rows, cell.model["GAN"]["Z_DIM"])
    with OpCounter() as counter:
        step(state, frozen, batch, noise)
    return counter.total


@pytest.mark.parametrize("cell_name", ["bird-train-b32", "coco-train-b24"])
def test_reference_count_matches_the_ports_count(tiny_root, cell_name):
    cell = harness.find_cell(cell_name, tiny_root)
    rows = cell.traffic["batch_per_card"]
    pool = inputs.train_pool(cell.model, cell.config["n_words"], 1, rows, 7,
                             torch.device("cpu"))
    ours = cell.arch.step_ops(cell, rows, inputs.step_batch(
        pool, 0, torch.device("meta")))
    theirs = port_step_ops(cell, rows, pool)
    assert ours / theirs == pytest.approx(1.0, abs=0.005), (ours, theirs)


def test_published_shapes_count():
    """At the published widths, on the meta device: the bird step as the
    port's count read it on the card (8.923 TFLOP, within 1%); COCO's four
    times the conv work per image at 24 of 32 rows; one sampling
    request."""
    bird = harness.find_cell("bird-train-b32")
    coco = harness.find_cell("coco-train-b24")
    meta = torch.device("meta")
    counts = {}
    for cell in (bird, coco):
        rows = cell.traffic["batch_per_card"]
        pool = inputs.train_pool(cell.model, cell.config["n_words"], 1, rows,
                                 3, torch.device("cpu"))
        counts[cell.name] = cell.arch.step_ops(
            cell, rows, inputs.step_batch(pool, 0, meta))
    assert counts["bird-train-b32"] / 8.923e12 == pytest.approx(1, abs=0.01)
    assert 2.5 < counts["coco-train-b24"] / counts["bird-train-b32"] < 3.0
    gen = harness.find_cell("bird-generate-b128")
    assert 3.0e12 < gen.arch.sample_ops(gen, 128) < 3.6e12
    assert np.isfinite(list(counts.values())).all()
