"""Moving EE-GAN's networks, weights and check from the drivers into
``architectures/eegan.py`` changed no reading: at the tiny size on the
CPU, one thread, one fixed seed a cell, the check's numbers and the
operation counts are those the drivers gave before the move (recorded
on git 7709d5b, the last commit with EE-GAN inside the drivers). The
counts match exactly, the gaps to 1e-6 relative."""

import pytest
import torch

from benchmark import harness, inputs
from benchmark.drivers import generate, train

BEFORE = {
    "bird-train-b32": dict(
        seed=68719476743, ops=117528197792,
        numbers={"loss_gap_first_mean": 2.548561412793577e-07,
                 "change_gap_median": 5.00245148059795e-07,
                 "grad_gap_g_pd_median": 2.184272955136082e-07,
                 "grad_gap_magp_pd_median": 1.245654178261601e-07}),
    "coco-train-b24": dict(
        seed=137438953491, ops=117505505952,
        numbers={"loss_gap_first_mean": 1.4768244410005262e-07,
                 "change_gap_median": 3.185191560287108e-07,
                 "grad_gap_g_pd_median": 1.5408044464648809e-07,
                 "grad_gap_magp_pd_median": 9.035656870568914e-08}),
    "bird-generate-b128": dict(
        seed=274877906967, ops=3390655488,
        numbers={"image_gap": 8.646647135416667e-05}),
}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def train_ops(cell, seed):
    """The reference step's count at the rows and caption lengths of the
    seed's first pool batch."""
    rows = cell.traffic["batch_per_card"]
    pool = cell.arch.train_pool(cell, cell.traffic["pool_batches"], rows,
                                harness.seeds(seed, 3)[1], torch.device("cpu"))
    return cell.arch.step_ops(cell, rows, inputs.step_batch(
        pool, 0, torch.device("meta")))


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_readings_are_those_before_the_move(tiny_root, one_thread, name):
    before = BEFORE[name]
    cell = harness.find_cell(name, tiny_root)
    cpu = torch.device("cpu")
    torch.manual_seed(0)
    if cell.traffic["kind"] == "train":
        numbers = train.numbers_of(cell, before["seed"], cpu)
        ops = train_ops(cell, before["seed"])
    else:
        numbers = generate.numbers_of(cell, before["seed"], cpu)
        ops = cell.arch.sample_ops(cell, cell.traffic["batch"])
    assert ops == before["ops"]
    assert numbers == pytest.approx(before["numbers"], rel=1e-6, abs=0)
