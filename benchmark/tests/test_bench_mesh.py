"""The four-card cell at a tiny size on the CPU, its ranks gloo
processes: the reference's global step computed by four processes is
the one-process step over the four processes' rows (float64, losses of
every step and every first gradient); the ``train_mesh``
driver reads ``correct`` on a sound program and not on a program with a
fault of the mesh planted in every rank (batch norms by each rank's
rows, gradients not averaged, the DAMSM grid over each rank's rows);
the generator's batch moments tell the global batch norms from each
rank's;
``run.py`` refuses a cell that asks for more cards than are visible or
than its kind runs; the collectives' readers on a made-up trace.

Run as ``python -m benchmark.tests.test_bench_mesh`` it is a rank of
these tests (the driver's ranks with a fault planted, or the
reference's)."""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import check, harness, run, spans
from benchmark.drivers import train, train_mesh
from benchmark.tests.test_bench_spans import read, write_run

CELL = "bird-train-b32-data4"
RANKS = 4
TIMEOUT_S = 600


# --- faults of the mesh, planted in the program --------------------------


def _local_bn(setattr):
    """The generator's batch norms by each rank's rows."""
    from eegan_tpu_torch.models.layers import TorchBatchNorm

    real = TorchBatchNorm.batch_stats

    def local(self, x, n_override=None):
        mesh, self.mesh = self.mesh, None
        try:
            return real(self, x, n_override)
        finally:
            self.mesh = mesh

    setattr(TorchBatchNorm, "batch_stats", local)


def _local_grads(setattr):
    """Each rank updates with its own gradients."""
    from eegan_tpu_torch.parallel.mesh import Mesh

    setattr(Mesh, "average_gradients_", lambda self, params: None)


def _local_damsm(setattr):
    """The DAMSM losses over each rank's rows only."""
    import eegan_tpu_torch.losses.damsm as damsm
    import eegan_tpu_torch.training.steps as steps

    def local(fn):
        return lambda *a, mesh=None, **kw: fn(*a, mesh=None, **kw)

    setattr(damsm, "sent_loss", local(damsm.sent_loss))
    setattr(damsm, "words_loss", local(damsm.words_loss))
    setattr(steps, "words_loss_fused", local(steps.words_loss_fused))


FAULTS = {"local_bn": _local_bn, "local_grads": _local_grads,
          "local_damsm": _local_damsm}


# --- the ranks these tests start -----------------------------------------


def _reference_rank(task):
    """Rank ``task["rank"]`` of the reference's global step; rank 0
    writes its readings to ``task["out"]``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{task['port']}", world_size=task["ranks"],
                            rank=task["rank"])
    try:
        cell = harness.find_cell(CELL, Path(task["root"]))
        cpu = torch.device("cpu")
        seed_w, batches, noises = train.checked_inputs(
            cell, task["seed"], cpu, task["rank"], task["ranks"])
        losses, grads, _, _ = cell.arch.reference_readings(
            cell, seed_w, batches, noises, cpu, mesh=True)
        if task["rank"] == 0:
            with open(task["out"], "w") as f:
                json.dump({"losses": losses, "grads": grads}, f)
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    if argv[0] == "--fault":
        FAULTS[argv[1]](setattr)
        return train_mesh.rank_main(argv[2:])
    _reference_rank(json.loads(argv[0]))
    return 0


# --- the tests -------------------------------------------------------------


@pytest.fixture
def float64():
    """Both sides in float64, where a different order of the same sums
    moves nothing the comparison sees."""
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(torch.float32)


def test_the_reference_over_four_ranks_is_the_one_process_step(
        tiny_root, tmp_path, float64):
    seed, out = 2 ** 36 + 7, tmp_path / "ranks.json"
    task = dict(root=str(tiny_root), seed=seed, ranks=RANKS, out=str(out),
                port=train_mesh._free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "benchmark.tests.test_bench_mesh",
         json.dumps(dict(task, rank=r))], cwd=str(harness.ROOT))
        for r in range(RANKS)]
    try:
        assert all(p.wait(TIMEOUT_S) == 0 for p in procs)
    finally:
        for p in procs:
            p.kill()
    ranks = json.loads(out.read_text())

    cell = harness.find_cell(CELL, tiny_root)
    cell.traffic["batch_per_card"] *= RANKS  # the global batch, one process
    cpu = torch.device("cpu")
    torch.manual_seed(0)
    seed_w, batches, noises = train.checked_inputs(cell, seed, cpu)
    assert len(noises[0]) == 8
    losses, grads, _, _ = cell.arch.reference_readings(
        cell, seed_w, batches, noises, cpu)
    assert len(ranks["losses"]) == len(losses) == 3
    assert all(r.keys() == o.keys() for r, o in zip(ranks["losses"], losses))
    gaps = check.loss_gaps(ranks["losses"], losses)
    assert max(gaps.values()) < 1e-5, gaps
    gaps = check.leaf_gaps(ranks["grads"], grads)
    assert max(gaps.values()) < 1e-5, sorted(
        gaps.items(), key=lambda kv: -kv[1])[:5]


def run_mesh(root, seed=2 ** 37 + 3):
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=0.01,
                              trace=0)
    torch.manual_seed(0)
    return run.run_cell(args, torch.device("cpu"), time.perf_counter(),
                        root)[1]


def test_a_sound_program_on_four_ranks_is_correct(tiny_root):
    out = run_mesh(tiny_root)
    assert harness.correct(out.checks), out.checks
    assert out.attempted == 4 and out.failed == 0
    assert out.modules == []
    assert out.end_to_end["train_images_per_s"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_of_the_mesh_is_not_correct(tiny_root, monkeypatch, fault):
    FAULTS[fault](monkeypatch.setattr)
    monkeypatch.setattr(train_mesh, "LAUNCH", [
        sys.executable, "-m", "benchmark.tests.test_bench_mesh", "--fault",
        fault])
    out = run_mesh(tiny_root)
    assert not harness.correct(out.checks), out.checks


def test_the_batch_moments_tell_global_from_local_batch_norms(tiny_root):
    """``bn_gap_first_max`` as ``calibrate.py`` reads it on four ranks: a
    sound program's batch moments, taken from its running statistics,
    are the reference's over the global batch (float32 on both sides);
    the reference with each rank's norms over its own rows, put in the
    program's place, is far from them."""
    cell = harness.find_cell(CELL, tiny_root)
    seed = 2 ** 37 + 11
    torch.manual_seed(0)
    found = {kind: read[0]["bn_gap_first_max"] for kind, _, read in
             train_mesh.readings(cell, [("program", seed), ("local_bn", seed)],
                                 torch.device("cpu"), lambda msg: None)}
    assert found["program"] < 1e-4, found
    assert found["local_bn"] > 0.1, found


@pytest.mark.parametrize("visible, kind", [(2, "train_mesh"), (4, "train")])
def test_no_result_without_the_cards_the_cell_and_its_kind_run(
        tiny_root, monkeypatch, capsys, visible, kind):
    path = tiny_root / "benchmark" / "traffic" / "train_mesh_b32x4_k8.json"
    traffic = json.loads(path.read_text())
    traffic["kind"] = kind
    path.write_text(json.dumps(traffic))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    rc = run.main(["--workload", CELL, "--seed", "1", "--seconds", "1",
                   "--trace", "0"], root=tiny_root)
    assert rc == 2
    assert capsys.readouterr().out == ""


# --- the collectives' readers ------------------------------------------------


def mesh_trace(acts):
    """A Chrome trace of one window (0-1000 us) and one step span, with
    device activities (name, start us, end us, stream)."""
    events = [{"ph": "X", "cat": "user_annotation",
               "name": "benchmark.traced_window", "pid": 1, "tid": 1,
               "ts": 0, "dur": 1000},
              {"ph": "X", "cat": "user_annotation", "name": "eegan.train.step",
               "pid": 1, "tid": 1, "ts": 5, "dur": 990}]
    for k, (name, s, e, stream) in enumerate(acts):
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
                       "ts": s - 3, "dur": 2, "args": {"correlation": k}})
        events.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                       "tid": stream, "ts": s, "dur": e - s,
                       "args": {"correlation": k}})
    return {"traceEvents": events}


NCCL_ACTS = [
    ("void at::native::conv_kernel(float*)", 10, 100, 7),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     80, 200, 20),  # 80-100 under the conv: 100 us exposed
    ("ncclKernel_AllGather_RING_LL_Sum_int8_t(ncclWork*)", 300, 340, 20),
    ("void at::native::elementwise_kernel(float*)", 310, 320, 7),
    ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage)",
     330, 360, 21),  # overlaps the gather: 300-360 NCCL, 10 hidden
]


@pytest.mark.parametrize("steps", [1, 4])
def test_nccl_readers(tmp_path, monkeypatch, steps):
    cell = write_run(tmp_path, monkeypatch, CELL, mesh_trace(NCCL_ACTS))
    obs = {"kind": "train", "cell": cell, "trace": object(),
           "traced_steps": steps}
    s = spans.of_run(obs, "train")
    assert spans.nccl(s).tolist() == [False, True, True, False, True]
    assert read("nccl_ms_per_step.train", obs) == pytest.approx(
        1e-3 * (120 + 60) / steps)
    assert read("nccl_exposed_ms_per_step.train", obs) == pytest.approx(
        1e-3 * (100 + 50) / steps)


def test_no_nccl_reading_without_nccl(tmp_path, monkeypatch):
    cell = write_run(tmp_path, monkeypatch, CELL,
                     mesh_trace(NCCL_ACTS[:1] + NCCL_ACTS[3:4]))
    obs = {"kind": "train", "cell": cell, "trace": object(),
           "traced_steps": 1}
    assert read("nccl_ms_per_step.train", obs) is None
    assert read("nccl_exposed_ms_per_step.train", obs) is None


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
