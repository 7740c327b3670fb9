"""The ``train`` CLI with an fsdp axis:
``python -m eegan_tpu_torch.train --mesh data:1,fsdp:2 --device cpu`` for
two epochs of one iteration against ``--mesh data:2`` (both as two gloo
ranks, run together): the metrics and the epoch-1 checkpoint, which keeps
the unsharded layout (the same keys and shapes, optimizer state included),
at ``test_torch_parallel.py``'s CLI bars; then one process resumes the
sharded run's checkpoint and takes the same epoch-2 iteration as the two
ranks took (metrics rtol 1e-4). ``test_torch_fsdp.py`` holds the sharded
step itself.
"""

import subprocess
import sys

import numpy as np
import torch

from eegan_tpu_torch.parallel.fsdp import fsdp_spec
from test_torch_parallel import (
    _cli_flags,
    _compare_checkpoints,
    _env,
    _metrics,
    _wait,
)

torch.set_num_threads(1)


def _flags(tmp_path, run):
    # GF_DIM=16 puts nine generator leaves (fc, the first blocks' convs)
    # and the class head of the last discriminator over the rule's floor.
    return [*_cli_flags(tmp_path, run), "--set", "GAN.GF_DIM=16"]


def test_train_cli_fsdp_matches_data_parallel_and_resumes(tmp_path):
    from eegan_tpu_torch.train import main

    procs = [subprocess.Popen(
        [sys.executable, "-m", "eegan_tpu_torch.train",
         *_flags(tmp_path, run), "--mesh", spec],
        cwd=str(tmp_path), env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for run, spec in (("fsdp", "data:1,fsdp:2"), ("data", "data:2"))]
    outs = _wait(procs)
    assert "rank 1 of 2" in outs[0]

    runs = {name: tmp_path / name for name in ("fsdp", "data")}
    for d in runs.values():
        assert (d / "Model" / "netG_1.pth").is_file()
        assert (d / "Image" / "epoch_2_256.png").is_file()
    got, want = (_metrics(d / "writer" / "metrics.jsonl")
                 for d in (runs["fsdp"], runs["data"]))
    assert len(got) == len(want) >= 1
    for g_row, w_row in zip(got, want):
        assert set(g_row) == set(w_row)
        for k, v in w_row.items():
            np.testing.assert_allclose(g_row[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    ckpt = {name: torch.load(d / "Model" / "state" / "1.pt",
                             weights_only=False)
            for name, d in runs.items()}
    for key in ("generator", "attr_enhance"):
        assert {k: v.shape for k, v in ckpt["fsdp"][key].items()} == \
            {k: v.shape for k, v in ckpt["data"][key].items()}
    for a, b in zip(ckpt["fsdp"]["discriminators"],
                    ckpt["data"]["discriminators"]):
        assert {k: v.shape for k, v in a.items()} == \
            {k: v.shape for k, v in b.items()}
    for a, b in zip((ckpt["fsdp"]["g_opt"], *ckpt["fsdp"]["d_opts"]),
                    (ckpt["data"]["g_opt"], *ckpt["data"]["d_opts"])):
        assert a["param_groups"] == b["param_groups"]
        assert {i: {k: tuple(v.shape) for k, v in s.items()}
                for i, s in a["state"].items()} == \
            {i: {k: tuple(v.shape) for k, v in s.items()}
             for i, s in b["state"].items()}
    assert ckpt["fsdp"]["step"] == ckpt["data"]["step"] == 1
    for key in ("generator", "discriminators"):
        sds = ckpt["fsdp"][key]
        sds = sds if isinstance(sds, list) else [sds]
        assert any(fsdp_spec(tuple(v.shape), 2) is not None
                   for sd in sds for k, v in sd.items()
                   if "running_" not in k), key
    _compare_checkpoints(ckpt["fsdp"], ckpt["data"])
    for name in ("netG_1.pth", "attr_enhance_1.pth"):
        a, b = (torch.load(d / "Model" / name, weights_only=True)
                for d in runs.values())
        assert set(a) == set(b)

    # One process resumes the sharded run's epoch-1 state (the latest):
    # the same epoch-2 iteration as the two ranks took.
    assert not (runs["fsdp"] / "Model" / "state" / "2.pt").exists()
    flags = _flags(tmp_path, "fsdp")
    flags[flags.index("--max_epochs") + 1] = "1"
    main([*flags, "--mesh", "data:1"])
    resumed = _metrics(runs["fsdp"] / "writer" / "metrics.jsonl")
    assert len(resumed) == len(got) + 1
    for k, v in got[-1].items():
        np.testing.assert_allclose(resumed[-1][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
