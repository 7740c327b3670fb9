"""The port's benchmark entry point (``python -m eegan_tpu_torch.bench``)
and its operation count, on the CPU.

* (a) the CLI with ``--device cpu`` at tiny widths prints one JSON line
  whose keys are the root ``bench.py``'s (read from its source with
  ``ast``) plus ``gpu``, ``power_limit_w``, ``n_cards`` and
  ``peak_memory_mib``; (b) the same on two gloo ranks (``--mesh data:2``)
  prints exactly one line, ``n_cards`` 2; (c) without ``--device cpu`` it
  exits non-zero with ``resolve_device``'s message; (d) the value read
  refuses a NaN.
* (e) the port's count of one float32 train step (GF_DIM = DF_DIM = 4,
  B = 4, USE_CLASS with 200 classes, PALLAS_DAMSM and PALLAS_AFFINE off)
  against the JAX step's, compiled on the CPU (``compare_op_counts.py``
  counts both, part by part). The band, from that comparison at these
  widths: every part's products are the same on both sides but two, where
  the port computes less: the text encoder (the packed LSTM runs the valid
  time steps, JAX's masked scan all of them) and the mask pyramid's
  align-corners resize (two matmuls in JAX, an interpolation in the port),
  so the port's count over the JAX program's products
  (``hlo_products``) lies in [0.996, 1.0]. XLA's own ``cost_analysis``
  counts no tap that falls on padding and adds the elementwise operations:
  at these widths the products are 1.0258 times its count, so the port's
  count over ``cost_analysis()['flops']`` lies in [1.0217, 1.0258]. The
  test holds both ratios to their band plus 2%. The DAMSM kernels' count
  (``ops/damsm.py:words_similarity_ops``, the plain version's form)
  against the dispatch count of the plain version, ragged ``cap_lens``:
  within 1e-6.
* The MAGP repairs: the D's MAGP computes no weight gradient in its first
  backward and its double backward reaches no forward activation; the
  class head's logits are not computed. Its ``convolution_backward``
  products are then those of the penalty's own backward, the size of the
  first backward's convs, against twice that before the repairs
  (``compare_op_counts.magp_repairs_undone``).
"""

import ast
import json
import math
import os
import re
import subprocess
import sys

import jax  # noqa: F401  (JAX on the CPU, before the port's imports)
import pytest
import torch
from torch.nn.utils.rnn import pack_padded_sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import compare_op_counts  # noqa: E402
from eegan_tpu_torch import bench  # noqa: E402
from eegan_tpu_torch.losses.damsm import word_region_log_sims  # noqa: E402
from eegan_tpu_torch.models.factory import build_models  # noqa: E402
from eegan_tpu_torch.ops.damsm import words_similarity_ops  # noqa: E402
from eegan_tpu_torch.training import steps  # noqa: E402
from eegan_tpu_torch.utils.opcount import (  # noqa: E402
    OpCounter,
    cudnn_rnn_ops,
)

torch.set_num_threads(1)

WIDTH, B = 4, 4
NEW_KEYS = {"gpu", "power_limit_w", "n_cards", "peak_memory_mib"}
TINY = {"EEGAN_BENCH_GF": "4", "EEGAN_BENCH_DF": "4",
        "EEGAN_BENCH_BATCH": "2", "EEGAN_BENCH_SCAN": "2",
        "EEGAN_BENCH_WINDOWS": "1", "EEGAN_BENCH_ITERS": "1",
        "EEGAN_BENCH_CALIBRATE": "0", "EEGAN_BENCH_BEST": "0"}
PRODUCTS_BAND = (0.996, 1.0)
FLOPS_BAND = (1.0217, 1.0258)
SLACK = 0.02


def root_bench_keys():
    """The keys of the root bench.py's JSON line, from its source: the
    ``out`` dict of ``main`` (with ``**flagship``, the keys of
    ``measure_recipe``'s returned dict that do not start with ``_``) and
    the keys ``main`` assigns to ``out`` afterwards."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    recipe = {k.value for n in ast.walk(funcs["measure_recipe"])
              if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)
              for k in n.value.keys if isinstance(k, ast.Constant)}
    keys = set()
    for n in ast.walk(funcs["main"]):
        if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and any(getattr(t, "id", None) == "out" for t in n.targets)):
            for k in n.value.keys:
                keys |= ({k.value} if isinstance(k, ast.Constant)
                         else {r for r in recipe if not r.startswith("_")})
        if (isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store)
                and getattr(n.value, "id", None) == "out"):
            keys.add(n.slice.value)
    return keys


def run_bench(*args, timeout=240):
    # One thread a process: the suite's workers share the host's cores,
    # and bf16 on the CPU crawls when threads outnumber them.
    env = {**os.environ, **TINY, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", "eegan_tpu_torch.bench",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def check_line(line, n_cards):
    out = json.loads(line)
    assert set(out) == root_bench_keys() | NEW_KEYS
    assert out["n_cards"] == n_cards
    assert math.isfinite(out["value"]) and out["value"] > 0
    assert out["step_tflops"] > 0 and out["mfu"] is None
    assert out["metric"] == "train_images_per_sec_per_chip_256px_cub"
    assert (out["batch_per_chip"], out["steps_per_dispatch"]) == (2, 2)
    return out


def test_root_bench_keys_read():
    keys = root_bench_keys()
    assert {"metric", "value", "mfu", "step_tflops", "ms_per_step",
            "best_recipe", "use_class", "mfu_vs_calibrated"} <= keys
    assert not any(k.startswith("_") for k in keys)
    # chip_smoke.py's phase 22 checks the line against the port's copy.
    assert set(bench.BENCH_PY_KEYS) == keys
    assert set(bench.ADDED_KEYS) == NEW_KEYS


def test_bench_cli_cpu():
    proc = run_bench("--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    check_line(lines[-1], 1)
    assert "window 0:" in proc.stderr and "mfu is null" in proc.stderr
    # The timed windows' launches per step, checked against the counted
    # call's (none on the CPU: the wrappers take the plain version).
    assert bench.LAUNCHES + json.dumps(dict.fromkeys(
        ("affine_mask_relu", "affine_mask_relu_backward",
         "words_similarity_forward", "words_similarity_backward_dr",
         "words_similarity_backward_dw"), 0)) in proc.stderr


def test_bench_cli_two_gloo_ranks():
    proc = run_bench("--device", "cpu", "--mesh", "data:2")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    check_line(lines[0], 2)


def test_bench_cli_needs_a_gpu():
    proc = run_bench(timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not proc.stdout.strip()


def test_read_value_refuses_nan():
    assert bench.read_value({"errG/total": torch.tensor([1.0, 2.5])}) == 2.5
    assert bench.read_value({"errG/total": torch.tensor(3.0)}) == 3.0
    for bad in (float("nan"), float("inf")):
        with pytest.raises(FloatingPointError, match="non-finite"):
            bench.read_value({"errG/total": torch.tensor([1.0, bad])})


def test_bench_knobs_are_bench_py_names():
    with open(os.path.join(ROOT, "bench.py")) as f:
        src = f.read()
    names = set(re.findall(r'"EEGAN_BENCH_(\w+)"', src))
    with open(bench.__file__) as f:
        port = f.read()
    assert names == set(re.findall(r'(?:get|on)\("(\w+)"', port))
    k = bench.knobs({})
    assert (k["batch"], k["gf"], k["df"], k["scan"], k["best_batch"],
            k["best_scan"]) == (32, 32, 32, 8, 128, 4)
    assert k["pallas"] and k["upfuse"] and k["dense"] and not k["paffine"]


@pytest.fixture(scope="module")
def step_counts():
    cfg, jcfg = compare_op_counts.configs(WIDTH, B)
    jax_side = compare_op_counts.jax_step_counts(jcfg, B)
    torch.manual_seed(0)
    port = compare_op_counts.port_step_count(cfg, B)
    return jax_side, port


def test_step_count_against_jax(step_counts):
    jax_side, port = step_counts
    products = port["port"] / jax_side["jax_products"]
    flops = port["port"] / jax_side["jax_flops"]
    assert PRODUCTS_BAND[0] - SLACK <= products <= PRODUCTS_BAND[1] + SLACK
    assert FLOPS_BAND[0] - SLACK <= flops <= FLOPS_BAND[1] + SLACK
    assert set(port["port_by_op"]) <= {
        "aten.convolution", "aten.convolution_backward", "aten.mm",
        "aten.addmm", "aten.bmm"}


def test_cudnn_lstm_count_matches_cpu_dispatch():
    """The formula for cuDNN's LSTM (``aten._cudnn_rnn`` on a card) counts
    what the CPU's LSTM dispatches as ``addmm``: the text encoder's
    bidirectional LSTM over packed, ragged captions."""
    torch.manual_seed(0)
    lstm = torch.nn.LSTM(300, 128, 1, batch_first=True, bidirectional=True)
    x = torch.randn(6, 18, 300)
    packed = pack_padded_sequence(x, torch.tensor([18, 3, 7, 1, 12, 5]),
                                  batch_first=True, enforce_sorted=False)
    with torch.no_grad(), OpCounter() as c:
        lstm(packed)
    # _cudnn_rnn(input, weights, weight_stride0, weight_buf, hx, cx, mode
    # (2: LSTM), hidden, proj, layers, batch_first, dropout, train,
    # bidirectional, batch_sizes, dropout_state)
    args = (packed.data, list(lstm._flat_weights), 4, None, None, None, 2,
            128, 0, 1, True, 0.0, False, True,
            packed.batch_sizes.tolist(), None)
    assert cudnn_rnn_ops(args) == c.total == 2 * 46 * 4 * 128 * 428 * 2


@pytest.mark.parametrize("kind", ["forward", "dr", "dw"])
def test_damsm_count_matches_plain_dispatch(kind):
    Bi, Bt, S, L, D = 3, 5, 17, 7, 12
    gen = torch.Generator().manual_seed(0)
    regions = torch.randn((Bi, S, D), generator=gen)
    words = torch.randn((Bt, L, D), generator=gen)
    cap_lens = torch.tensor([1, 7, 3, 5, 2])  # ragged: padded words count
    r = regions.requires_grad_(kind == "dr")
    w = words.requires_grad_(kind == "dw")
    with OpCounter() as c:
        sims = word_region_log_sims(r, w, cap_lens)
    if kind != "forward":
        dsim = torch.randn((Bi, Bt), generator=gen)
        with OpCounter() as c:
            torch.autograd.grad(sims, r if kind == "dr" else w, dsim)
    want = words_similarity_ops(kind, Bi, Bt, S, L, D)
    assert abs(c.total - want) <= 1e-6 * want
    # The kernels' own work counts the valid words only.
    valid = words_similarity_ops(kind, Bi, Bt, S, L, D, cap_lens)
    assert valid == {"forward": 4, "dr": 10, "dw": 8}[kind] * Bi * 18 * S * D


def magp_counts(d, img, sent, is_class):
    with OpCounter() as fwd:
        d.head(d.features(img), sent)
    with OpCounter() as gp:
        steps._gradient_penalty(d, img, sent, is_class).backward()
    d.zero_grad(set_to_none=True)
    return fwd.by_op["aten.convolution"], gp.by_op


@pytest.mark.parametrize("scale", [0, 2])
def test_magp_computes_no_weight_gradient_twice(scale):
    cfg, _ = compare_op_counts.configs(WIDTH, B)
    torch.manual_seed(0)
    models = build_models(cfg, 40, device="cpu")
    d = models.discriminators[scale]
    size = models.scales[scale]
    gen = torch.Generator().manual_seed(1)
    img = torch.rand((2, size, size, 3), generator=gen) * 2 - 1
    sent = torch.randn((2, cfg.TEXT.EMBEDDING_DIM), generator=gen)
    is_class = scale == 2
    fwd, after = magp_counts(d, img, sent, is_class)
    with compare_op_counts.magp_repairs_undone():
        _, before = magp_counts(d, img, sent, is_class)
    # After: the forward and the first backward's input gradients (the
    # class head's logits, off the penalty's path, not computed), then the
    # penalty's backward through those transposed convs, once each.
    assert 1.99 * fwd <= after["aten.convolution"] <= 2 * fwd
    assert 0.999 * after["aten.convolution"] \
        <= after["aten.convolution_backward"] <= after["aten.convolution"]
    # Before: the first backward's weight gradients doubled the
    # convolution_backward products, and the zeros sent into the forward
    # took one more input gradient of each conv.
    assert before["aten.convolution_backward"] \
        >= 1.99 * after["aten.convolution_backward"]
    assert before["aten.convolution"] >= after["aten.convolution"] + 0.99 * fwd
