"""Training-throughput benchmark of the port (counterpart of the root
``bench.py``).

    python -m eegan_tpu_torch.bench [--device cuda] [--mesh data:N]

Prints ONE JSON line on standard output, bench.py's keys and four more
(``gpu``, ``power_limit_w``, ``n_cards``, ``peak_memory_mib``); the
windows' images/s, the step's operations by kind and the notes go to
standard error.

Protocol, as bench.py's: the bird recipe (GF_DIM = DF_DIM = 32, B = 32 per
card, three scales, USE_CLASS with 200 classes, the CUB vocabulary of 5450
words, bf16 compute, the DAMSM words loss through kernels 3 and 4, K = 8
steps per call through ``training/steps.py::make_multi_train_step``) on
every visible card: one rank per card (``--mesh data:N``, default all of
them; ``parallel/distributed.spawn``, NCCL), each with B rows of a global
batch of N·B and the mesh's global batch norm and DAMSM losses; one
process with no mesh when N = 1. Random weights from a fixed seed, the
batch from ``data/synthetic.py::synthetic_batch`` stacked K times on the
device, the noise from a ``torch.Generator`` on the device, the same batch
and noise in every call (bench.py passes one key). One drained warm-up
call, then ``EEGAN_BENCH_WINDOWS`` windows of ``EEGAN_BENCH_ITERS`` calls,
each started after a synchronise and ended by reading the last step's
``errG/total`` as a Python float (:func:`read_value`), which waits for the
device and refuses a non-finite value. ``value`` is images/s per card over
all windows, ``best_window`` the fastest window's.

Operations: one more call of the timed K-step function, after the
warm-up, runs under ``utils/opcount.OpCounter`` (``torch.utils.
flop_counter``'s registry over the aten ops, cuDNN's LSTM by formula), and
the DAMSM kernels' launches in it count by
``ops/damsm.py:words_similarity_ops`` as the plain version computes the
function, so that a configuration counts the same on the CPU and on a
card; the call's count over K is the step's. The kernels' launches per
step over the timed windows must equal those of the counted call (it
raises otherwise), and standard error gives them on the line that starts
with :data:`LAUNCHES`; the line that starts with :data:`D_GRAPH` counts the
timed steps whose D phase replayed its CUDA graphs
(``training/d_graph.py``; the counted call runs it eagerly).
``step_tflops`` is one card's step (its rows of the batch).
``mfu`` is that count times the steps per second over the H100 SXM's dense
bf16 peak (989 TFLOP/s, NVIDIA's data sheet, at 700 W; null on another
card or the CPU, and standard error says why); ``mfu_vs_calibrated`` the
same over ``calibrated_matmul_tflops``, a data-dependent chain of 16 bf16
8192³ matmuls renormalised between links, ended by a value read.
``vs_baseline`` and ``a100_ref_est_imgs_per_sec`` keep bench.py's
definitions (the A100's 312 TFLOP/s bf16 at a 10% MFU, over the port's
operations per image).

The best-recipe point (``EEGAN_BENCH_BEST_BATCH`` x ``EEGAN_BENCH_BEST_SCAN``,
default 128 x 4) is measured in the same run and reported under
``best_recipe``; null when ``EEGAN_BENCH_BEST=0`` or when it is the
flagship's own point.

Knobs, bench.py's names and defaults, each set on the port's RUNTIME key
of the same meaning: EEGAN_BENCH_BATCH (32), GF (32), DF (= GF), CLASS (1),
PALLAS (1: RUNTIME.PALLAS_DAMSM), REMAT (0), REMAT_BLOCKS (""), REMAT_D
(1), PAFFINE (0: RUNTIME.PALLAS_AFFINE, kernels 1-2), BF16IMG (0), REMAT_IE
(0), DENSE (1), MAGP_CHUNKS (1), UINT8 (0: the image leaves ship as uint8),
S2D (0: RUNTIME.S2D_CONVS, which the port ignores), UPFUSE (1), SCAN (8),
WINDOWS (3), ITERS (4), CALIBRATE (1), BEST (1), BEST_BATCH (128),
BEST_SCAN (4). Runs on ``--device cuda`` (the default; it raises without a
GPU) and on the CPU only with ``--device cpu``, where ``--mesh data:N``
starts N gloo ranks. A mesh of more ranks than cards raises, as ``train
--mesh`` does.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

H100_SXM_BF16_PEAK = 989e12  # dense, NVIDIA's data sheet, at 700 W
A100_PEAK_FLOPS = 312e12  # bf16
A100_REFERENCE_MFU = 0.10  # bench.py's documented assumption
N_WORDS = 5450  # the CUB caption vocabulary
REGIONS = 17 * 17  # the image encoder's region grid
MATMUL_N = 8192
MATMUL_CHAIN = 16
METRIC = "train_images_per_sec_per_chip_256px_cub"
# The keys of the root bench.py's JSON line (tests/test_torch_bench.py
# reads them from its source), then the four this benchmark adds.
BENCH_PY_KEYS = (
    "metric", "unit", "value", "vs_baseline", "best_window", "ms_per_step",
    "mfu", "step_tflops", "a100_ref_est_imgs_per_sec", "batch_per_chip",
    "steps_per_dispatch", "mfu_vs_calibrated", "calibrated_matmul_tflops",
    "pallas_damsm", "remat", "remat_blocks", "remat_d", "pallas_affine",
    "bf16_images", "dense_d", "magp_chunks", "uint8", "s2d", "up_fused",
    "gf_dim", "use_class", "best_recipe")
ADDED_KEYS = ("gpu", "power_limit_w", "n_cards", "peak_memory_mib")
LAUNCHES = "kernel launches per step in the timed windows: "
D_GRAPH = "D phases in the timed windows, replayed and eager by reason: "


def knobs(env=None) -> Dict:
    """bench.py's ``EEGAN_BENCH_*`` switches, with its defaults."""
    env = os.environ if env is None else env

    def get(name, default):
        return env.get(f"EEGAN_BENCH_{name}", default)

    def on(name, default):
        return get(name, default) == "1"

    gf = int(get("GF", "32"))
    return dict(
        batch=int(get("BATCH", "32")), gf=gf, df=int(get("DF", str(gf))),
        use_class=on("CLASS", "1"), pallas=on("PALLAS", "1"),
        remat=on("REMAT", "0"), remat_blocks=get("REMAT_BLOCKS", ""),
        remat_d=on("REMAT_D", "1"), paffine=on("PAFFINE", "0"),
        bf16img=on("BF16IMG", "0"), remat_ie=on("REMAT_IE", "0"),
        dense=on("DENSE", "1"), magp_chunks=int(get("MAGP_CHUNKS", "1")),
        uint8=on("UINT8", "0"), s2d=on("S2D", "0"),
        upfuse=on("UPFUSE", "1"), scan=int(get("SCAN", "8")),
        windows=int(get("WINDOWS", "3")), iters=int(get("ITERS", "4")),
        calibrate=on("CALIBRATE", "1"), best=on("BEST", "1"),
        best_batch=int(get("BEST_BATCH", "128")),
        best_scan=int(get("BEST_SCAN", "4")))


def bench_config(k: Dict, global_batch: int):
    """The bird recipe under the knobs ``k`` (bench.py's ``measure_recipe``
    settings, key for key)."""
    from eegan_tpu_torch.config import Config

    config = Config()
    config.GAN.GF_DIM = k["gf"]
    config.GAN.DF_DIM = k["df"]
    config.TRAIN.USE_CLASS = k["use_class"]
    config.TRAIN.CLASS_NUM = 200
    config.TRAIN.BATCH_SIZE = global_batch
    rt = config.RUNTIME
    rt.COMPUTE_DTYPE = "bfloat16"
    rt.PALLAS_DAMSM = k["pallas"]
    rt.REMAT = k["remat"]
    rt.REMAT_BLOCKS = k["remat_blocks"]
    rt.REMAT_D = k["remat_d"]
    rt.PALLAS_AFFINE = k["paffine"]
    rt.BF16_IMAGES = k["bf16img"]
    rt.REMAT_IMAGE_ENCODER = k["remat_ie"]
    rt.DENSE_D = k["dense"]
    rt.MAGP_CHUNKS = k["magp_chunks"]
    rt.UINT8_TRANSFER = k["uint8"]
    rt.S2D_CONVS = k["s2d"]
    rt.FUSED_UPSAMPLE = k["upfuse"]
    return config


def read_value(metrics) -> float:
    """The last step's ``errG/total`` as a Python float: waits for the
    device to finish the work that computed it (bench.py's
    ``fetch_scalar``). Raises ``FloatingPointError`` for a non-finite value:
    timing a program that computes NaNs measures nothing."""
    v = metrics["errG/total"]
    out = float(v[-1] if v.dim() else v)
    if not math.isfinite(out):
        raise FloatingPointError(
            f"benched program computed a non-finite errG/total ({out}); "
            "timing it would be meaningless, fix the numerics first")
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log(msg: str, main: bool) -> None:
    if main:
        print(msg, file=sys.stderr, flush=True)


def card(device) -> Dict:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (None on the CPU)."""
    if device.type != "cuda":
        return {"gpu": None, "power_limit_w": None, "nvidia_smi": None}
    index = device.index if device.index is not None else 0
    name = torch.cuda.get_device_name(index)
    try:
        line = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
        limit = float(line.rsplit(",", 1)[1].strip().split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        line, limit = None, None
    return {"gpu": name, "power_limit_w": limit, "nvidia_smi": line}


def peak_flops(device) -> Optional[float]:
    """The dense bf16 peak ``mfu`` divides by: the H100 SXM's (its 80 GB
    HBM3 part), None on any other device."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    if "H100" in name and ("HBM3" in name or "SXM" in name):
        return H100_SXM_BF16_PEAK
    return None


def calibrate_matmul_tflops(device) -> float:
    """What the card sustains on a chain of 16 data-dependent bf16 8192³
    matmuls, each renormalised (bench.py:128-159), timed from a
    synchronise to the read of the chain's sum; the best of three."""
    n = MATMUL_N
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=device).to(torch.bfloat16)

    def chain() -> float:
        acc = a
        for _ in range(MATMUL_CHAIN):
            acc = torch.matmul(acc, a)
            acc = acc * torch.rsqrt(1e-6 + acc.float().square().mean()).to(
                acc.dtype)
        return float(acc.float().sum())

    chain()
    best = math.inf
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        chain()
        best = min(best, time.perf_counter() - t0)
    return MATMUL_CHAIN * 2 * n ** 3 / best / 1e12


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launch count so far."""
    from eegan_tpu_torch.ops import affine, damsm

    return {fn.__name__: fn.launches for fn in (
        affine.affine_mask_relu, affine.affine_mask_relu_backward,
        damsm.words_similarity_forward, damsm.words_similarity_backward_dr,
        damsm.words_similarity_backward_dw)}


def d_graph_counts() -> Dict:
    """The train step's D phases so far: replayed as CUDA graphs, and run
    eagerly by reason (``training/d_graph.py``)."""
    from eegan_tpu_torch.training import d_graph

    return {"replays": d_graph.replays, "eager": dict(d_graph.eager)}


def _per_step(delta: Dict[str, int], steps: int) -> Dict[str, float]:
    return {name: n // steps if n % steps == 0 else n / steps
            for name, n in delta.items()}


def count_step(call, state, frozen, batch, noise, config, texts: int,
               steps_per_call: int = 1):
    """Operations of one train step, from one call of ``call`` that runs
    ``steps_per_call`` steps (``batch`` and ``noise`` stacked so when it is
    more than one): the registry's count of the aten ops it dispatches,
    plus the DAMSM kernels' launches in it at the plain version's count
    against ``texts`` texts (the global batch; module docstring), over
    ``steps_per_call``. Returns ({total, by_op, formula: the names counted
    by formula, launches: each kernel's launches per step}, state)."""
    from eegan_tpu_torch.ops import damsm
    from eegan_tpu_torch.utils.opcount import OpCounter

    before = launch_counts()
    with OpCounter() as counter:
        state, metrics = call(state, frozen, batch, noise)
    read_value(metrics)
    launches = {name: n - before[name] for name, n in launch_counts().items()}
    by_op = dict(counter.by_op)
    formula = sorted(counter.formula)
    for kind, name in (("forward", "words_similarity_forward"),
                       ("dr", "words_similarity_backward_dr"),
                       ("dw", "words_similarity_backward_dw")):
        if launches[name]:
            by_op[name] = launches[name] * damsm.words_similarity_ops(
                kind, batch["caps"].shape[-2], texts, REGIONS,
                config.TEXT.WORDS_NUM, config.TEXT.EMBEDDING_DIM)
            formula.append(f"{name} x{launches[name]}")
    by_op = {name: v / steps_per_call for name, v in by_op.items()}
    return {"total": sum(by_op.values()), "by_op": by_op,
            "formula": formula,
            "launches": _per_step(launches, steps_per_call)}, state


def stacked_inputs(config, k: int, mesh, device):
    """This rank's rows of the synthetic global batch, stacked K times on
    the device (the lengths stay on the host, where the packed RNN reads
    them), and K draws of noise from a generator on the device."""
    from eegan_tpu_torch.data.synthetic import synthetic_batch
    from eegan_tpu_torch.data.transforms import float_to_u8

    b = config.TRAIN.BATCH_SIZE
    host = synthetic_batch(config, b, n_words=N_WORDS)
    if config.RUNTIME.UINT8_TRANSFER:
        host = {key: float_to_u8(v) if key.startswith("img") else v
                for key, v in host.items()}
    lo, hi = mesh.row_range(b) if mesh is not None else (0, b)
    stacked = {}
    for key, v in host.items():
        t = torch.from_numpy(np.ascontiguousarray(v[lo:hi]))
        if not key.endswith("_lens"):
            t = t.to(device)
        stacked[key] = torch.stack([t] * k)
    gen = torch.Generator(device=device).manual_seed(1)
    noise = torch.randn((k, b, config.GAN.Z_DIM), generator=gen,
                        device=device)[:, lo:hi].contiguous()
    return stacked, noise


def build_recipe(k: Dict, batch_per_card: int, scan_k: int, device,
                 mesh=None):
    """The recipe under the knobs ``k`` at ``batch_per_card`` rows per
    card: (config, models, state, frozen, batch, noise), with random
    weights from seed 0 (the same on every rank) and this rank's inputs
    stacked ``scan_k`` times (:func:`stacked_inputs`)."""
    from eegan_tpu_torch.models.factory import build_models
    from eegan_tpu_torch.training.state import create_train_state

    n_cards = 1 if mesh is None else mesh.size
    config = bench_config(k, batch_per_card * n_cards)
    torch.manual_seed(0)
    models = build_models(config, N_WORDS, device=device)
    state, frozen = create_train_state(config, models)
    batch, noise = stacked_inputs(config, scan_k, mesh, device)
    return config, models, state, frozen, batch, noise


def measure_recipe(k: Dict, batch_per_card: int, scan_k: int, device,
                   mesh=None) -> Dict:
    """Build and time the train step at one (batch per card, steps per
    call) point. Returns bench.py's per-recipe dict, plus the step's
    operations and the peak device memory."""
    from eegan_tpu_torch.training.steps import make_multi_train_step

    main = mesh is None or mesh.rank == 0
    scan_k = max(scan_k, 1)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    config, models, state, frozen, batch, noise = build_recipe(
        k, batch_per_card, scan_k, device, mesh)
    multi = make_multi_train_step(config, models, mesh=mesh)

    state, metrics = multi(state, frozen, batch, noise)
    read_value(metrics)
    _log(f"build + warm-up call (B={batch_per_card} per card, K={scan_k}): "
         f"{time.perf_counter() - t0:.1f}s", main)

    ops, state = count_step(multi, state, frozen, batch, noise, config,
                            config.TRAIN.BATCH_SIZE, scan_k)
    _log("step operations by op (GFLOP): " + json.dumps(
        {name: round(v / 1e9, 3) for name, v in sorted(ops["by_op"].items())}),
        main)
    _log(f"counted from shapes, not by the registry, in {scan_k} steps: "
         + (", ".join(ops["formula"]) or "none"), main)

    imgs_per_call = batch_per_card * scan_k
    window_dts = []
    before = launch_counts()
    d_before = d_graph_counts()
    for wi in range(k["windows"]):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(k["iters"]):
            state, metrics = multi(state, frozen, batch, noise)
        read_value(metrics)
        dt = time.perf_counter() - t0
        window_dts.append(dt)
        _log(f"window {wi}: {k['iters'] * imgs_per_call / dt:.1f} img/s "
             "per card", main)

    timed_steps = k["windows"] * k["iters"] * scan_k
    launches = _per_step({name: n - before[name]
                          for name, n in launch_counts().items()},
                         timed_steps)
    if launches != ops["launches"]:
        raise RuntimeError(
            f"kernel launches per step: {launches} in the timed windows, "
            f"{ops['launches']} in the counted call")
    _log(LAUNCHES + json.dumps(launches), main)
    d_after = d_graph_counts()
    _log(D_GRAPH + json.dumps({
        "replays": d_after["replays"] - d_before["replays"],
        "eager": {k: n - d_before["eager"].get(k, 0)
                  for k, n in d_after["eager"].items()
                  if n != d_before["eager"].get(k, 0)}}), main)

    total_dt = sum(window_dts)
    per_card = k["windows"] * k["iters"] * imgs_per_call / total_dt
    best_per_card = k["iters"] * imgs_per_call / min(window_dts)
    steps_per_sec = k["windows"] * k["iters"] * scan_k / total_dt
    step_ops = ops["total"]
    peak = peak_flops(device)
    mfu = step_ops * steps_per_sec / peak if peak else None
    ops_per_img = step_ops / batch_per_card
    a100_ref = A100_PEAK_FLOPS * A100_REFERENCE_MFU / ops_per_img
    peak_mib = (torch.cuda.max_memory_allocated(device) / 2 ** 20
                if device.type == "cuda" else None)
    return {
        "value": round(per_card, 2),
        "vs_baseline": round(per_card / a100_ref, 3),
        "best_window": round(best_per_card, 2),
        "ms_per_step": round(1e3 / steps_per_sec, 1),
        "mfu": round(mfu, 4) if mfu is not None else None,
        "step_tflops": round(step_ops / 1e12, 3),
        "a100_ref_est_imgs_per_sec": round(a100_ref, 1),
        "batch_per_chip": batch_per_card,
        "steps_per_dispatch": scan_k,
        "peak_memory_mib": (round(peak_mib, 1) if peak_mib is not None
                            else None),
        "_steps_per_sec": steps_per_sec,
        "_step_ops": step_ops,
        "_window_dts": window_dts,
    }


def run(k: Dict, device, mesh=None) -> Optional[Dict]:
    """The whole benchmark on this rank; the JSON line's dict on rank 0
    (None on the other ranks)."""
    main = mesh is None or mesh.rank == 0
    n_cards = 1 if mesh is None else mesh.size
    flagship = measure_recipe(k, k["batch"], k["scan"], device, mesh)
    step_ops = flagship.pop("_step_ops")
    steps_per_sec = flagship.pop("_steps_per_sec")
    flagship.pop("_window_dts")
    info = card(device)
    if peak_flops(device) is None:
        _log(f"mfu is null: the peak is the H100 SXM's, and this device is "
             f"{info['gpu'] or device.type}", main)
    calibrated = calibrate_matmul_tflops(device) if k["calibrate"] else None
    mfu_cal = (step_ops * steps_per_sec / (calibrated * 1e12)
               if calibrated else None)
    out = {
        "metric": METRIC,
        "unit": "images/sec/chip",
        **flagship,
        "mfu_vs_calibrated": round(mfu_cal, 4) if mfu_cal is not None
        else None,
        "calibrated_matmul_tflops": round(calibrated, 1) if calibrated
        else None,
        "pallas_damsm": k["pallas"],
        "remat": k["remat"],
        "remat_blocks": k["remat_blocks"],
        "remat_d": k["remat_d"],
        "pallas_affine": k["paffine"],
        "bf16_images": k["bf16img"],
        "dense_d": k["dense"],
        "magp_chunks": k["magp_chunks"],
        "uint8": k["uint8"],
        "s2d": k["s2d"],
        "up_fused": k["upfuse"],
        "gf_dim": k["gf"],
        "use_class": k["use_class"],
        "best_recipe": None,
        "gpu": info["gpu"],
        "power_limit_w": info["power_limit_w"],
        "n_cards": n_cards,
    }
    if k["best"] and (k["best_batch"], k["best_scan"]) != (k["batch"],
                                                           k["scan"]):
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        best = measure_recipe(k, k["best_batch"], k["best_scan"], device,
                              mesh)
        out["best_recipe"] = {
            "batch": best["batch_per_chip"],
            "scan": best["steps_per_dispatch"],
            "img_s": best["value"],
            "vs_baseline": best["vs_baseline"],
            "mfu": best["mfu"],
            "peak_memory_mib": best["peak_memory_mib"],
        }
    if info["nvidia_smi"]:
        _log(f"card: {info['nvidia_smi']}", main)
    return out if main else None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--mesh", default="data:-1",
                   help="data:N, N ranks (one per GPU; gloo CPU processes "
                        "with --device cpu); default every visible GPU")
    return p.parse_args(argv)


def _rank_main(argv, device, mesh) -> None:
    """One rank of ``--mesh data:N`` (``distributed.spawn``)."""
    out = run(knobs(), device, mesh)
    if out is not None:
        print(json.dumps(out), flush=True)


def main(argv=None) -> None:
    args = parse_args(argv)
    from eegan_tpu_torch import resolve_device
    from eegan_tpu_torch.parallel import distributed
    from eegan_tpu_torch.parallel.mesh import mesh_shape

    device = resolve_device(args.device)
    visible = torch.cuda.device_count() if device.type == "cuda" else None
    data, fsdp = mesh_shape(args.mesh, visible)
    if fsdp != 1:
        raise ValueError(f"the benchmark runs bench.py's data-parallel mesh "
                         f"(data:N); got {args.mesh!r}")
    if data == 1:
        print(json.dumps(run(knobs(), device)), flush=True)
        return
    distributed.spawn(_rank_main, sys.argv[1:] if argv is None else argv,
                      data, device)


if __name__ == "__main__":
    main()
