#!/usr/bin/env python3
"""Time variants of three of the port's CUDA kernels on one NVIDIA GPU.

    python3 chip_variants.py        # from the repository root, one CUDA card
    python3 chip_variants.py --trajectory
    python3 chip_variants.py --step_ops

``--step_ops`` times the benchmark's bf16 train step
(``eegan_tpu_torch/bench.py``'s recipe, B=32) with the MAGP's repairs
undone and done, in turns (undone, done, done, undone; host clock,
synchronised, median of 10 steps), with the device's busy time and the
step's operations in each, then the generator's 3x3 convs of 32-64 output
channels at that recipe: each shape's forward and backward device time,
operations and share of the bf16 peak (the question behind
RUNTIME.S2D_CONVS). ``--trajectory`` runs ``chip_smoke.py``'s phase 10 (the float32 train
step against the CPU's, and kernels 1-2 on against off by the Adam
moments of every tensor, beside a second kernels-on run), then a
3000-step colour-probe run with kernels 1-4 on whose state it saves every
250 steps, and the same moment check from each of the 12 states with the
probe's own next batch and noise (PERF.md §2's bar, reported per state
without stopping); about 15 minutes. Without it:

Each variant is an edited copy of a ``csrc/*.cu`` source (text
substitutions), built with the port's nvcc flags, all at once, into
``build/variants/`` and loaded with ``ctypes``:

* kernel 1, the affine forward (``affine_mask_relu.cu``): pixels per step
  and blocks per SM, at the 14 sites of one generator forward of
  ``cfg/bird.yml`` (B=32) and ``cfg/sample_bird.yml`` (B=8), bf16; every
  variant must give the committed kernel's bits;
* kernel 3, the DAMSM forward (``damsm_words.cu``) at the train shape:
  three blocks per SM, and copies with one product or both removed, whose
  times give each product's share (their sims are wrong by design);
* kernel 5, dW (``damsm_words.cu``) at the train shape: pass 2's tile of
  64 columns (committed) against 32, which must give the same bits (the
  tile does not change any output's order of summation), and a copy
  without pass 2, whose time is pass 1's (its dW is wrong by design);
* the discriminators' convs (``layers.TwiceDifferentiableConv``, committed,
  against PyTorch's own conv2d and its double backward): the MAGP-style
  double backward of three D conv shapes on cuda and on the CPU, in
  float32 and bf16, against float64, and the bf16 train step at B=32 (``cfg/bird.yml``) with
  each, in turns (committed, native, native, committed; host clock,
  synchronised, median of 10 steps) and the device's busy time per step
  (``chip_smoke.profile_steps``, 2 steps).

Times are ``chip_smoke.time_cuda``'s (L2 flushed, median of 25). Prints
nvcc's registers and spills of each variant's kernels, one JSON line of
results, and the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "variants")

UNROLL = "  return up ? 1 : (v <= 4 ? 4 : 2);"
BLOCKS = "constexpr int kBlocksPerSm = 4;"
FWD_BOUNDS = "__global__ void __launch_bounds__(kThreads, 2) damsm_words_fwd("
A_PRODUCT = "  // A = R W^T.\n  dr_rows<NQ>(R, sW, sP1, d);"
C_PRODUCT = "  // C = attn2^T R (0 for the padded words).\n  dr_cols<NQ>(R, sP2, sC, d);"
DW_TILE = "constexpr int kDwTile = 64;"
DW_SUM = """  damsm_dw_sum<<<dim3((d.D + kDwTile - 1) / kDwTile, d.Bt), kThreads,
                 sum_smem, s>>>(r, w, lens, scratch, dW, d);"""

# name -> (substitutions, pixels per step (up, vec), blocks per SM)
AFFINE = {
    "committed": ([], lambda up, v: 1 if up else (4 if v <= 4 else 2), 4),
    "more_pixels": ([(UNROLL, "  return up ? 2 : 4;")],
                    lambda up, v: 2 if up else 4, 4),
    "more_pixels_two_blocks": (
        [(UNROLL, "  return up ? 2 : 4;"),
         (BLOCKS, "constexpr int kBlocksPerSm = 2;")],
        lambda up, v: 2 if up else 4, 2),
    "two_blocks": ([(BLOCKS, "constexpr int kBlocksPerSm = 2;")],
                   lambda up, v: 1 if up else (4 if v <= 4 else 2), 2),
}
DAMSM = {
    "committed": [],
    "three_blocks": [(FWD_BOUNDS, FWD_BOUNDS.replace("2)", "3)"))],
    "no_C_product": [(C_PRODUCT, "")],
    "no_A_product": [(A_PRODUCT, "")],
    "no_products": [(A_PRODUCT, ""), (C_PRODUCT, "")],
    "dw_tile_32": [(DW_TILE, DW_TILE.replace("64", "32"))],
    "dw_pass_1_only": [(DW_SUM, "")],
}
# dW runs: name -> (damsm_words build, pass 2's tile).
DW_RUNS = {"tile_64": ("committed", 64), "tile_32": ("dw_tile_32", 32),
           "pass_1_only": ("dw_pass_1_only", 64)}


def build_all(build):
    """Writes and builds every variant; returns name -> (library, ptxas
    lines of the kernels that matter)."""
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for src, variants in (("affine_mask_relu", AFFINE), ("damsm_words", DAMSM)):
        text = open(os.path.join(build.CSRC, f"{src}.cu")).read()
        for name, spec in variants.items():
            subs = spec[0] if src == "affine_mask_relu" else spec
            body = text
            for old, new in subs:
                if old not in body:
                    raise RuntimeError(f"{src} {name}: {old!r} not found")
                body = body.replace(old, new)
            tag = f"{src}.{name}"
            cu = os.path.join(OUT, f"{tag}.cu")
            with open(cu, "w") as f:
                f.write(body)
            so = os.path.join(OUT, f"{tag}.so")
            cmd = [build.nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
                   so, cu]
            jobs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         so)
    built = {}
    for tag, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        entry, lines = "", []
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                entry = m.group(1)
            elif ("registers" in ln or "spill" in ln) and any(
                    k in entry for k in ("affine_fwd", "damsm_words_fwd",
                                         "damsm_dw_")):
                lines.append(f"{entry[-40:]}: {ln.strip()}")
        built[tag] = (ctypes.CDLL(so), lines)
    return built


def time_affine(built, cs, affine, torch, flush, gen):
    """Sum of the per-launch times over the 14 sites, per path."""
    p, i = ctypes.c_void_p, ctypes.c_int
    dt = torch.bfloat16
    totals = {}
    for path, B, ngf in (("train", 32, 32), ("sampling", 8, 48)):
        for site, C, h, w, up in cs.affine_launch_shapes(ngf):
            ops = cs.affine_operands(B, C, h, w, up, dt, gen)
            want = affine.affine_mask_relu_reference(*ops, up, 1e-5, dt)
            H, W = (2 * h, 2 * w) if up else (h, w)
            for name, (_, unroll_of, per_sm) in AFFINE.items():
                fn = built[f"affine_mask_relu.{name}"][0].eegan_affine_mask_relu_fwd
                fn.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_float] + [i] * 7 + [p]
                fn.restype = ctypes.c_int
                vec = 8  # every site's C is a multiple of 8 bf16
                lanes = min(C // vec, 256)
                unroll = unroll_of(up, vec)
                steps = -(-h * w // (256 // lanes * unroll))
                nblk = affine._blocks_per_sample(B, steps, per_sm * affine._SMS)
                out = torch.empty((B, C, H, W), dtype=dt, device="cuda",
                                  memory_format=torch.channels_last)
                ptrs = [t.data_ptr() for t in (*ops, out)]

                def run():
                    err = fn(*ptrs, B, h, w, C, int(up), 1e-5, 1, 1, vec,
                             lanes, 1, nblk, unroll,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name} {site}: CUDA error {err}")
                ms = cs.time_cuda(run, flush)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise RuntimeError(f"{name} {site}: not the plain bits")
                key = f"{path}/{name}"
                totals[key] = totals.get(key, 0.0) + ms
    return totals


def time_damsm(built, cs, damsm, torch, flush, gen):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    Bi, Bt, S, L, D = cs.DAMSM_SHAPES[0]
    regions, words, lens, _ = cs.damsm_operands(Bi, Bt, S, L, D, gen)
    lens = lens.to(torch.int32)
    plan = damsm.fwd_launch_plan(Bi, Bt, S, L, D)
    want = damsm.words_similarity_reference(regions, words, lens)
    result = {}
    for name in DAMSM:
        if name.startswith("dw_"):
            continue
        fn = built[f"damsm_words.{name}"][0].eegan_damsm_words_fwd
        fn.argtypes = [p] * 4 + [i] * 6 + [ctypes.c_longlong, f, f, p]
        fn.restype = ctypes.c_int
        sims = torch.empty((Bi, Bt), device="cuda")

        def run():
            err = fn(regions.data_ptr(), words.data_ptr(), lens.data_ptr(),
                     sims.data_ptr(), Bi, Bt, S, L, D, plan["LP"],
                     plan["smem_bytes"], 5.0, 5.0,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        ms = cs.time_cuda(run, flush)
        torch.cuda.synchronize()
        result[name] = dict(ms=ms, sims_max_abs_err=float(
            (sims - want).abs().max()))
    return result


def time_dw(built, cs, damsm, torch, flush, gen):
    """dW at the train shape with each pass-2 tile and without pass 2: ms,
    the error against autograd of the plain version, and whether the two
    tiles' bits agree."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    n = ctypes.c_longlong
    Bi, Bt, S, L, D = cs.DAMSM_SHAPES[0]
    regions, words, lens, _ = cs.damsm_operands(Bi, Bt, S, L, D, gen)
    lens = lens.to(torch.int32)
    dsim = torch.randn((Bi, Bt), generator=gen, device="cuda")
    w = words.detach().requires_grad_(True)
    want = torch.autograd.grad(
        damsm.words_similarity_reference(regions, w, lens), w, dsim)[0]
    result, outs = {}, {}
    for run_name, (name, tile) in DW_RUNS.items():
        fn = built[f"damsm_words.{name}"][0].eegan_damsm_words_bwd_dw
        fn.argtypes = [p] * 6 + [i] * 6 + [n, n, i, f, f, p]
        fn.restype = ctypes.c_int
        plan = damsm.dw_launch_plan(Bi, Bt, S, L, D, tile=tile)
        scratch = torch.empty(plan["scratch_bytes"] // 4, device="cuda")
        out = outs[run_name] = torch.zeros_like(words)

        def run():
            err = fn(regions.data_ptr(), words.data_ptr(), lens.data_ptr(),
                     dsim.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                     Bi, Bt, S, L, D, plan["LP"], plan["pair_smem_bytes"],
                     plan["sum_smem_bytes"], tile, 5.0, 5.0,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"dW {run_name}: CUDA error {err}")
        ms = cs.time_cuda(run, flush)
        torch.cuda.synchronize()
        result[run_name] = dict(
            ms=ms, sum_blocks=plan["sum_blocks"],
            max_abs_err=float((out - want).abs().max()),
            scale=float(want.abs().max()))
    result["tiles_bitwise_equal"] = torch.equal(outs["tile_32"],
                                                outs["tile_64"])
    return result


def d_conv_double_backward(torch):
    """Relative L2 distance from float64 of d/dw <d/dx <conv(x, w), gy>,
    ggx> (the MAGP's term) on cuda (TF32 off) and on the CPU, with
    PyTorch's conv2d and with TwiceDifferentiableConv, at three D conv
    shapes (B, Cin, Cout, H, k, stride, padding)."""
    import torch.nn.functional as F

    from eegan_tpu_torch.models.layers import TwiceDifferentiableConv

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # The CPU part also runs without a card:
    #   python3 -c "import chip_variants as v, torch;
    #               print(v.d_conv_double_backward(torch))"
    devices = ("cuda", "cpu") if torch.cuda.is_available() else ("cpu",)
    gen = torch.Generator().manual_seed(0)
    out = {}
    for B, C, O, H, k, s, p in ((4, 3, 32, 64, 3, 1, 1),
                                (4, 64, 64, 32, 3, 1, 1),
                                (4, 32, 64, 64, 4, 2, 1)):
        f64 = dict(generator=gen, dtype=torch.float64)
        x = torch.randn(B, C, H, H, **f64).contiguous(
            memory_format=torch.channels_last)
        w = 0.1 * torch.randn(O, C, k, k, **f64)
        gy = torch.randn(F.conv2d(x, w, stride=s, padding=p).shape, **f64)
        ggx = torch.randn(x.shape, **f64)
        convs = {"native": lambda a, b: F.conv2d(a, b, None, s, p),
                 "twice_differentiable": lambda a, b:
                     TwiceDifferentiableConv.apply(a, b, None, (s, s),
                                                   (p, p))}

        def run(conv, dtype, device):
            xx = x.to(device, dtype).requires_grad_(True)
            ww = w.to(device, dtype).requires_grad_(True)
            y = conv(xx, ww)
            gx, = torch.autograd.grad((y.double() * gy.to(device)).sum(),
                                      xx, create_graph=True)
            return torch.autograd.grad((gx.double() * ggx.to(device)).sum(),
                                       ww)[0].double().cpu()

        want = run(convs["native"], torch.float64, "cpu")
        out[str((B, C, O, H, k, s, p))] = {
            f"{device}/{name}/{str(dt).split('.')[-1]}": float(
                (run(conv, dt, device) - want).norm() / want.norm())
            for device in devices for name, conv in convs.items()
            for dt in (torch.float32, torch.bfloat16)}
    return out


def time_d_convs(cs, torch):
    """The bf16 train step with the D's convs twice-differentiable
    (committed) and with PyTorch's conv2d, in turns: step ms and the
    device's busy ms per step."""
    from eegan_tpu_torch.models.layers import Conv2d

    _, (step, state, frozen, batch, noise) = cs.phase_train_bf16()

    def use(twice):
        for d in state.discriminators:
            for m in d.modules():
                if isinstance(m, Conv2d):
                    m.twice_differentiable = twice

    run = lambda: step(state, frozen, batch, noise)
    out = {"twice_differentiable": {"ms": []}, "native": {"ms": []}}
    for twice in (True, False, False, True):
        use(twice)
        key = "twice_differentiable" if twice else "native"
        out[key]["ms"].append(cs.time_host(run, reps=10))
    for twice in (True, False):
        use(twice)
        key = "twice_differentiable" if twice else "native"
        out[key]["device_busy_ms_per_step"] = cs.profile_steps(
            run, 2, out[key]["ms"][0])["device_busy_ms_per_step"]
    use(True)
    return out


def bench_step(torch, device, batch: int, width: int = 32):
    """The benchmark's recipe (``eegan_tpu_torch/bench.py``, no knobs set
    but the batch and widths) as one train step: (step, state, frozen,
    batch, noise, config)."""
    from eegan_tpu_torch import bench
    from eegan_tpu_torch.training.steps import make_train_step

    config, models, state, frozen, stacked, noise = bench.build_recipe(
        bench.knobs({"EEGAN_BENCH_GF": str(width)}), batch, 1,
        torch.device(device))
    one = {name: v[0] for name, v in stacked.items()}
    return (make_train_step(config, models), state, frozen, one, noise[0],
            config)


def magp_repair_ab(cs, torch, device="cuda", batch=32, width=32,
                   reps=10):
    """The benchmark's bf16 step with the MAGP's repairs undone and done,
    in turns (undone, done, done, undone; host clock, synchronised, median
    of ``reps`` steps each), the device's busy time per step in each
    (``chip_smoke.profile_steps``, 2 steps), and the step's operations in
    each (``bench.count_step``)."""
    from compare_op_counts import magp_repairs_undone
    from eegan_tpu_torch import bench

    step, state, frozen, one, noise, config = bench_step(torch, device,
                                                         batch, width)
    run = lambda: step(state, frozen, one, noise)
    out = {"undone": {"ms": []}, "done": {"ms": []}}
    for key in ("undone", "done", "done", "undone"):
        with (magp_repairs_undone() if key == "undone"
              else contextlib.nullcontext()):
            out[key]["ms"].append(cs.time_host(run, reps=reps))
    for key in ("undone", "done"):
        with (magp_repairs_undone() if key == "undone"
              else contextlib.nullcontext()):
            out[key]["device_busy_ms_per_step"] = cs.profile_steps(
                run, 2, out[key]["ms"][0])["device_busy_ms_per_step"]
            ops, state = bench.count_step(step, state, frozen, one, noise,
                                          config, batch)
            out[key]["step_tflop"] = ops["total"] / 1e12
            out[key]["tflop_by_op"] = {name: v / 1e12 for name, v
                                       in ops["by_op"].items()}
    out.update(batch=batch, gf_dim=width, dtype="bfloat16",
               recipe="eegan_tpu_torch/bench.py defaults")
    return out


def generator_convs(torch, config, models, batch: int, device):
    """The generator's convolutions in one train-mode forward at
    ``batch``: (input shape, weight shape, stride, padding) -> calls."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from eegan_tpu_torch.models.attr_enhance import AttrEnhance

    calls = {}

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket is torch.ops.aten.convolution:
                x, w = args[0], args[1]
                key = (tuple(x.shape), tuple(w.shape), tuple(args[3]),
                       tuple(args[4]), bool(args[6]))
                calls[key] = calls.get(key, 0) + 1
            return func(*args, **(kwargs or {}))

    emb = config.TEXT.EMBEDDING_DIM
    gen = torch.Generator(device=device).manual_seed(3)
    sent = torch.randn((batch, emb), generator=gen, device=device)
    attrs = torch.randn((batch, config.TEXT.MAX_ATTR_NUM, emb),
                        generator=gen, device=device)
    z = torch.randn((batch, config.GAN.Z_DIM), generator=gen, device=device)
    models.generator.train()
    with torch.no_grad(), Record():
        _, attn = models.attr_enhance(sent, attrs)
        models.generator(z, sent, AttrEnhance.attr_merge(attn))
    return calls


NARROW_COUT = (32, 64)  # the output channels RUNTIME.S2D_CONVS packs on a TPU


def narrow_convs(cs, torch, device="cuda", batch=32, width=32, step_ms=None,
                 timer=None):
    """The generator's 3x3 convs of 32-64 output channels in the bf16 step
    at ``batch``: per shape, its calls per forward, the forward's and the
    backward's (input and weight gradients) device time
    (``chip_smoke.time_cuda``, L2 flushed, median of 25), their operations
    and their share of the H100 SXM's dense bf16 peak (989 TFLOP/s)."""
    from eegan_tpu_torch import bench
    from eegan_tpu_torch.models.factory import build_models

    config = bench.bench_config(bench.knobs({"EEGAN_BENCH_GF": str(width)}),
                                batch)
    torch.manual_seed(0)
    models = build_models(config, bench.N_WORDS, device=device)
    calls = generator_convs(torch, config, models, batch, device)
    if timer is None:
        flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=device)
        timer = lambda fn: cs.time_cuda(fn, flush)
    gen = torch.Generator(device=device).manual_seed(4)
    rows, total_ms, total_ops = [], 0.0, 0
    for (xs, ws, stride, pad, transposed), n in sorted(calls.items()):
        if transposed or ws[2:] != (3, 3) or not (
                NARROW_COUT[0] <= ws[0] <= NARROW_COUT[1]):
            continue
        x = torch.randn(xs, generator=gen, device=device).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        w = torch.randn(ws, generator=gen, device=device).to(torch.bfloat16)
        y = torch.nn.functional.conv2d(x, w, None, stride, pad)
        dy = torch.randn_like(y)
        fwd_ms = timer(lambda: torch.nn.functional.conv2d(x, w, None, stride,
                                                          pad))
        bwd_ms = timer(lambda: torch.ops.aten.convolution_backward(
            dy, x, w, None, list(stride), list(pad), [1, 1], False, [0, 0],
            1, [True, True, False]))
        ops = 2 * y.numel() * ws[1] * ws[2] * ws[3]
        rows.append(dict(x=list(xs), w=list(ws), calls_per_step=n,
                         fwd_ms=fwd_ms, bwd_ms=bwd_ms, fwd_gflop=ops / 1e9,
                         fwd_share_of_peak=ops / (fwd_ms * 1e-3)
                         / bench.H100_SXM_BF16_PEAK,
                         bwd_share_of_peak=2 * ops / (bwd_ms * 1e-3)
                         / bench.H100_SXM_BF16_PEAK))
        total_ms += n * (fwd_ms + bwd_ms)
        total_ops += n * 3 * ops
    return dict(batch=batch, gf_dim=width, dtype="bfloat16", convs=rows,
                ms_per_step=total_ms, tflop_per_step=total_ops / 1e12,
                share_of_peak=(total_ops / (total_ms * 1e-3)
                               / bench.H100_SXM_BF16_PEAK if total_ms
                               else None),
                share_of_step=(total_ms / step_ms if step_ms else None))


TRAJECTORY_ENV = {"EEGAN_PROBE_PAFFINE": "1", "EEGAN_PROBE_UPFUSE": "0"}
TRAJECTORY_STEPS = 3000


def affine_trajectory(cs, torch):
    """Kernels 1-2 held along a trained trajectory: one colour-probe run
    (``validate_learning.run``, seed 0, 3000 GAN steps) with kernels 1-4
    on and the JAX script's other switches (RUNTIME.FUSED_UPSAMPLE off,
    PALLAS_DAMSM on, PyTorch's TF32 defaults), its state saved at each of
    the 12 probes (``probes.train_and_probe``'s ``snapshot``); then from
    each state, with the colour probe's own next batch and noise,
    ``chip_smoke.affine_switch_check``: kernels 1-2 on against off and a
    second run on, per tensor, without stopping at a tensor beyond the
    bar."""
    from eegan_tpu_torch import validate_learning
    from eegan_tpu_torch.training import probes
    from eegan_tpu_torch.training.state import create_train_state
    from eegan_tpu_torch.training.steps import make_train_step

    os.environ.update(TRAJECTORY_ENV)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    config = validate_learning.build_config()
    dev = torch.device("cuda")
    draw = probes.gan_noise(config, 0, dev)
    noises = {}

    def noise(step, b):
        z = draw(step, b)
        if step % probes.PROBE_EVERY == 1:
            noises[step] = z.clone()
        return z

    saved = []

    def snapshot(done, state, frozen, pool):
        saved.append((done, cs.state_snapshot(state, "cpu"), frozen, pool))

    result = validate_learning.run(config, seed=0, steps=TRAJECTORY_STEPS,
                                   device=dev, noise=noise,
                                   snapshot=snapshot)
    b = config.TRAIN.BATCH_SIZE
    noises[TRAJECTORY_STEPS + 1] = draw(TRAJECTORY_STEPS + 1, b)
    models = probes.build_probe_models(
        config, validate_learning.ColorDataset(config).n_words, 0, dev)
    state, _ = create_train_state(config, models)
    step_fn = make_train_step(config, models)
    states = {}
    for done, snap, frozen, pool in saved:
        cs.state_restore(state, snap)
        check = cs.affine_switch_check(
            f"trajectory step {done}", step_fn, state, frozen,
            pool[(done + 1) % len(pool)], noises[done + 1], strict=False)
        states[done] = {k: check[k] for k in (
            "within_bar", "beyond_bar", "max_b", "max_c", "per_optimizer",
            "nondeterministic_ops")}
        states[done]["worst"] = check["worst"][0]
        print(json.dumps({"trajectory_state": done, **states[done]}),
              flush=True)
    return {"switches": {**TRAJECTORY_ENV, "RUNTIME.PALLAS_DAMSM": True,
                         "dtype": "float32"},
            "run": {k: result[k] for k in (
                "best", "best_step", "final", "passed", "separation",
                "train_ms_per_step", "damsm_ms_per_step")},
            "states": states}


def main() -> None:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trajectory", action="store_true",
                        help="phase 10 of chip_smoke.py, then kernels 1-2 "
                             "held along a colour-probe run instead of the "
                             "kernel variants")
    parser.add_argument("--step_ops", action="store_true",
                        help="the benchmark's bf16 step with the MAGP's "
                             "repairs undone and done, and the generator's "
                             "narrow 3x3 convs, instead of the variants")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_variants: FAIL: this script needs a GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from eegan_tpu_torch.ops import _build, affine, damsm

    if args.step_ops:
        _build.build(_build.sources())
        repair = magp_repair_ab(cs, torch)
        result = dict(magp_repair=repair,
                      narrow_convs=narrow_convs(
                          cs, torch,
                          step_ms=repair["done"]["device_busy_ms_per_step"]),
                      gpu=torch.cuda.get_device_name(0))
        print(json.dumps(result))
        print(cs.nvidia_smi())
        return
    if args.trajectory:
        _build.build(_build.sources())
        result = dict(phase_10=cs.phase_train_parity()["moments"],
                      trajectory=affine_trajectory(cs, torch),
                      gpu=torch.cuda.get_device_name(0))
        print(json.dumps(result))
        print(cs.nvidia_smi())
        return
    built = build_all(_build)
    for tag, (_, lines) in built.items():
        for ln in lines:
            print(f"ptxas {tag} {ln}")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 17)
    result = dict(
        affine_forward_ms=time_affine(built, cs, affine, torch, flush, gen),
        damsm_forward=time_damsm(built, cs, damsm, torch, flush, gen),
        damsm_dw=time_dw(built, cs, damsm, torch, flush, gen),
        d_conv_double_backward=d_conv_double_backward(torch),
        d_convs_bf16_step=time_d_convs(cs, torch),
        gpu=torch.cuda.get_device_name(0))
    print(json.dumps(result))
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
