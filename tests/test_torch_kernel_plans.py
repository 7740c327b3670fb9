"""The launch plans of the redesigned kernels, and the dR and dW
decompositions that kernels 4 and 5 compute, on the CPU.

* ``eegan_tpu_torch.ops.damsm.dr_launch_plan``: kernel 4 (dR) in two
  launches, one block per (text, image) pair, then one per image and
  64 x 64 tile of (S, D). At the train step's shape the grids fill the
  card, pass 1 fits the shared memory of a block (two per SM) and the
  scratch has the stated size; shapes the kernels do not take are refused.
* ``eegan_tpu_torch.ops.damsm.dw_launch_plan``: kernel 5 (dW) in two
  launches, one block per pair, then one per text and 64 columns of D;
  the same checks.
* The forward's and dW pass 1's shared memory per block, the layouts
  their C launchers check.
* ``eegan_tpu_torch.ops.affine.backward_launch_plan``: kernel 2 at the 14
  sites of one generator forward of ``cfg/bird.yml`` (B=32) and
  ``cfg/sample_bird.yml`` (B=8) and at ragged C: 16-byte vectors where C
  allows, a vector that divides C, lanes that cover C, a partial buffer
  that covers every block.
* The dR decomposition: per (image, text) pair dA, attn2 and dC, then dR
  summed over the texts in the plan's order (``dA W + attn2 dC`` per text),
  in plain PyTorch, against autograd of ``words_similarity_reference``
  (rtol 1e-5) and against the JAX ``_words_sim_bwd(..., interpret=True)``
  (rtol 1e-4, the bar of ``tests/test_torch_damsm.py``).
* The dW decomposition: per pair P = dA + (dcos / den) attn2 and kappa =
  dcos cos / |W|^2 over the valid words, then P_i^T R_i summed over the
  images in index order minus (sum_i kappa_i) W, against autograd and the
  JAX kernel in interpret mode (rtol 1e-5 plus 1e-5 of the case's largest
  |gradient|), exactly 0 at padded words.

The CUDA kernels themselves are held against their plain versions on the
card by ``chip_smoke.py`` (phases 8 and 9).
"""

import os

import numpy as np
import pytest
import torch

from eegan_tpu.ops.damsm_pallas import _words_sim_bwd
from eegan_tpu_torch.config import fresh_config
from eegan_tpu_torch.ops.affine import backward_launch_plan
from eegan_tpu_torch.ops.damsm import (
    dr_launch_plan,
    dw_launch_plan,
    fwd_launch_plan,
    words_similarity_reference,
)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMEM_PER_BLOCK = 232_448  # Hopper's dynamic shared memory limit per block
TRAIN_SHAPE = (32, 32, 289, 20, 256)  # (Bi, Bt, S, L, D), cfg/bird.yml


def _affine_sites(ngf):
    """(site, C, h, w, up) of the 14 affine launches of one generator
    forward (FUSED_UPSAMPLE: affine1 of an up block reads the pre-upsample
    map)."""
    chans = [ngf * 8] * 4 + [ngf * 4, ngf * 2, ngf]
    sites, in_ch, res = [], ngf * 8, 4
    for i, out_ch in enumerate(chans):
        up = i > 0
        sites.append((f"block{i}.affine1", in_ch, res, res, up))
        res = 2 * res if up else res
        sites.append((f"block{i}.affine2", out_ch, res, res, False))
        in_ch = out_ch
    return sites


def test_dr_plan_at_the_train_shape():
    Bi, Bt, S, L, D = TRAIN_SHAPE
    plan = dr_launch_plan(*TRAIN_SHAPE)
    assert plan["pair_grid"] == (Bt, Bi)
    assert plan["pair_blocks"] == 1024 >= 128
    assert plan["sum_grid"] == (4, 5, 32)
    assert plan["sum_blocks"] == 640 >= 128
    assert plan["pair_smem_bytes"] <= SMEM_PER_BLOCK
    # Two pass-1 blocks share an SM's 228 KB (1 KB reserved per block).
    assert plan["pair_blocks_per_sm"] == 2
    assert 2 * (plan["pair_smem_bytes"] + 1024) <= 228 * 1024
    # dA and attn2 (L planes of SP = 292 floats) and dC (L rows of D) per
    # pair, float32: the 68.8 MB the kernel note states.
    assert plan["SP"] == 292
    assert plan["scratch_bytes"] == 4 * Bi * Bt * L * (2 * 292 + D)
    assert plan["scratch_bytes"] == 68_812_800


@pytest.mark.parametrize("shape", [(5, 3, 37, 7, 64), (3, 4, 37, 1, 64),
                                   (7, 1, 289, 32, 256), (2, 2, 50, 13, 100)])
def test_dr_plan_at_small_and_odd_shapes(shape):
    Bi, Bt, S, L, D = shape
    plan = dr_launch_plan(*shape)
    assert plan["pair_blocks"] == Bi * Bt
    assert plan["sum_blocks"] == -(-D // 64) * -(-S // 64) * Bi
    assert plan["pair_smem_bytes"] <= SMEM_PER_BLOCK
    assert plan["LP"] % 4 == 0 and plan["LP"] >= -(-L // 4) * 4
    assert plan["SP"] % 4 == 0 and plan["SP"] >= S
    assert plan["scratch_bytes"] == 4 * Bi * Bt * L * (2 * plan["SP"] + D)


@pytest.mark.parametrize("shape", [(4, 4, 289, 33, 256), (4, 4, 289, 20, 254),
                                   (4, 4, 289, 20, 260), (0, 4, 289, 20, 256),
                                   (4, 4, 289, 0, 256)])
def test_dr_plan_refuses_shapes_the_kernels_do_not_take(shape):
    with pytest.raises(ValueError):
        dr_launch_plan(*shape)


def test_dw_plan_at_the_train_shape():
    Bi, Bt, S, L, D = TRAIN_SHAPE
    plan = dw_launch_plan(*TRAIN_SHAPE)
    assert plan["pair_grid"] == (Bt, Bi)
    assert plan["pair_blocks"] == 1024 >= 128
    # One block per text and 64 columns: 128 blocks, one wave. 32 columns
    # (256 blocks, filling the 132 SMs) read P twice as often and measure
    # slower (chip_variants.py).
    assert plan["tile"] == 64
    assert plan["sum_grid"] == (4, 32)
    assert plan["sum_blocks"] == 128 <= 2 * 132
    assert plan["sum_blocks_per_sm"] == 2
    # Pass 1 is dR's pair block plus one 32-float statistic (|W_l|^2).
    assert plan["pair_smem_bytes"] == (
        dr_launch_plan(*TRAIN_SHAPE)["pair_smem_bytes"] + 4 * 32)
    assert plan["pair_blocks_per_sm"] == 2
    assert 2 * (plan["pair_smem_bytes"] + 1024) <= 228 * 1024
    # Two stages of 64 regions x (20 P floats + 64 R columns).
    assert plan["sum_smem_bytes"] == 4 * 2 * 64 * (20 + 64) == 43_008
    # P (S rows of L floats) and kappa (L floats) per pair, float32: the
    # 23.8 MB the kernel note states.
    assert plan["scratch_bytes"] == 4 * Bi * Bt * (S * L + L) == 23_756_800
    narrow = dw_launch_plan(*TRAIN_SHAPE, tile=32)
    assert narrow["sum_grid"] == (8, 32) and narrow["sum_blocks"] == 256


@pytest.mark.parametrize("shape", [(5, 3, 37, 7, 64), (3, 4, 37, 1, 64),
                                   (7, 1, 289, 32, 256), (2, 2, 50, 13, 100)])
def test_dw_plan_at_small_and_odd_shapes(shape):
    Bi, Bt, S, L, D = shape
    plan = dw_launch_plan(*shape)
    LT = -(-L // 4) * 4
    assert plan["pair_blocks"] == Bi * Bt
    assert plan["sum_blocks"] == -(-D // 64) * Bt
    assert plan["pair_smem_bytes"] <= SMEM_PER_BLOCK
    assert plan["LP"] % 4 == 0 and plan["LP"] >= LT
    # The stages, then the 8 warps' (LT, 64) partial sums, fit.
    assert plan["sum_smem_bytes"] >= 4 * 2 * 64 * (LT + 64)
    assert plan["sum_smem_bytes"] >= 4 * 8 * LT * 64
    assert plan["sum_smem_bytes"] <= SMEM_PER_BLOCK
    assert plan["scratch_bytes"] == 4 * Bi * Bt * (S * LT + L)


@pytest.mark.parametrize("shape,tile", [
    ((4, 4, 289, 33, 256), 32), ((4, 4, 289, 20, 254), 32),
    ((4, 4, 289, 20, 260), 32), ((0, 4, 289, 20, 256), 32),
    ((4, 4, 289, 0, 256), 32), ((4, 4, 289, 20, 256), 48),
    ((4, 65536, 37, 7, 64), 32)])
def test_dw_plan_refuses_shapes_the_kernels_do_not_take(shape, tile):
    with pytest.raises(ValueError):
        dw_launch_plan(*shape, tile=tile)


@pytest.mark.parametrize("L", [1, 8, 9, 20, 32])
def test_forward_and_dw_shared_memory(L):
    S, D = 289, 256
    # The forward: words and contexts (L rounded up to 4 rows of D + 4),
    # one (S, LP) grid (LP: those rows, plus 4 unless 4 mod 8), 256
    # partials and four 32-float word statistics. dW pass 1: the same with
    # three grids and five statistics.
    L4 = -(-L // 4) * 4
    LP = L4 if L4 % 8 == 4 else L4 + 4
    fwd = fwd_launch_plan(4, 4, S, L, D)["smem_bytes"]
    dw = dw_launch_plan(4, 4, S, L, D)["pair_smem_bytes"]
    assert fwd == 4 * (2 * L4 * 260 + S * LP + 384)
    assert dw == 4 * (2 * L4 * 260 + 3 * S * LP + 256 + 160)
    assert dw <= SMEM_PER_BLOCK
    if L == 20:  # the train shape: three forward blocks' shared memory fits
        assert fwd == 66_256
        assert 3 * (66_256 + 1024) <= 228 * 1024
        assert dw == 112_624


@pytest.mark.parametrize("cfg,batch", [("bird.yml", 32),
                                       ("sample_bird.yml", 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_affine_backward_plan_at_the_generator_sites(cfg, batch, dtype):
    ngf = fresh_config(os.path.join(ROOT, "cfg", cfg)).GAN.GF_DIM
    sites = _affine_sites(ngf)
    assert len(sites) == 14
    for site, C, h, w, up in sites:
        plan = backward_launch_plan(batch, C, h, w, up, dtype)
        _check_affine_plan(plan, batch, C, h, w, up)
        # Every site's C is a multiple of 8: 16-byte accesses throughout.
        assert plan["vec"] * dtype.itemsize == 16, site


@pytest.mark.parametrize("C", [8, 16, 24, 37, 40, 512, 511])
@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_affine_backward_plan_at_ragged_channels(C, up, dtype):
    plan = backward_launch_plan(3, C, 5, 7, up, dtype)
    _check_affine_plan(plan, 3, C, 5, 7, up)
    if C % (16 // dtype.itemsize):
        assert plan["vec"] == 1
    misaligned = backward_launch_plan(3, C, 5, 7, up, dtype, aligned=False)
    assert misaligned["vec"] == 1
    _check_affine_plan(misaligned, 3, C, 5, 7, up)


def test_affine_backward_plan_refuses_wide_channels():
    for C in (0, 513):
        with pytest.raises(ValueError):
            backward_launch_plan(2, C, 4, 4, False)


def _check_affine_plan(plan, B, C, h, w, up):
    vec, lanes, vpl = plan["vec"], plan["lanes"], plan["vecs_per_lane"]
    nblk = plan["blocks_per_sample"]
    assert C % vec == 0
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
    assert vpl & (vpl - 1) == 0 and vec * vpl <= 16
    assert lanes * vpl * vec >= C  # a group's lanes cover every channel
    assert lanes * (vpl // 2) * vec < C or vpl == 1  # and no vector to spare
    assert plan["pixels_per_warp"] * lanes == 32
    assert plan["unroll"] == (1 if up else 4 if vec * vpl <= 8 else 2)
    assert plan["grid"] == (nblk, B)
    # Every block has a step of pixels to take, and its partials a place.
    steps = -(-h * w // (256 // lanes * plan["unroll"]))
    assert 1 <= nblk <= steps
    assert plan["scratch_floats"] == B * nblk * 4 * C


def _data(Bi, Bt, S, L, D, seed):
    rng = np.random.RandomState(seed)
    regions = rng.randn(Bi, S, D).astype(np.float32)
    words = rng.randn(Bt, L, D).astype(np.float32)
    lens = rng.randint(1, L + 1, Bt).astype(np.int32)
    lens[0] = L  # one text at full length
    lens[-1] = 1  # one text of one word
    for t in range(Bt):
        words[t, lens[t]:] = 0.0
    dsim = (rng.randn(Bi, Bt) / Bi).astype(np.float32)
    return regions, words, lens, dsim


def _pair_backward(R, W, g, gamma1, gamma2, eps):
    """One (image, text) pair over the text's valid words W (n, D), as the
    kernels' pair blocks compute it, down to dA: (attn2, dA, dC, dcos,
    cos, den, wn2)."""
    attn1 = torch.softmax(R @ W.T, dim=1)
    attn2 = torch.softmax(gamma1 * attn1, dim=0)
    C = attn2.T @ R
    wc, ww, cc = (W * C).sum(1), (W * W).sum(1), (C * C).sum(1)
    den = torch.clamp_min(ww.sqrt() * cc.sqrt(), eps)
    cos = wc / den
    row = torch.exp(gamma2 * cos)
    dcos = g * row * gamma2 / torch.clamp_min(row.sum(), eps)
    dC = dcos[:, None] * (W / den[:, None] - cos[:, None] * C
                          / torch.clamp_min(cc, eps * eps)[:, None])
    da2 = R @ dC.T
    da1 = gamma1 * (attn2 * (da2 - (attn2 * da2).sum(0)))
    dA = attn1 * (da1 - (attn1 * da1).sum(1, keepdim=True))
    return attn2, dA, dC, dcos, cos, den, torch.clamp_min(ww, eps * eps)


def dr_decomposed(regions, words, lens, dsim, gamma1=5.0, gamma2=5.0,
                  eps=1e-8):
    """dR as kernel 4 computes it: pass 1 gives each pair's dA and attn2
    (S, n) and dC (n, D) over its n valid words; pass 2 sums
    dA W + attn2 dC over the texts in index order."""
    Bi, S, D = regions.shape
    Bt, L, _ = words.shape
    dR = torch.zeros_like(regions)
    for i in range(Bi):
        R = regions[i]
        for t in range(Bt):
            n = min(max(int(lens[t]), 0), L)
            if n == 0:
                continue
            W = words[t, :n]
            attn2, dA, dC = _pair_backward(R, W, dsim[i, t], gamma1, gamma2,
                                           eps)[:3]
            dR[i] += dA @ W + attn2 @ dC
    return dR


def dw_decomposed(regions, words, lens, dsim, gamma1=5.0, gamma2=5.0,
                  eps=1e-8):
    """dW as kernel 5 computes it: pass 1 gives each pair's P = dA +
    (dcos / den) attn2 (S, n) and kappa = dcos cos / max(|W|^2, eps^2)
    (n,) over its n valid words; pass 2 sums P_i^T R_i over the images in
    index order and subtracts (sum_i kappa_i) W. Padded words get 0."""
    Bi, S, D = regions.shape
    Bt, L, _ = words.shape
    dW = torch.zeros_like(words)
    for t in range(Bt):
        n = min(max(int(lens[t]), 0), L)
        if n == 0:
            continue
        W = words[t, :n]
        acc = torch.zeros_like(W)
        ksum = torch.zeros(n)
        for i in range(Bi):
            attn2, dA, _, dcos, cos, den, wn2 = _pair_backward(
                regions[i], W, dsim[i, t], gamma1, gamma2, eps)
            acc += (dA + (dcos / den) * attn2).T @ regions[i]
            ksum += dcos * cos / wn2
        dW[t, :n] = acc - ksum[:, None] * W
    return dW


@pytest.mark.parametrize("shape,seed", [((5, 3, 37, 7, 64), 0),
                                        ((3, 4, 21, 5, 32), 1),
                                        ((2, 1, 16, 1, 8), 2)])
def test_dr_decomposition_matches_autograd_and_jax(shape, seed):
    regions, words, lens, dsim = _data(*shape, seed)
    dr_launch_plan(*shape)  # a shape the kernel takes
    got = dr_decomposed(*(torch.from_numpy(a) for a in
                          (regions, words, lens, dsim)))

    r = torch.from_numpy(regions).requires_grad_(True)
    sims = words_similarity_reference(r, torch.from_numpy(words),
                                      torch.from_numpy(lens))
    want = torch.autograd.grad(sims, r, torch.from_numpy(dsim))[0]
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * scale)

    want_jax, _ = _words_sim_bwd(regions, words, lens, dsim, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jax), rtol=1e-4,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("shape,seed", [((5, 3, 37, 7, 64), 0),
                                        ((3, 4, 21, 5, 32), 1),
                                        ((2, 1, 16, 1, 8), 2)])
def test_dw_decomposition_matches_autograd_and_jax(shape, seed):
    regions, words, lens, dsim = _data(*shape, seed)
    dw_launch_plan(*shape)  # a shape the kernels take
    got = dw_decomposed(*(torch.from_numpy(a) for a in
                          (regions, words, lens, dsim)))
    for t, n in enumerate(lens):
        assert bool((got[t, n:] == 0).all())

    w = torch.from_numpy(words).requires_grad_(True)
    sims = words_similarity_reference(torch.from_numpy(regions), w,
                                      torch.from_numpy(lens))
    want = torch.autograd.grad(sims, w, torch.from_numpy(dsim))[0]
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * scale)

    _, want_jax = _words_sim_bwd(regions, words, lens, dsim, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jax), rtol=1e-5,
                               atol=1e-5 * scale)
