"""The launch plans of the two redesigned kernels, and the dR decomposition
that kernel 4 computes, on the CPU.

* ``eegan_tpu_torch.ops.damsm.dr_launch_plan``: kernel 4 (dR) in two
  launches, one block per (text, image) pair, then one per image and
  64 x 64 tile of (S, D). At the train step's shape the grids fill the
  card, pass 1 fits the shared memory of a block (two per SM) and the
  scratch has the stated size; shapes the kernels do not take are refused.
* ``eegan_tpu_torch.ops.damsm.smem_bytes``: the forward's and dW's shared
  memory per block, the layouts their C launchers check.
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
    smem_bytes,
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


@pytest.mark.parametrize("L,LT", [(1, 8), (8, 8), (9, 16), (20, 24),
                                  (32, 32)])
def test_forward_and_dw_shared_memory(L, LT):
    S, D = 289, 256
    # The forward: words and contexts (L rounded up to 4 rows of D + 4),
    # one (S, LP) grid (LP: those rows, plus 4 unless 4 mod 8), 256
    # partials and four 32-float word statistics. dW: three (LT, D + 4)
    # tiles and three (S, LT + 4) grids, LT its template's word count.
    L4 = -(-L // 4) * 4
    LP = L4 if L4 % 8 == 4 else L4 + 4
    assert smem_bytes("fwd", S, L, D) == 4 * (2 * L4 * 260 + S * LP + 384)
    assert smem_bytes("dw", S, L, D) == 4 * (3 * LT * 260 + 3 * S * (LT + 4))
    assert smem_bytes("dw", S, L, D) <= SMEM_PER_BLOCK
    if L == 20:  # the train shape: three forward blocks' shared memory fits
        assert smem_bytes("fwd", S, L, D) == 66_256
        assert 3 * (66_256 + 1024) <= 228 * 1024
        assert smem_bytes("dw", S, L, D) == 171_984


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
            attn1 = torch.softmax(R @ W.T, dim=1)
            attn2 = torch.softmax(gamma1 * attn1, dim=0)
            C = attn2.T @ R
            wc, ww, cc = (W * C).sum(1), (W * W).sum(1), (C * C).sum(1)
            den = torch.clamp_min(ww.sqrt() * cc.sqrt(), eps)
            cos = wc / den
            row = torch.exp(gamma2 * cos)
            dcos = dsim[i, t] * row * gamma2 / torch.clamp_min(row.sum(), eps)
            dC = dcos[:, None] * (W / den[:, None] - cos[:, None] * C
                                  / torch.clamp_min(cc, eps * eps)[:, None])
            da2 = R @ dC.T
            da1 = gamma1 * (attn2 * (da2 - (attn2 * da2).sum(0)))
            dA = attn1 * (da1 - (attn1 * da1).sum(1, keepdim=True))
            dR[i] += dA @ W + attn2 @ dC
    return dR


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
