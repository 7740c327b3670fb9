"""The launch plans of the two forward kernels, and the DAMSM forward's
arithmetic, on the CPU.

* ``eegan_tpu_torch.ops.affine.forward_launch_plan``: kernel 1 at the 14
  sites of one generator forward of ``cfg/bird.yml`` (B=32) and
  ``cfg/sample_bird.yml`` (B=8), in bf16 and float32, and at ragged and
  misaligned C. Walking the plan's (block, thread, step) map as the kernel
  does writes every output (b, y, x, vector) exactly once.
* ``eegan_tpu_torch.ops.damsm.fwd_launch_plan``: kernel 3 at the train
  shape (two or more blocks per SM, within a block's shared memory), at odd
  shapes, and its refusals.
* The DAMSM forward as kernel 3 computes it (per pair, over the text's
  valid words only; a text without one gives log(1e-8)), in plain PyTorch,
  against ``words_similarity_reference`` (rtol 1e-5) and against the JAX
  ``words_similarity_fused(..., interpret=True)`` (rtol 1e-4, the bar of
  ``tests/test_torch_damsm.py``).

The CUDA kernels themselves are held against their plain versions on the
card by ``chip_smoke.py`` (phases 3 and 9).
"""

import math
import os

import numpy as np
import pytest
import torch

from eegan_tpu.ops.damsm_pallas import words_similarity_fused
from eegan_tpu_torch.config import fresh_config
from eegan_tpu_torch.ops.affine import forward_launch_plan
from eegan_tpu_torch.ops.damsm import fwd_launch_plan, words_similarity_reference

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = 256
SMEM_PER_BLOCK = 232_448  # Hopper's dynamic shared memory limit per block
SM_SMEM = 228 * 1024  # shared memory of one SM (Hopper)
FWD_WAVE = 4 * 132  # four affine forward blocks on each of an H100's SMs
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


def _forward_writes(plan, C, h, w, up):
    """How often the kernel writes each (pixel, vector) of one sample's
    output, walking its map: thread t of block (x, chunk) owns vector
    chunk * lanes + t % lanes (if that is below C / vec and t // lanes below
    groups) and, at step k, the low-res pixels (k * nblk + x) * groups *
    unroll + u * groups + t // lanes below h * w; with the upsample each
    pixel writes its 2x2 quad. Every sample (the grid's z) has the same
    map."""
    nvec = C // plan["vec"]
    lanes, chunks, groups = plan["lanes"], plan["chunks"], plan["groups"]
    unroll, nblk = plan["unroll"], plan["blocks_per_sample"]
    hw = h * w
    tid = np.arange(THREADS)
    grp, jl = tid // lanes, tid % lanes
    ksteps = -(-hw // (nblk * groups * unroll)) + 1
    k = np.arange(ksteps)[:, None, None]
    bx = np.arange(nblk)[None, :, None]
    written = []
    for chunk in range(chunks):
        j = chunk * lanes + jl
        live = (grp < groups) & (j < nvec)
        for u in range(unroll):
            p = (k * nblk + bx) * groups * unroll + u * groups + grp
            sel = np.broadcast_to(live, p.shape) & (p < hw)
            pix, vec = p[sel], np.broadcast_to(j, p.shape)[sel]
            if up:
                iy, ix = pix // w, pix % w
                for q in range(4):
                    out = (2 * iy + q // 2) * (2 * w) + 2 * ix + q % 2
                    written.append(out * nvec + vec)
            else:
                written.append(pix * nvec + vec)
    n_out = (4 if up else 1) * hw * nvec
    return np.bincount(np.concatenate(written), minlength=n_out)


def _check_forward_plan(plan, B, C, h, w, up, dtype):
    vec, lanes, chunks = plan["vec"], plan["lanes"], plan["chunks"]
    nblk = plan["blocks_per_sample"]
    assert C % vec == 0 and vec in (1, 16 // dtype.itemsize)
    nvec = C // vec
    assert 1 <= lanes <= THREADS
    assert lanes * chunks >= nvec > lanes * (chunks - 1)  # no spare chunk
    assert plan["groups"] == THREADS // lanes
    assert plan["unroll"] == (1 if up else 4 if vec <= 4 else 2)
    assert plan["grid"] == (nblk, chunks, B)
    assert plan["blocks"] == nblk * chunks * B
    # One or two whole waves, and never a block without a step.
    assert plan["blocks"] <= 2 * FWD_WAVE or nblk == 1
    steps = -(-h * w // (plan["groups"] * plan["unroll"]))
    assert 1 <= nblk <= steps
    counts = _forward_writes(plan, C, h, w, up)
    assert counts.min() == 1 and counts.max() == 1


@pytest.mark.parametrize("cfg,batch", [("bird.yml", 32),
                                       ("sample_bird.yml", 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_affine_forward_plan_at_the_generator_sites(cfg, batch, dtype):
    ngf = fresh_config(os.path.join(ROOT, "cfg", cfg)).GAN.GF_DIM
    sites = _affine_sites(ngf)
    assert len(sites) == 14
    for site, C, h, w, up in sites:
        plan = forward_launch_plan(batch, C, h, w, up, dtype)
        _check_forward_plan(plan, batch, C, h, w, up, dtype)
        # Every site's C is a multiple of 8: 16-byte accesses throughout,
        # and one chunk covers the pixel.
        assert plan["vec"] * dtype.itemsize == 16, site
        assert plan["chunks"] == 1, site
    if cfg == "bird.yml":
        # The largest launch, block6.affine1 (C=64, 128x128, up), fills two
        # whole waves: B=32 samples of 33 blocks.
        plan = forward_launch_plan(batch, 2 * ngf, 128, 128, True, dtype)
        assert plan["grid"] == (2 * FWD_WAVE // batch, 1, batch)


@pytest.mark.parametrize("C", [8, 37, 40, 511])
@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_affine_forward_plan_at_ragged_channels(C, up, dtype):
    plan = forward_launch_plan(3, C, 5, 7, up, dtype)
    _check_forward_plan(plan, 3, C, 5, 7, up, dtype)
    if C % (16 // dtype.itemsize):
        assert plan["vec"] == 1
    misaligned = forward_launch_plan(3, C, 5, 7, up, dtype, aligned=False)
    assert misaligned["vec"] == 1
    _check_forward_plan(misaligned, 3, C, 5, 7, up, dtype)
    if C == 511:  # 511 vectors of one channel: two chunks of 256 lanes
        assert misaligned["chunks"] == 2 and misaligned["lanes"] == THREADS


@pytest.mark.parametrize("shape", [(0, 8, 4, 4), (2, 0, 4, 4), (2, 8, 0, 4),
                                   (65536, 8, 4, 4)])
def test_affine_forward_plan_refuses_shapes_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError):
        forward_launch_plan(*shape, False)


def test_damsm_forward_plan_at_the_train_shape():
    Bi, Bt, S, L, D = TRAIN_SHAPE
    plan = fwd_launch_plan(*TRAIN_SHAPE)
    assert plan["grid"] == (Bt, Bi) and plan["blocks"] == 1024
    assert plan["threads"] == THREADS
    # Words and contexts (20 rows of 260), one (289, 20) grid, partials and
    # word statistics: 64.7 KB, so that two or more blocks share an SM.
    assert plan["LP"] == 20
    assert plan["smem_bytes"] == 4 * (2 * 20 * 260 + 289 * 20 + 256 + 128)
    assert plan["smem_bytes"] <= SMEM_PER_BLOCK
    assert plan["blocks_per_sm"] >= 2
    assert 3 * (plan["smem_bytes"] + 1024) <= SM_SMEM


@pytest.mark.parametrize("shape", [(5, 3, 37, 7, 64), (3, 4, 37, 1, 64),
                                   (7, 1, 289, 32, 256), (2, 2, 50, 13, 100),
                                   (1, 1, 1, 4, 4)])
def test_damsm_forward_plan_at_small_and_odd_shapes(shape):
    Bi, Bt, S, L, D = shape
    plan = fwd_launch_plan(*shape)
    L4 = -(-L // 4) * 4
    assert plan["grid"] == (Bt, Bi) and plan["blocks"] == Bi * Bt
    assert plan["LP"] % 4 == 0 and plan["LP"] >= L4
    assert plan["smem_bytes"] == 4 * (2 * L4 * (D + 4) + S * plan["LP"]
                                      + 256 + 128)
    assert plan["smem_bytes"] <= SMEM_PER_BLOCK
    assert plan["blocks_per_sm"] >= 1


@pytest.mark.parametrize("shape", [(4, 4, 289, 33, 256), (4, 4, 289, 20, 254),
                                   (4, 4, 289, 20, 260), (0, 4, 289, 20, 256),
                                   (4, 4, 289, 0, 256), (65536, 1, 4, 4, 4)])
def test_damsm_forward_plan_refuses_shapes_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError):
        fwd_launch_plan(*shape)


def _data(Bi, Bt, S, L, D, seed, empty=False):
    rng = np.random.RandomState(seed)
    regions = rng.randn(Bi, S, D).astype(np.float32)
    words = rng.randn(Bt, L, D).astype(np.float32)
    lens = rng.randint(1, L + 1, Bt).astype(np.int32)
    lens[0] = L  # one text at full length
    lens[-1] = 0 if empty else 1  # one text of one word, or of none
    for t in range(Bt):
        words[t, lens[t]:] = 0.0
    return regions, words, lens


def fwd_decomposed(regions, words, lens, gamma1=5.0, gamma2=5.0, eps=1e-8):
    """The (Bi, Bt) sims as kernel 3 computes them: per (image, text) pair
    over the text's n valid words only, the double softmax, the context,
    the cosines and the log of their exp-sum; a text with no valid word
    gives log(eps), the reference's masked sum of 0."""
    Bi = regions.shape[0]
    Bt, L, _ = words.shape
    sims = torch.empty((Bi, Bt), dtype=torch.float32)
    for i in range(Bi):
        R = regions[i]
        for t in range(Bt):
            n = min(max(int(lens[t]), 0), L)
            if n == 0:
                sims[i, t] = torch.log(torch.tensor(eps, dtype=torch.float32))
                continue
            W = words[t, :n]
            attn1 = torch.softmax(R @ W.T, dim=1)
            attn2 = torch.softmax(gamma1 * attn1, dim=0)
            C = attn2.T @ R
            wc, ww, cc = (W * C).sum(1), (W * W).sum(1), (C * C).sum(1)
            den = torch.clamp_min(ww.sqrt() * cc.sqrt(), eps)
            row = torch.exp(gamma2 * wc / den)
            sims[i, t] = torch.log(torch.clamp_min(row.sum(), eps))
    return sims


@pytest.mark.parametrize("shape,seed", [((5, 3, 37, 7, 64), 0),
                                        ((3, 4, 21, 5, 32), 1),
                                        ((2, 1, 16, 1, 8), 2),
                                        ((2, 3, 9, 12, 16), 3)])
def test_damsm_forward_arithmetic_matches_reference_and_jax(shape, seed):
    regions, words, lens = _data(*shape, seed)
    fwd_launch_plan(*shape)  # a shape the kernel takes
    got = fwd_decomposed(*(torch.from_numpy(a) for a in
                           (regions, words, lens)))
    want = words_similarity_reference(*(torch.from_numpy(a) for a in
                                        (regions, words, lens)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    want_jax = words_similarity_fused(regions, words, lens, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jax), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape,seed", [((3, 4, 21, 5, 32), 4),
                                        ((2, 1, 16, 3, 8), 5)])
def test_damsm_forward_arithmetic_of_a_text_without_words(shape, seed):
    regions, words, lens = _data(*shape, seed, empty=True)
    got = fwd_decomposed(*(torch.from_numpy(a) for a in
                           (regions, words, lens)))
    want = words_similarity_reference(*(torch.from_numpy(a) for a in
                                        (regions, words, lens)))
    assert float(got[0, -1]) == pytest.approx(math.log(1e-8), rel=1e-6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
