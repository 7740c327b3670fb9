"""Port parity: the DAMSM losses (``eegan_tpu_torch.losses.damsm``) against
the JAX package's, and the fused word-region similarity
(``eegan_tpu_torch.ops.damsm``) against the JAX Pallas kernels in interpret
mode (``words_similarity_pallas`` / ``words_loss_pallas(...,
interpret=True)``).

On the CPU the port's fused op takes its plain version; the CUDA kernels
are held against that plain version on the card by ``chip_smoke.py``.
Inputs come from numpy with a seed; padded words are zero vectors, as the
text encoder gives them. Tolerances: values at atol 1e-3 / rtol 1e-4 and
gradients at atol 2e-4 / rtol 2e-3 (the bars of ``tests/test_pallas.py``)
against the Pallas kernels; the plain losses against the JAX losses at
1e-5; padded words get an exactly zero gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegan_tpu.losses import damsm as jd
from eegan_tpu.ops.damsm_pallas import words_loss_pallas, words_similarity_pallas
from eegan_tpu_torch.losses import damsm as td
from eegan_tpu_torch.ops.damsm import (
    words_loss_fused,
    words_similarity_backward_dr,
    words_similarity_forward,
    words_similarity_fused,
    words_similarity_reference,
)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(4, 4, 37, 7, 64), (4, 4, 289, 20, 256)]  # (Bi, Bt, S, L, D)


def _data(Bi, Bt, S, L, D, seed=0):
    rng = np.random.RandomState(seed)
    regions = rng.randn(Bi, S, D).astype(np.float32)
    words = rng.randn(Bt, L, D).astype(np.float32)
    lens = rng.randint(min(3, L), L + 1, Bt).astype(np.int32)
    lens[0] = L  # one text with no padding
    for i in range(Bt):
        words[i, lens[i]:] = 0.0
    cls = np.array([1, 2, 1, 3] * Bt, np.int32)[:Bt]  # 0 and 2 share one
    return regions, words, lens, cls


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("use_cls", [False, True])
def test_similarity_matches_pallas_kernel(shape, use_cls):
    regions, words, lens, cls = _data(*shape)
    want = np.asarray(words_similarity_pallas(
        regions, words, lens, cls if use_cls else None, interpret=True))
    sims = words_similarity_fused(*_t(regions, words, lens)) * 10.0
    if use_cls:
        sims = sims.masked_fill(td.same_class_mask(torch.from_numpy(cls)),
                                td.NEG_INF)
    got = sims.numpy()
    finite = want > -1e8
    np.testing.assert_array_equal(finite, got > -1e8)
    np.testing.assert_allclose(got[finite], want[finite], atol=1e-3,
                               rtol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("use_cls", [False, True])
def test_words_loss_grads_match_pallas_kernel(shape, use_cls):
    """Values and both gradients of the fused words loss against the Pallas
    custom VJP; exact zeros at padded words."""
    regions, words, lens, cls = _data(*shape, seed=1)
    c = cls if use_cls else None

    def f_pallas(r, w):
        l0, l1 = words_loss_pallas(r, w, lens, c, 5.0, 5.0, 10.0, True)
        return l0 + 0.7 * l1

    want, (want_dr, want_dw) = jax.value_and_grad(f_pallas, argnums=(0, 1))(
        regions, words)
    r, w = (t.requires_grad_(True) for t in _t(regions, words))
    l0, l1 = words_loss_fused(r, w, torch.from_numpy(lens),
                              None if c is None else torch.from_numpy(c),
                              5.0, 5.0, 10.0)
    got = l0 + 0.7 * l1
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(want_dr),
                               atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want_dw),
                               atol=2e-4, rtol=2e-3)
    for i, n in enumerate(lens):
        assert np.all(w.grad.numpy()[i, n:] == 0.0)
        assert np.all(np.asarray(want_dw)[i, n:] == 0.0)


def test_fused_loss_is_the_plain_loss_on_cpu():
    regions, words, lens, cls = _data(*SHAPES[0], seed=2)
    args = _t(regions.reshape(4, 1, 37, 64), words, lens, cls)
    words_similarity_forward.launches = 0
    fused = words_loss_fused(*args)
    plain = td.words_loss(*args)
    assert words_similarity_forward.launches == 0
    for a, b in zip(fused, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(
        words_similarity_fused(*args[:3]),
        words_similarity_reference(*args[:3]), rtol=0, atol=0)


def test_kernel_wrappers_refuse_other_devices():
    regions, words, lens, _ = (torch.from_numpy(a) for a in
                               _data(*SHAPES[0]))
    with pytest.raises(ValueError, match="no kernel"):
        words_similarity_fused(*(t.to("meta") for t in (regions, words,
                                                        lens)))
    for fn, extra in ((words_similarity_forward, ()),
                      (words_similarity_backward_dr,
                       (torch.zeros((4, 4)),))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(regions, words, lens, *extra)


@pytest.mark.parametrize("use_cls", [False, True])
def test_sent_loss_matches_jax(use_cls):
    rng = np.random.RandomState(3)
    cnn, rnn = rng.randn(2, 6, 16).astype(np.float32)
    cls = np.array([1, 2, 1, 4, 5, 2], np.int32) if use_cls else None

    def jloss(a, b):
        l0, l1 = jd.sent_loss(a, b, cls)
        return l0 + 0.3 * l1, (l0, l1)

    (_, want), want_grads = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(cnn, rnn)
    a, b = (t.requires_grad_(True) for t in _t(cnn, rnn))
    got = td.sent_loss(a, b, None if cls is None else torch.from_numpy(cls))
    (got[0] + 0.3 * got[1]).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g.detach()), float(w), **TOL)
    for g, w in zip((a.grad, b.grad), want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_words_loss_and_similarity_match_jax():
    regions, words, lens, cls = _data(*SHAPES[0], seed=4)
    r4 = regions.reshape(4, 1, 37, 64)  # the (B, h, w, D) form
    for fn_t, fn_j in ((td.words_loss, jd.words_loss),
                       (td.words_similarity, jd.words_similarity)):
        want = fn_j(r4, words, lens, cls)
        got = fn_t(*_t(r4, words, lens, cls))
        for g, w in zip(np.atleast_1d(got), np.atleast_1d(want)):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-5, atol=1e-4)
    wei = td.attend_words_to_regions(
        *_t(words, regions), td.word_mask(torch.from_numpy(lens), 7), 5.0)
    want = jd.attend_words_to_regions(
        words, regions, (np.arange(7)[None] < lens[:, None]).astype(
            np.float32), 5.0)
    np.testing.assert_allclose(wei.numpy(), np.asarray(want), **TOL)


def test_attention_helpers_match_jax():
    rng = np.random.RandomState(5)
    q = rng.randn(2, 3, 4, 8).astype(np.float32)
    k, v = rng.randn(2, 2, 5, 8).astype(np.float32)
    mask = np.array([[False] * 5, [False, False, True, True, True]])
    got = td.global_attention(*_t(q, k, v, mask))
    want = jd.global_attention(q, k, v, mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    cnn, rnn = rng.randn(2, 5, 8).astype(np.float32)
    np.testing.assert_allclose(
        td.sent_similarity(*_t(cnn, rnn)).numpy(),
        np.asarray(jd.sent_similarity(cnn, rnn)), **TOL)
    ids = np.array([3, 1, 3, 3, 2], np.int32)
    np.testing.assert_array_equal(
        td.same_class_mask(torch.from_numpy(ids)).numpy(),
        np.asarray(jd.same_class_mask(jnp.asarray(ids))))
    logits = rng.randn(5, 5).astype(np.float32) * 4
    labels = np.arange(5)
    np.testing.assert_allclose(
        float(td.cross_entropy_int(*_t(logits, labels))),
        float(jd.cross_entropy_int(logits, labels)), **TOL)
