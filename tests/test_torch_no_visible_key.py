"""Attention and decode where a query sees no key: zeros everywhere.

With no visible key (a decode position before the cache, or every key
left of the window; an attention row at a ``q_offset`` whose window lies
past the keys) the JAX package's Pallas decode kernel zeroes V at the
invalid keys and returns 0. The port's plain versions
(``ref.flash_decode_ref``, ``ref.flash_attention_ref``) and
``ops.flash_decode`` on the CPU return 0 there too, within 1e-6 of the
Pallas kernel in interpret mode (``tests/test_torch_cuda.py`` holds the
CUDA kernels to the same zeros on the card). Everywhere else the
zeroing changes nothing: the rows equal the plain softmax bit for bit.
The Pallas attention kernel is not compared on rows that see no key: it
returns the mean of V over the key blocks it visits there.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bkv as pallas_attn
from repro.kernels.flash_decode import flash_decode_bkv as pallas_decode
from repro_torch.kernels import ops, ref


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _plain_softmax_decode(q, k, v, pos, window):
    """The plain decode as it was before the zeroing (softmax of the
    masked scores), for rows that see a key."""
    hd = q.shape[-1]
    s = torch.einsum("bgd,btd->bgt", q * (1.0 / math.sqrt(hd)), k)
    cols = torch.arange(k.shape[1])
    valid = cols <= pos
    if window is not None:
        valid &= cols > pos - window
    s = torch.where(valid, s, torch.full((), ref.NEG_INF))
    return torch.einsum("bgt,btd->bgd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("pos,window", [(-1, None), (-1, 64), (400, 64)])
def test_decode_with_no_visible_key_is_zero_like_pallas(pos, window):
    """q (2, 2, 64), S 256: pos -1, and pos 400 with window 64 (every
    key left of the window)."""
    rng = np.random.default_rng(11)
    q, k, v = _randn(rng, 2, 2, 64), _randn(rng, 2, 256, 64), \
        _randn(rng, 2, 256, 64)
    got = ref.flash_decode_ref(q, k, v, pos, window=window, softcap=50.0)
    via_ops = ops.flash_decode(q.reshape(1, 1, 4, 64), k.reshape(1, 2, 256,
                                                                 64),
                               v.reshape(1, 2, 256, 64),
                               torch.tensor(pos, dtype=torch.int32),
                               window=window, softcap=50.0)
    want = pallas_decode(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                         jnp.asarray(v.numpy()), jnp.int32(pos),
                         window=window, softcap=50.0, interpret=True)
    np.testing.assert_allclose(np.asarray(want), 0.0, atol=1e-6)
    for out in (got, via_ops):
        np.testing.assert_allclose(out.numpy().reshape(2, 2, 64),
                                   np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("pos,window", [(0, None), (100, None), (255, 64),
                                        (300, 64)])
def test_decode_with_a_visible_key_is_unchanged(pos, window):
    rng = np.random.default_rng(12)
    q, k, v = _randn(rng, 3, 2, 32), _randn(rng, 3, 256, 32), \
        _randn(rng, 3, 256, 32)
    got = ref.flash_decode_ref(q, k, v, pos, window=window)
    assert torch.equal(got, _plain_softmax_decode(q, k, v, pos, window))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_rows_with_no_visible_key_are_zero(causal):
    """Skv 100, window 64, q at positions 130..199: rows from position
    163 on see no key and are 0; the rows before them match the Pallas
    kernel (which has ``q_offset`` too) and the plain softmax bit for
    bit."""
    rng = np.random.default_rng(13)
    q, k, v = _randn(rng, 4, 70, 32), _randn(rng, 2, 100, 32), \
        _randn(rng, 2, 100, 32)
    kw = dict(causal=causal, window=64, softcap=50.0, q_offset=130)
    got = ref.flash_attention_ref(q, k, v, **kw)
    assert bool((got[:, 163 - 130:] == 0).all())
    assert bool((got[:, :163 - 130].abs() > 0).any())
    want = pallas_attn(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                       jnp.asarray(v.numpy()), interpret=True, **kw)
    np.testing.assert_allclose(got[:, :163 - 130].numpy(),
                               np.asarray(want)[:, :163 - 130], atol=2e-5,
                               rtol=2e-5)
    # the rows that see a key: the softmax of the masked scores as it was
    s = torch.einsum("bgsd,btd->bgst",
                     q.reshape(2, 2, 70, 32) * (1.0 / math.sqrt(32)), k)
    s = 50.0 * torch.tanh(s / 50.0)
    rows = torch.arange(70)[:, None] + 130
    cols = torch.arange(100)[None, :]
    mask = cols > rows - 64
    if causal:
        mask &= cols <= rows
    s = torch.where(mask, s, torch.full((), ref.NEG_INF))
    old = torch.einsum("bgst,btd->bgsd", torch.softmax(s, -1), v)
    assert torch.equal(got[:, :163 - 130], old.reshape(4, 70, 32)[:,
                                                                  :33])
