"""The float32 flash-attention kernel's arithmetic, emulated on the CPU.

``csrc/flash_attention.cu`` runs float32 attention on the tensor cores
as 3 x TF32 (``tf32::flash_fwd_tf32``): every operand x is split into
two TF32 terms, big = tf32(x) and small = tf32(x − big) (TF32: 10
mantissa bits, rounded to nearest, ties away), and each product is
small·big + big·small + big·big. Q is scaled by 1/√hd in float32 before
the split; S = Q·Kᵀ is taken so per 32-key tile, big·big summed per 128
columns of the head dim and the two cross products apart, then added;
softcap, mask and the online softmax run in float32; O += P·V splits P
and V the same way.
``_tf32x3_attention`` repeats that in float32 PyTorch on numpy-seeded
inputs (products of TF32 values are exact in float32; the sums round in
float32, as the tensor cores' accumulators do; torch's exp and tanh
stand in for the special-function unit's, within about 1e-6 relative)
and must lie within the card's float32 gate (``KERNEL_TOL`` of
``chip_smoke.py``: |got − want| ≤ 1e-4, elementwise) of
``ref.flash_attention_ref`` and of the JAX package's Pallas kernel in
interpret mode. With one TF32 term per operand the same emulation must
miss the gate: the split is what holds it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bkv as pallas_bkv
from repro_torch.kernels import ref

GATE = 1e-4             # float32: atol (chip_smoke.KERNEL_TOL, rtol 0)
BK = 32                 # keys per tile, as in the kernel
CAP_Q_SCALE = 40.0      # scores past the softcap of 50 (chip_smoke.py)

CASES = [
    # (bh, bkv, s, hd, window, softcap, q_scale): hd 64 and gemma2's 256,
    # GQA G 1-4, ragged S (not a multiple of 32), windows and softcaps,
    # and scores that reach the cap.
    (8, 4, 256, 64, None, None, 1.0),
    (4, 2, 200, 64, 64, 50.0, 1.0),
    (4, 4, 130, 32, None, 30.0, 1.0),
    (4, 2, 150, 256, 48, 50.0, 1.0),
    (8, 2, 300, 256, None, 50.0, 1.0),
    (4, 1, 170, 16, 20, None, 1.0),
    (8, 4, 220, 256, 100, 50.0, CAP_Q_SCALE),
]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → TF32 (to nearest, ties away from zero; the low 13 bits
    of the float32 cleared), as ``cvt.rna.tf32.f32``."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def _product(eq, a, b, terms):
    if terms == 1:
        return torch.einsum(eq, tf32(a), tf32(b))
    (ab, al), (bb, bl) = split(a), split(b)
    return (torch.einsum(eq, al, bb) + torch.einsum(eq, ab, bl)) \
        + torch.einsum(eq, ab, bb)


def _scores(q, k, terms):
    """S = Q·Kᵀ as the kernel sums it: big·big per 128 head-dim columns,
    the blocks added in order, then the cross products' sum."""
    if terms == 1:
        return torch.einsum("bgsd,btd->bgst", tf32(q), tf32(k))
    (qb, ql), (kb, kl) = split(q), split(k)
    s = 0.0
    for c in range(0, q.shape[-1], 128):
        s = s + torch.einsum("bgsd,btd->bgst", qb[..., c:c + 128],
                             kb[..., c:c + 128])
    return s + (torch.einsum("bgsd,btd->bgst", ql, kb)
                + torch.einsum("bgsd,btd->bgst", qb, kl))


def _tf32x3_attention(q, k, v, *, window=None, softcap=None, terms=3):
    """The kernel's arithmetic, causal, q at position 0 (float32)."""
    bh, s, hd = q.shape
    bkv = k.shape[0]
    g = bh // bkv
    qs = q.reshape(bkv, g, s, hd) * (1.0 / math.sqrt(hd))
    rows = torch.arange(s)[:, None]
    m = torch.full((bkv, g, s), ref.NEG_INF)
    l = torch.zeros(bkv, g, s)
    acc = torch.zeros(bkv, g, s, hd)
    for kb in range(0, s, BK):
        kt, vt = k[:, kb:kb + BK], v[:, kb:kb + BK]
        x = _scores(qs, kt, terms)
        if softcap is not None:
            x = softcap * torch.tanh(x * (1.0 / softcap))
        cols = torch.arange(kb, kb + kt.shape[1])[None, :]
        ok = cols <= rows
        if window is not None:
            ok &= cols > rows - window
        x = torch.where(ok, x, torch.full((), ref.NEG_INF))
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(x - m_new[..., None])
        l = alpha * l + p.sum(-1)
        m = m_new
        acc = acc * alpha[..., None] + _product("bgst,btd->bgsd", p, vt,
                                                terms)
    inv = torch.where(m == ref.NEG_INF, 0.0, 1.0 / torch.clamp(l, min=1e-30))
    return (acc * inv[..., None]).reshape(bh, s, hd)


def _inputs(bh, bkv, s, hd, q_scale, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, s, hd))
                                .astype(np.float32)) for n in (bh, bkv, bkv))
    return q * q_scale, k, v


def _within_gate(got, want):
    return bool(((got - want).abs() <= GATE).all())


def test_tf32_rounding_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-3],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 1.0], dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got[:5], want)
    assert bool((got.view(torch.int32) & 0x1FFF == 0).all())
    big, small = split(x)
    assert bool(((big + small - x).abs() <= 2.0 ** -22 * x.abs()).all())


@pytest.mark.parametrize("bh,bkv,s,hd,window,cap,q_scale", CASES)
def test_tf32x3_emulation_holds_the_float32_gate(bh, bkv, s, hd, window,
                                                 cap, q_scale):
    q, k, v = _inputs(bh, bkv, s, hd, q_scale, seed=s + hd)
    got = _tf32x3_attention(q, k, v, window=window, softcap=cap)
    want = ref.flash_attention_ref(q, k, v, window=window, softcap=cap)
    assert got.dtype == torch.float32 and got.shape == (bh, s, hd)
    assert _within_gate(got, want)
    pallas = pallas_bkv(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                        causal=True, window=window, softcap=cap,
                        interpret=True)
    assert _within_gate(got, torch.from_numpy(np.array(pallas)))


@pytest.mark.parametrize("case", [CASES[0], CASES[4], CASES[6]])
def test_single_tf32_term_misses_the_float32_gate(case):
    """One TF32 term per operand (10 mantissa bits) moves scores by about
    1e-3 and P·V by about 2^-11 of each term: the output misses 1e-4,
    while the 3 x TF32 emulation of the same inputs holds it."""
    bh, bkv, s, hd, window, cap, q_scale = case
    q, k, v = _inputs(bh, bkv, s, hd, q_scale, seed=s + hd)
    want = ref.flash_attention_ref(q, k, v, window=window, softcap=cap)
    assert _within_gate(_tf32x3_attention(q, k, v, window=window,
                                          softcap=cap), want)
    assert not _within_gate(_tf32x3_attention(q, k, v, window=window,
                                              softcap=cap, terms=1), want)
