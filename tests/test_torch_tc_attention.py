"""The bfloat16 flash-attention kernel's arithmetic, emulated on the CPU.

``csrc/flash_attention.cu`` runs bfloat16 attention on the tensor cores
(``tc::flash_fwd_tc``): S = Q·Kᵀ from bf16 operands into float32, the
1/√hd scale on the float32 scores, softcap, mask and the online softmax
in float32 over 64-key tiles, and O += P·V with P split into two bf16
terms, P_hi = bf16(p) and P_lo = bf16(p − P_hi), each multiplied with the
bf16 V into float32. ``_tc_attention`` repeats that in float32 PyTorch
on numpy-seeded inputs (with torch's exp and tanh; the card takes them
from the special-function unit, within about 1e-6 relative), and must
lie within the card's bfloat16
gate (``KERNEL_TOL`` of ``chip_smoke.py``: |got − want| ≤ 1e-5 + 1e-2·
|want|, elementwise) of ``ref.flash_attention_ref`` and of the JAX
package's Pallas kernel in interpret mode. With a single bf16 P the same
emulation must fail the gate: the split is what holds it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bkv as pallas_bkv
from repro_torch.kernels import ref

GATE = (1e-5, 1e-2)     # bfloat16: atol, rtol (chip_smoke.KERNEL_TOL)
BK = 64                 # keys per tile, as in the kernel

CASES = [
    # (bh, bkv, s, hd, window, softcap): the windows and softcaps of the
    # attention tests' FLASH_CASES at hd 64 and gemma2's 256, GQA G 1-4,
    # ragged S (not a multiple of 64).
    (8, 4, 256, 64, None, None),
    (4, 2, 320, 64, 64, 50.0),
    (4, 4, 130, 64, None, 50.0),
    (4, 2, 200, 256, 64, 50.0),
    (8, 2, 300, 256, 100, 50.0),
    (4, 1, 320, 256, 128, 30.0),
]


def _bf16_inputs(bh, bkv, s, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((n, s, hd))
                             .astype(np.float32)).to(torch.bfloat16)
            for n in (bh, bkv, bkv)]


def _tc_attention(q, k, v, *, window=None, softcap=None, split=True):
    """The tensor-core kernel's arithmetic in float32 (causal, q at
    position 0): q, k, v bfloat16; returns bfloat16."""
    bh, s, hd = q.shape
    g = bh // k.shape[0]
    qf = q.float().reshape(k.shape[0], g, s, hd)
    kf, vf = k.float(), v.float()
    rows = torch.arange(s)[:, None]
    m = torch.full((k.shape[0], g, s), ref.NEG_INF)
    l = torch.zeros(k.shape[0], g, s)
    acc = torch.zeros(k.shape[0], g, s, hd)
    for kb in range(0, s, BK):
        kt, vt = kf[:, kb:kb + BK], vf[:, kb:kb + BK]
        x = torch.einsum("bgsd,btd->bgst", qf, kt) * (1.0 / math.sqrt(hd))
        if softcap is not None:
            x = softcap * torch.tanh(x / softcap)
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
        p_hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bgst,btd->bgsd", p_hi, vt)
        if split:
            p_lo = (p - p_hi).to(torch.bfloat16).float()
            pv = pv + torch.einsum("bgst,btd->bgsd", p_lo, vt)
        acc = acc * alpha[..., None] + pv
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(bh, s, hd).to(torch.bfloat16)


def _within_gate(got, want):
    atol, rtol = GATE
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


@pytest.mark.parametrize("bh,bkv,s,hd,window,cap", CASES)
def test_split_p_emulation_holds_the_bf16_gate(bh, bkv, s, hd, window, cap):
    q, k, v = _bf16_inputs(bh, bkv, s, hd, seed=s + hd)
    got = _tc_attention(q, k, v, window=window, softcap=cap)
    want = ref.flash_attention_ref(q, k, v, window=window, softcap=cap)
    assert got.dtype == torch.bfloat16 and got.shape == (bh, s, hd)
    assert _within_gate(got, want)
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                  for x in (q, k, v))
    pallas = pallas_bkv(jq, jk, jv, causal=True, window=window, softcap=cap,
                        interpret=True)
    assert _within_gate(got, torch.tensor(
        np.asarray(pallas.astype(jnp.float32))))


@pytest.mark.parametrize("bh,bkv,s,hd,window,cap", [CASES[1], CASES[4]])
def test_single_bf16_p_misses_the_bf16_gate(bh, bkv, s, hd, window, cap):
    """One bf16 P carries 2^-9 into every term of P·V: outputs near 0
    then miss atol 1e-5, while the split emulation of the same inputs
    holds the gate."""
    q, k, v = _bf16_inputs(bh, bkv, s, hd, seed=s + hd)
    want = ref.flash_attention_ref(q, k, v, window=window, softcap=cap)
    assert _within_gate(_tc_attention(q, k, v, window=window, softcap=cap),
                        want)
    assert not _within_gate(_tc_attention(q, k, v, window=window,
                                          softcap=cap, split=False), want)
