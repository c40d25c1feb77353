"""The SSD scan kernel's tensor-core arithmetic, emulated on the CPU.

``csrc/ssd_scan.cu`` runs each chunk's four products on the tensor
cores, in one launch that hands the float32 state from chunk to chunk.

bfloat16 (``bf::ssd_bf16``): C·Bᵀ from the bf16 operands into float32
(one term: the products are exact); L selected (never multiplied) in the
accumulator; (C·Bᵀ∘L), x∘w and the state S, the three float32 operands,
each split into two bf16 terms, hi = bf16(v) and lo = bf16(v − hi):
(C·Bᵀ∘L)·x = M_hi·x + M_lo·x, the contribution (x∘w)ᵀ·B = (x∘w)_hiᵀ·B +
(x∘w)_loᵀ·B, and C·Sᵀ = C·S_hiᵀ + C·S_loᵀ; y = (C·Bᵀ∘L)·x + exp(a_cum)∘
(C·Sᵀ) rounded once to bf16; the next chunk's start state S·exp(total) +
contribution in float32.

float32 (``tf::ssd_tf32``): 3 × TF32 on every product, each operand
split into big = tf32(v) and small = tf32(v − big) (to nearest, ties
away: ``cvt.rna.tf32.f32``), each product small·big + big·small +
big·big with the two cross products summed apart from big·big and added
after (the kernel adds them on the CUDA cores, since the tensor cores'
float32 sums truncate). The contribution is taken transposed, Bᵀ·(x∘w),
with x∘w made from the staged x as big + small (x within 2^-22).

``_bf16_scan`` and ``_tf32_scan`` repeat that chunk by chunk in float32
PyTorch (products of bf16 or TF32 values are exact in float32; the sums
round to nearest, where the card's truncate) on numpy-seeded inputs, and
must lie within the card's gates (``SSD_TOL`` / ``SSD_STATE_TOL`` of
``chip_smoke.py``: y 1e-4 + 1e-2·|want| in bfloat16, 1e-4 + 1e-4·|want|
in float32, the float32 state 1e-4 + 1e-4·|want|, elementwise) of
``ref.ssd_scan_bh_ref`` and of the JAX package's Pallas kernel in
interpret mode: on the reference's ``SSD_CASES`` folded to the kernel
layout, on mamba2-130m's widths (P 64, N 128, chunk 128) at small BH
with a start state, and on the strongest decay. Each split is needed:
with one term fewer on any product the kernel splits, the same emulation
misses a gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan_bh as pallas_ssd
from repro_torch.kernels import ref

Y_TOL = {torch.bfloat16: (1e-4, 1e-2), torch.float32: (1e-4, 1e-4)}
STATE_TOL = (1e-4, 1e-4)
DTYPES = [torch.bfloat16, torch.float32]

CASES = [
    # (bh, l, p, n, chunk, with_s0, a_scale): the reference's SSD_CASES
    # folded (b·h, l, p, n, chunk), mamba2-130m's widths with a start
    # state, and the strongest decay (a = -16·dt, dt in [0.5, 1.5)).
    (8, 256, 64, 32, 128, False, None),
    (8, 128, 32, 16, 64, True, None),
    (8, 512, 128, 64, 128, False, None),
    (4, 256, 64, 32, 128, False, None),
    (4, 512, 64, 128, 128, True, None),
    (4, 256, 64, 128, 128, False, -16.0),
]
MAMBA = CASES[4]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → TF32 (to nearest, ties away from zero; the low 13 bits
    of the float32 cleared), as ``cvt.rna.tf32.f32``."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _split(x: torch.Tensor, rnd):
    hi = rnd(x)
    return hi, rnd(x - hi)


def _two_bf16(a: torch.Tensor, b: torch.Tensor, keep_lo=True):
    """a·b with a split into two bf16 terms (b is bf16 already)."""
    hi, lo = _split(a, _bf16)
    return hi @ b + (lo @ b if keep_lo else 0.0)


def _tf32x3(a: torch.Tensor, b: torch.Tensor, drop=None):
    """a·b as 3 × TF32: the cross products (small·big, big·small) summed
    apart from big·big. ``drop`` "a" leaves out small_a·big_b, "b"
    big_a·small_b."""
    (ab, asm), (bb, bs) = _split(a, tf32), _split(b, tf32)
    cross = 0.0
    if drop != "a":
        cross = cross + asm @ bb
    if drop != "b":
        cross = cross + ab @ bs
    return ab @ bb + cross


def _chunks(x, a, B, C, s0, chunk):
    bh, l, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, l)
    state = torch.zeros(bh, p, n) if s0 is None else s0.clone()
    idx = torch.arange(chunk)
    lower = idx[:, None] >= idx[None, :]
    for c0 in range(0, l, chunk):
        a_cum = torch.cumsum(a[:, c0:c0 + chunk].float(), -1)
        yield (state, x[:, c0:c0 + chunk].float(), B[:, c0:c0 + chunk].float(),
               C[:, c0:c0 + chunk].float(), a_cum, lower)


def _masked(cb, a_cum, lower):
    """C·Bᵀ∘L with the upper triangle selected, never multiplied."""
    return torch.where(lower, cb * torch.exp(a_cum[:, :, None]
                                             - a_cum[:, None, :]), 0.0)


def _bf16_scan(x, a, B, C, s0=None, chunk=128, single=None):
    """The bfloat16 kernel's arithmetic. ``single`` names the float32
    operand ("m", "xw" or "s") kept as one bf16 term."""
    ys, state = [], None
    for state0, xc, Bc, Cc, a_cum, lower in _chunks(x, a, B, C, s0, chunk):
        state = state0 if state is None else state
        total = a_cum[:, -1:]
        m = _masked(Cc @ Bc.transpose(1, 2), a_cum, lower)
        y_diag = _two_bf16(m, xc, single != "m")
        xw = xc * torch.exp(total - a_cum)[:, :, None]
        contrib = _two_bf16(xw.transpose(1, 2), Bc, single != "xw")
        y_off = Cc @ _bf16(state).transpose(1, 2)
        if single != "s":
            y_off = y_off + Cc @ _bf16(state - _bf16(state)).transpose(1, 2)
        ys.append(y_diag + torch.exp(a_cum)[:, :, None] * y_off)
        state = state * torch.exp(total)[:, :, None] + contrib
    return torch.cat(ys, 1).to(torch.bfloat16), state


def _tf32_scan(x, a, B, C, s0=None, chunk=128, drop=None):
    """The float32 kernel's arithmetic. ``drop`` = (product, side): the
    product ("cb", "yd", "dl" or "yo") that leaves one cross term out."""
    prod, side = drop or (None, None)
    d = {k: (side if k == prod else None) for k in ("cb", "yd", "dl", "yo")}
    ys, state = [], None
    for state0, xc, Bc, Cc, a_cum, lower in _chunks(x, a, B, C, s0, chunk):
        state = state0 if state is None else state
        total = a_cum[:, -1:]
        m = _masked(_tf32x3(Cc, Bc.transpose(1, 2), d["cb"]), a_cum, lower)
        y_diag = _tf32x3(m, xc, d["yd"])
        # x o w from the staged x^T, read back as big + small
        xw = sum(_split(xc, tf32)) * torch.exp(total - a_cum)[:, :, None]
        contrib = _tf32x3(Bc.transpose(1, 2), xw, d["dl"]).transpose(1, 2)
        y_off = _tf32x3(Cc, state.transpose(1, 2), d["yo"])
        ys.append(y_diag + torch.exp(a_cum)[:, :, None] * y_off)
        state = state * torch.exp(total)[:, :, None] + contrib
    return torch.cat(ys, 1), state


def _inputs(bh, l, p, n, dtype, with_s0, a_scale, seed):
    """x 0.5·randn, B / C 0.3·randn, a = -softplus(randn) (or a_scale·dt),
    s0 0.3·randn, as the reference's tests and chip_smoke.py scale them."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((bh, l, p))
    a = -np.logaddexp(rng.standard_normal((bh, l)), 0.0) if a_scale is None \
        else a_scale * (0.5 + rng.random((bh, l)))
    B = 0.3 * rng.standard_normal((bh, l, n))
    C = 0.3 * rng.standard_normal((bh, l, n))
    s0 = 0.3 * rng.standard_normal((bh, p, n)) if with_s0 else None
    t = lambda v: torch.from_numpy(v.astype(np.float32))
    return (t(x).to(dtype), t(a), t(B).to(dtype), t(C).to(dtype),
            None if s0 is None else t(s0))


def _emulate(dtype, *args, **kw):
    return (_bf16_scan if dtype == torch.bfloat16 else _tf32_scan)(*args,
                                                                   **kw)


def _within(got, want, tol):
    atol, rtol = tol
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


def _holds(dtype, got, want):
    """y within the dtype's gate and the float32 state within its own."""
    return _within(got[0], want[0], Y_TOL[dtype]) and \
        _within(got[1], want[1], STATE_TOL)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 1.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    big, small = _split(x * 3.7, tf32)
    assert bool(((big + small - x * 3.7).abs()
                 <= 2.0 ** -22 * (x * 3.7).abs()).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,l,p,n,chunk,with_s0,a_scale", CASES)
def test_emulated_kernel_holds_the_gates(bh, l, p, n, chunk, with_s0,
                                         a_scale, dtype):
    x, a, B, C, s0 = _inputs(bh, l, p, n, dtype, with_s0, a_scale,
                             seed=l + n)
    got = _emulate(dtype, x, a, B, C, s0, chunk)
    assert got[0].dtype == dtype and got[0].shape == (bh, l, p)
    assert got[1].dtype == torch.float32 and got[1].shape == (bh, p, n)
    assert bool(torch.isfinite(got[0].float()).all())
    assert _holds(dtype, got, ref.ssd_scan_bh_ref(x, a, B, C, s0=s0,
                                                   chunk=chunk))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    pallas = pallas_ssd(*(jnp.asarray(t.float().numpy()).astype(d)
                          for t, d in ((x, jdt), (a, jnp.float32),
                                       (B, jdt), (C, jdt))),
                        s0=None if s0 is None else jnp.asarray(s0.numpy()),
                        chunk=chunk, interpret=True)
    assert _holds(dtype, got, [torch.from_numpy(np.array(v, np.float32))
                               for v in pallas])


@pytest.mark.parametrize("single", ["m", "xw", "s"])
def test_one_bf16_term_misses_the_gates(single):
    """One bf16 term for C·Bᵀ∘L, for x∘w or for S (each carries 2^-9 of
    its value into every product): the emulation misses a gate that the
    split holds."""
    bh, l, p, n, chunk, with_s0, a_scale = MAMBA
    x, a, B, C, s0 = _inputs(bh, l, p, n, torch.bfloat16, with_s0, a_scale,
                             seed=l + n)
    want = ref.ssd_scan_bh_ref(x, a, B, C, s0=s0, chunk=chunk)
    assert _holds(torch.bfloat16, _bf16_scan(x, a, B, C, s0, chunk), want)
    assert not _holds(torch.bfloat16,
                      _bf16_scan(x, a, B, C, s0, chunk, single=single), want)


@pytest.mark.parametrize("side", ["a", "b"])
@pytest.mark.parametrize("prod", ["cb", "yd", "dl", "yo"])
def test_two_tf32_terms_miss_the_float32_gates(prod, side):
    """3 × TF32 less one cross term (one operand of the product kept at
    TF32's 10 mantissa bits) on any of the four products misses the
    float32 gates that the three terms hold."""
    bh, l, p, n, chunk, with_s0, a_scale = MAMBA
    x, a, B, C, s0 = _inputs(bh, l, p, n, torch.float32, with_s0, a_scale,
                             seed=l + n)
    want = ref.ssd_scan_bh_ref(x, a, B, C, s0=s0, chunk=chunk)
    assert _holds(torch.float32, _tf32_scan(x, a, B, C, s0, chunk), want)
    assert not _holds(torch.float32, _tf32_scan(x, a, B, C, s0, chunk,
                                                drop=(prod, side)), want)
