"""The SSD scan's plain versions and the port's chunked path against the
JAX package's, on the CPU.

``repro_torch.kernels.ref.ssd_scan_bh_ref`` (the Pallas kernel's chunked
algorithm) and ``ref.ssd_ref`` (the token-by-token recurrence), the
``ops.ssd`` fold (which runs the plain version on CPU tensors) and
``models.mamba2.ssd_chunked(impl="torch")`` against
``repro.kernels.ssd_scan.ssd_scan_bh`` in Pallas interpret mode,
``repro.kernels.ref.ssd_ref``, ``repro.kernels.ops.ssd`` and
``repro.models.mamba2.ssd_chunked(impl="xla")``, on the same
numpy-seeded inputs scaled as the reference's tests scale them (x
0.5·randn, B / C 0.3·randn, a = -softplus(randn)). Shapes and
tolerances are the reference's ``SSD_CASES`` (``tests/test_kernels.py``):
atol = rtol = 5e-5 in float32 (1e-4 at its largest shape) and 3e-2 in
bfloat16. ``tests/test_torch_cuda.py`` holds the CUDA kernel against
these plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.ssd_scan import ssd_scan_bh as ref_ssd_scan_bh
from repro.models import mamba2 as ref_mamba2
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba2

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SSD_CASES = [
    # (b, l, h, g, p, n, chunk, dtype, tol): the reference's sweep
    (2, 256, 4, 1, 64, 32, 128, "float32", 5e-5),
    (1, 128, 8, 2, 32, 16, 64, "float32", 5e-5),
    (2, 512, 4, 1, 128, 64, 128, "float32", 1e-4),
    (1, 256, 4, 1, 64, 32, 128, "bfloat16", 3e-2),
]


def _softplus(v):
    return np.logaddexp(v, 0.0)


def _model_inputs(b, l, h, g, p, n, dtype, seed, a_scale=None):
    """Model layout (x (b,l,h,p), a (b,l,h), B/C (b,l,g,n)) as JAX and
    torch arrays. ``a_scale``: a = a_scale * dt with dt in [0.5, 1.5)
    (the strong-decay case) instead of -softplus(randn)."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((b, l, h, p))
    if a_scale is None:
        a = -_softplus(rng.standard_normal((b, l, h)))
    else:
        a = a_scale * (0.5 + rng.random((b, l, h)))
    B = 0.3 * rng.standard_normal((b, l, g, n))
    C = 0.3 * rng.standard_normal((b, l, g, n))
    arrs = [v.astype(np.float32) for v in (x, a, B, C)]
    dts = (dtype, "float32", dtype, dtype)
    jx = [jnp.asarray(v).astype(JNP[d]) for v, d in zip(arrs, dts)]
    tx = [torch.from_numpy(v).to(TORCH[d]) for v, d in zip(arrs, dts)]
    return jx, tx


def _fold(x, a, B, C):
    """Model layout → the kernel layout, as ``ops.ssd`` folds it."""
    b, l, h, p = x.shape
    rep = h // B.shape[2]
    n = B.shape[3]
    return (x.permute(0, 2, 1, 3).reshape(b * h, l, p),
            a.permute(0, 2, 1).reshape(b * h, l),
            torch.repeat_interleave(B, rep, 2).permute(0, 2, 1, 3)
            .reshape(b * h, l, n),
            torch.repeat_interleave(C, rep, 2).permute(0, 2, 1, 3)
            .reshape(b * h, l, n))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,l,h,g,p,n,chunk,dtype,tol", SSD_CASES)
def test_ssd_scan_bh_ref_matches_pallas_and_oracle(b, l, h, g, p, n, chunk,
                                                   dtype, tol):
    """Kernel layout: the chunked plain version against the Pallas kernel
    (interpret) and the reference's sequential oracle; the port's
    sequential oracle against the reference's."""
    _, tx = _model_inputs(b, l, h, g, p, n, dtype, 0)
    xf, af, Bf, Cf = _fold(*tx)
    jf = [jnp.asarray(_np(t)).astype(JNP[dtype] if t.dtype == torch.bfloat16
                                     else jnp.float32)
          for t in (xf, af, Bf, Cf)]
    want_y, want_s = ref_ssd_scan_bh(*jf, chunk=chunk, interpret=True)
    seq_y, seq_s = ref_ref.ssd_ref(*jf)
    got_y, got_s = ref.ssd_scan_bh_ref(xf, af, Bf, Cf, chunk=chunk)
    assert got_y.dtype == TORCH[dtype] and got_y.shape == (b * h, l, p)
    assert got_s.dtype == torch.float32 and got_s.shape == (b * h, p, n)
    for want in ((want_y, want_s), (seq_y, seq_s)):
        _close(got_y, want[0], tol)
        _close(got_s, want[1], tol)
    oy, os_ = ref.ssd_ref(xf, af, Bf, Cf)
    _close(oy, seq_y, tol)
    _close(os_, seq_s, tol)


@pytest.mark.parametrize("b,l,h,g,p,n,chunk,dtype,tol", SSD_CASES)
def test_ops_ssd_matches_reference_ops(b, l, h, g, p, n, chunk, dtype, tol):
    """Model layout: the port's ``ops.ssd`` (plain version on CPU
    tensors) against the reference's ``ops.ssd`` in interpret mode."""
    jx, tx = _model_inputs(b, l, h, g, p, n, dtype, 1)
    want_y, want_s = ref_ops.ssd(*jx, chunk=chunk, interpret=True)
    got_y, got_s = ops.ssd(*tx, chunk=chunk)
    assert got_y.dtype == TORCH[dtype] and got_y.shape == (b, l, h, p)
    assert got_s.dtype == torch.float32 and got_s.shape == (b, h, p, n)
    _close(got_y, want_y, tol)
    _close(got_s, want_s, tol)


def test_ops_ssd_with_initial_state():
    """The reference's ``test_ssd_kernel_with_initial_state`` shape:
    both folds carry s0, against the sequential oracle too."""
    b, l, h, g, p, n = 1, 128, 4, 1, 32, 16
    jx, tx = _model_inputs(b, l, h, g, p, n, "float32", 2)
    s0 = (0.3 * np.random.default_rng(3).standard_normal((b, h, p, n))
          ).astype(np.float32)
    want_y, want_s = ref_ops.ssd(*jx, init_state=jnp.asarray(s0), chunk=64,
                                 interpret=True)
    got_y, got_s = ops.ssd(*tx, init_state=torch.from_numpy(s0), chunk=64)
    _close(got_y, want_y, 5e-5)
    _close(got_s, want_s, 5e-5)
    seq_y, seq_s = ref.ssd_ref(*_fold(*tx), torch.from_numpy(s0)
                               .reshape(b * h, p, n))
    _close(got_y.permute(0, 2, 1, 3).reshape(b * h, l, p), seq_y, 5e-5)
    _close(got_s.reshape(b * h, p, n), seq_s, 5e-5)


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("b,l,h,g,p,n,chunk,dtype,tol", SSD_CASES)
def test_ssd_chunked_matches_reference_xla(b, l, h, g, p, n, chunk, dtype,
                                           tol, with_s0):
    """The model's plain chunked path (``impl="torch"``) against the
    reference's ``impl="xla"``, and ``impl="cuda"`` (here: the plain
    kernel version through ``ops.ssd``) against ``impl="pallas"``."""
    jx, tx = _model_inputs(b, l, h, g, p, n, dtype, 4)
    s0 = (0.3 * np.random.default_rng(5).standard_normal((b, h, p, n))
          ).astype(np.float32) if with_s0 else None
    js0 = None if s0 is None else jnp.asarray(s0)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    for ref_impl, impl in (("xla", "torch"), ("pallas", "cuda")):
        want_y, want_s = ref_mamba2.ssd_chunked(*jx, init_state=js0,
                                                chunk=chunk, impl=ref_impl)
        got_y, got_s = mamba2.ssd_chunked(*tx, init_state=ts0, chunk=chunk,
                                          impl=impl)
        assert got_y.dtype == TORCH[dtype] and got_s.dtype == torch.float32
        _close(got_y, want_y, tol)
        _close(got_s, want_s, tol)


def test_strong_decay_selects_the_mask():
    """a = -16 · dt with dt in [0.5, 1.5), mamba2's strongest head: the
    upper triangle's exp(a_cum_i - a_cum_j) overflows to inf, so a 0/1
    mask multiplied in gives NaN; the plain versions select 0 there and
    agree with the Pallas kernel and with the sequential recurrence."""
    b, l, h, g, p, n = 1, 256, 4, 1, 64, 32
    jx, tx = _model_inputs(b, l, h, g, p, n, "float32", 6, a_scale=-16.0)
    xf, af, Bf, Cf = _fold(*tx)
    a_cum = torch.cumsum(af[:, :128], -1)
    seg = torch.exp(a_cum[:, :, None] - a_cum[:, None, :])
    mask = torch.tril(torch.ones(128, 128))
    assert torch.isinf(seg).any() and torch.isnan(seg * mask).any()
    got_y, got_s = ref.ssd_scan_bh_ref(xf, af, Bf, Cf)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_s).all()
    seq_y, seq_s = ref.ssd_ref(xf, af, Bf, Cf)
    _close(got_y, seq_y, 5e-5)
    _close(got_s, seq_s, 5e-5)
    want_y, want_s = ref_ops.ssd(*jx, chunk=128, interpret=True)
    got_y, got_s = ops.ssd(*tx, chunk=128)
    _close(got_y, want_y, 5e-5)
    _close(got_s, want_s, 5e-5)
    y_xla, _ = ref_mamba2.ssd_chunked(*jx, impl="xla")
    y_torch, _ = mamba2.ssd_chunked(*tx, impl="torch")
    assert torch.isfinite(y_torch).all()
    _close(y_torch, y_xla, 5e-5)


def test_ragged_length_is_refused_where_the_reference_refuses():
    """``chunk = min(chunk, L)`` must divide L: L 200 with chunk 128 is
    refused by the reference (an assertion) and by every port path; L 96
    (one chunk of 96) is taken by both."""
    jx, tx = _model_inputs(1, 200, 2, 1, 16, 16, "float32", 7)
    with pytest.raises(AssertionError):
        ref_ops.ssd(*jx, chunk=128, interpret=True)
    with pytest.raises(AssertionError):
        ref_mamba2.ssd_chunked(*jx, impl="xla")
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ref.ssd_scan_bh_ref(*_fold(*tx), chunk=128)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ops.ssd(*tx, chunk=128)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        mamba2.ssd_chunked(*tx, impl="torch")
    jx, tx = _model_inputs(1, 96, 2, 1, 16, 16, "float32", 8)
    want_y, want_s = ref_ops.ssd(*jx, chunk=128, interpret=True)
    got_y, got_s = ops.ssd(*tx, chunk=128)
    _close(got_y, want_y, 5e-5)
    _close(got_s, want_s, 5e-5)
