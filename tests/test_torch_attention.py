"""The attention kernels' plain versions against the JAX package's.

``repro_torch.kernels.ref.flash_attention_ref`` / ``flash_decode_ref``
(and the ``ops`` wrappers, which fold the model layouts into the
kernels' and run the plain versions on CPU tensors) against
``repro.kernels.ops.flash_attention`` / ``flash_decode`` in Pallas
interpret mode and against ``repro.kernels.ref.flash_attention_ref``, on
the same numpy-seeded inputs. The CUDA wrappers take CUDA tensors only;
``tests/test_torch_cuda.py`` holds them against these plain versions on
the card. Tolerances: float32 atol = rtol = 2e-5 and bfloat16 2e-2, the
reference's own in ``FLASH_CASES`` (``tests/test_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_bkv
from repro_torch.kernels.flash_decode import flash_decode_bkv

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

FLASH_CASES = [
    # (b, s, h, kv, hd, window, softcap, dtype): the reference's sweep …
    (2, 256, 8, 4, 64, None, None, "float32"),
    (1, 128, 4, 4, 32, None, 50.0, "float32"),
    (2, 384, 6, 2, 64, 128, None, "float32"),
    (1, 512, 8, 1, 128, 256, 30.0, "float32"),
    (1, 256, 9, 3, 64, None, None, "float32"),
    (2, 256, 8, 4, 64, None, None, "bfloat16"),
    (1, 320, 4, 2, 64, 64, 50.0, "float32"),
    # … plus a ragged S (not a multiple of 128) with window and softcap,
    # GQA G = 2 and 4 at gemma2's hd 256, and bfloat16 with both masks.
    (1, 200, 4, 2, 256, 64, 50.0, "float32"),
    (2, 150, 8, 2, 32, 48, 30.0, "float32"),
    (1, 300, 8, 4, 256, 100, 50.0, "bfloat16"),
]


def _inputs(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a).astype(JNP[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs]
    return jx, tx


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("b,s,h,kv,hd,window,cap,dtype", FLASH_CASES)
def test_flash_attention_plain_matches_pallas(b, s, h, kv, hd, window, cap,
                                              dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)], dtype, 0)
    want = ref_ops.flash_attention(jq, jk, jv, causal=True, window=window,
                                   softcap=cap, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                              softcap=cap)
    assert got.dtype == TORCH[dtype] and got.shape == (b, s, h, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("bh,bkv,s,hd,window,cap", [
    (4, 2, 96, 16, None, None), (8, 2, 130, 64, 32, 50.0),
    (6, 3, 64, 32, None, 30.0)])
def test_flash_attention_ref_matches_reference_oracle(bh, bkv, s, hd, window,
                                                      cap):
    """Kernel layout, square q / kv: the port's oracle is the
    reference's ``ref.flash_attention_ref``."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(bh, s, hd), (bkv, s, hd), (bkv, s, hd)], "float32", 1)
    want = ref_ref.flash_attention_ref(jq, jk, jv, causal=True,
                                       window=window, softcap=cap)
    got = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window,
                                  softcap=cap)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


def test_flash_attention_ref_q_offset_is_the_bottom_rows():
    """Rectangular q: rows at ``q_offset`` equal the bottom rows of the
    square problem (what the Pallas kernel's ``q_offset`` means)."""
    _, (tq, tk, tv) = _inputs([(4, 100, 32), (2, 100, 32), (2, 100, 32)],
                              "float32", 2)
    full = ref.flash_attention_ref(tq, tk, tv, window=40, softcap=50.0)
    tail = ref.flash_attention_ref(tq[:, 70:].contiguous(), tk, tv,
                                   window=40, softcap=50.0, q_offset=70)
    torch.testing.assert_close(tail, full[:, 70:], atol=1e-6, rtol=1e-6)


DECODE_CASES = [
    # (b, kv, g, S, hd, pos, window, softcap, dtype)
    (2, 2, 2, 1024, 64, 100, None, 50.0, "float32"),    # inside block 0
    (2, 2, 2, 1024, 64, 900, 256, 50.0, "float32"),     # past the window
    (1, 4, 2, 1100, 32, 1099, 512, 30.0, "float32"),    # last partial block
    (2, 2, 4, 1100, 256, 1050, None, None, "float32"),  # G 4, hd 256
    (2, 4, 2, 1024, 64, 700, 300, 50.0, "bfloat16"),
]


@pytest.mark.parametrize("b,kv,g,S,hd,pos,window,cap,dtype", DECODE_CASES)
def test_flash_decode_plain_matches_pallas(b, kv, g, S, hd, pos, window, cap,
                                           dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, 1, kv * g, hd), (b, kv, S, hd), (b, kv, S, hd)], dtype, 3)
    want = ref_ops.flash_decode(jq, jk, jv, jnp.int32(pos), window=window,
                                softcap=cap, interpret=True)
    got = ops.flash_decode(tq, tk, tv, torch.tensor(pos, dtype=torch.int32),
                           window=window, softcap=cap)
    assert got.dtype == TORCH[dtype] and got.shape == (b, 1, kv * g, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_flash_decode_ref_is_the_last_row_of_attention():
    """One decode step at ``pos`` over a cache filled to ``pos`` equals
    row ``pos`` of causal attention over the first ``pos + 1`` keys."""
    _, (tq, tk, tv) = _inputs([(4, 60, 16), (2, 80, 16), (2, 80, 16)],
                              "float32", 4)
    pos = 59
    att = ref.flash_attention_ref(tq, tk[:, :60], tv[:, :60], window=20,
                                  softcap=50.0)
    dec = ref.flash_decode_ref(tq[:, pos].reshape(2, 2, 16), tk, tv, pos,
                               window=20, softcap=50.0)
    torch.testing.assert_close(dec.reshape(4, 16), att[:, pos], atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("fn,args", [
    (flash_attention_bkv, ((4, 8, 16), (2, 8, 16), (2, 8, 16))),
    (flash_decode_bkv, ((2, 2, 16), (2, 8, 16), (2, 8, 16), 3)),
])
def test_cuda_wrappers_take_cuda_tensors_only(fn, args):
    before = fn.launches
    tensors = [torch.zeros(a) if isinstance(a, tuple) else a for a in args]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*tensors)
    assert fn.launches == before

