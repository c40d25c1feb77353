"""The CUDA kernels against their plain versions, on the card.

Runs only where ``torch.cuda.is_available()`` (the check is made inside
each test): there the wrappers build their ``csrc/*.cu`` sources with
nvcc and launch them. The round step's state after every chunk must
equal ``chunk_step_ref`` on the same CUDA tensors, exactly except the
three time integrals (rtol 1e-5 float32, 1e-6 float64); the flash
attention and flash decode kernels must match ``kernels.ref`` (see the
tolerances below), and a reduced model's kernel path its plain path.
``python3 chip_smoke.py`` drives the same comparisons at full size.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import round_step as rsk
from repro_torch.sim import rounds, traces
from repro_torch.sim.sweep import ScanOptions, _pack_rounds, paper_grid

DAY = 24 * 3600.0
INTEGRALS = [rsk.SC_ACC0 + rounds.ACC_KEYS.index(k)
             for k in ("turn_sum", "exec_sum", "node_seconds")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("policy", ["fb", "flb_nub"])
def test_kernel_equals_plain_after_every_chunk_on_the_card(policy, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    horizon = 2 * DAY
    jobs = [j for j in traces.nasa_ipsc(seed=0) if j.submit < horizon]
    ws = [(t, d) for t, d in traces.worldcup98(seed=0, peak_vms=128)
          if t < horizon]
    points = [p for p in paper_grid(128) if p.system == policy]
    opts = ScanOptions(dtype=np.float64 if dtype == torch.float64 else None)
    (_, _, fb, flb, fb_packs, flb_packs, fb_spec, flb_spec) = _pack_rounds(
        points, [(jobs, ws)], horizon, opts, dev)
    grid, pk, spec = ((fb, fb_packs[0], fb_spec) if policy == "fb"
                      else (flb, flb_packs[0], flb_spec))
    prm = rounds._rounds_prm_tree(policy, grid, 1)
    ctx = rounds._lane_ctx(policy, prm, pk)
    sc, win = rounds._startup(policy, ctx, spec, pk.ws0[prm["w_idx"]])
    inputs = rsk.lane_inputs(policy, ctx)
    before = rsk.chunk_step.launches
    chunks = 0
    while bool((sc[:, rsk.SC_T] < horizon).any()):
        got = rsk.chunk_step(*inputs, sc, win, policy=policy, spec=spec)
        want = rsk.chunk_step_ref(*inputs, sc, win, policy=policy,
                                  spec=spec)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]), chunks
        exact = [i for i in range(rsk.SC_SIZE) if i not in INTEGRALS]
        assert torch.equal(got[0][:, exact], want[0][:, exact]), chunks
        torch.testing.assert_close(
            got[0][:, INTEGRALS], want[0][:, INTEGRALS], atol=0,
            rtol=1e-5 if dtype == torch.float32 else 1e-6)
        live = sc[:, rsk.SC_T] < horizon
        sc = torch.where(live[:, None], want[0], sc)
        win = torch.where(live[:, None, None], want[1], win)
        chunks += 1
    assert rsk.chunk_step.launches - before == chunks > 20


# ------------------------------------------- attention kernels on the card
#
# Both CUDA kernels against their plain versions on the same CUDA
# tensors: the CPU tests' shapes plus gemma2-2b's full width (8 heads /
# 4 kv, hd 256, window 4096, softcap 50). Tolerance (atol, rtol), the
# same as chip_smoke.py's: float32 1e-4, 0 (the kernels sum in another
# order than the plain einsums, over up to 8192 keys); bfloat16 1e-5,
# 1e-2 (both compute in float32 and round the output once: they differ
# by at most one bfloat16 ulp, 2^-7 of the value).

ATTN_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-5, 1e-2)}
# q scaled so the scores reach the softcap (about N(0, 40^2) before a cap
# of 50): there the plain version without the cap fails the tolerance.
CAP_Q_SCALE = 40.0
ATTN_CASES = [
    # (bh, bkv, s, hd, window, softcap)
    (16, 8, 256, 64, None, None), (4, 4, 128, 32, None, 50.0),
    (12, 4, 384, 64, 128, None), (8, 1, 512, 128, 256, 30.0),
    (9, 3, 256, 64, None, None), (4, 2, 320, 64, 64, 50.0),
    (4, 2, 200, 256, 64, 50.0), (8, 4, 80, 16, 64, 50.0),
    (8, 4, 4600, 256, 4096, 50.0),      # gemma2-2b, ragged S
]
DECODE_CASES = [
    # (bkv, g, S, hd, pos, window, softcap)
    (4, 2, 1024, 64, 100, None, 50.0), (4, 2, 1024, 64, 900, 256, 50.0),
    (4, 2, 1100, 32, 1099, 512, 30.0), (4, 4, 1100, 256, 1050, None, None),
    (4, 2, 88, 16, 80, 64, 50.0), (6, 3, 40, 64, 23, None, None),
    (32, 2, 8192, 256, 6000, 4096, 50.0),   # gemma2-2b, batch 8
]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,bkv,s,hd,window,cap", ATTN_CASES)
def test_flash_attention_kernel_equals_plain_on_the_card(bh, bkv, s, hd,
                                                         window, cap, dtype):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bkv
    dev = _cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(n, s, hd, generator=gen, device=dev).to(dtype)
               for n in (bh, bkv, bkv))
    before = flash_attention_bkv.launches
    got = flash_attention_bkv(q, k, v, window=window, softcap=cap)
    want = ref.flash_attention_ref(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert flash_attention_bkv.launches == before + 1
    atol, rtol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    # A rectangular q at an offset: the bottom rows of the same problem.
    tail = flash_attention_bkv(q[:, s // 2:].contiguous(), k, v,
                               window=window, softcap=cap, q_offset=s // 2)
    torch.testing.assert_close(tail.float(), want[:, s // 2:].float(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("bkv,g,s,hd,pos,window,cap", DECODE_CASES)
def test_flash_decode_kernel_equals_plain_on_the_card(bkv, g, s, hd, pos,
                                                      window, cap, dtypes):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode_bkv
    dev = _cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(bkv, g, hd, generator=gen, device=dev).to(dtypes[0])
    k, v = (torch.randn(bkv, s, hd, generator=gen, device=dev).to(dtypes[1])
            for _ in range(2))
    at = torch.tensor(pos, dtype=torch.int32, device=dev)
    before = flash_decode_bkv.launches
    got = flash_decode_bkv(q, k, v, at, window=window, softcap=cap)
    want = ref.flash_decode_ref(q, k, v, at, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert flash_decode_bkv.launches == before + 1
    atol, rtol = ATTN_TOL[dtypes[0]]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _close(got, want, dtype):
    atol, rtol = ATTN_TOL[dtype]
    return bool(((got.float() - want.float()).abs()
                 <= atol + rtol * want.float().abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["flash_attention", "flash_decode"])
def test_softcap_that_bites_on_the_card(kernel, dtype):
    """gemma2-2b's width with scores past the cap of 50: the kernel
    matches the plain version with the cap and not the one without."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bkv
    from repro_torch.kernels.flash_decode import flash_decode_bkv
    dev = _cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(3)
    if kernel == "flash_attention":
        q_shape, kv_shape, extra = (8, 1200, 256), (4, 1200, 256), ()
        run, plain = flash_attention_bkv, ref.flash_attention_ref
    else:
        q_shape, kv_shape = (8, 2, 256), (8, 2048, 256)
        extra = (torch.tensor(1500, dtype=torch.int32, device=dev),)
        run, plain = flash_decode_bkv, ref.flash_decode_ref
    q = (torch.randn(*q_shape, generator=gen, device=dev)
         * CAP_Q_SCALE).to(dtype)
    k, v = (torch.randn(*kv_shape, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    got = run(q, k, v, *extra, window=1024, softcap=50.0)
    assert _close(got, plain(q, k, v, *extra, window=1024, softcap=50.0),
                  dtype)
    assert not _close(got, plain(q, k, v, *extra, window=1024), dtype)


@pytest.mark.parametrize("arch", ["gemma2_2b", "smollm_135m",
                                  "mamba2_130m"])
def test_model_kernel_path_equals_plain_path_on_the_card(arch):
    """Reduced model: prefill and a scalar-position decode through the
    kernels (impl="cuda": both attention kernels, or the SSD scan)
    against the plain path (impl="torch"), float32 (the models' own
    tolerance, atol 5e-5 / rtol 5e-4, widened to 1e-4 for the kernels'
    summation order)."""
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models.transformer import Model
    dev = _cuda_or_skip()
    cfg = reduced_config(get_config(arch))
    model = Model(cfg, dev, compute_dtype=torch.float32).init(0)
    assert model.impl == "cuda"
    toks = torch.randint(0, cfg.vocab, (2, 81), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    outs = []
    for m in (model, model.with_impl("torch")):
        cache = m.init_cache(2, 96, dtype=torch.float32)
        lg0, cache = m.prefill({"tokens": toks[:, :80]}, cache)
        lg1, _ = m.decode(toks[:, 80:], cache,
                          torch.tensor(80, device=dev))
        outs.append((lg0, lg1))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=5e-4)


# ------------------------------------------------ the SSD scan on the card
#
# ssd_scan_bh against ssd_scan_bh_ref on the same CUDA tensors: the CPU
# tests' shapes (the reference's SSD_CASES, folded to the kernel layout),
# the reduced model's, and mamba2-130m's full width (24 heads, P 64, N
# 128, chunk 128). Tolerance, elementwise atol + rtol * |want|, the same
# as chip_smoke.py's: float32 1e-4 + 1e-4 (the reference's own for its
# largest SSD case; the kernel sums in another order); bfloat16 y 1e-4 +
# 1e-2 (both compute in float32 and round once: the float32 atol, which
# near y = 0 exceeds a bfloat16 ulp of y, plus one bfloat16 ulp), the
# float32 final state 1e-4 + 1e-4.

SSD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-4, 1e-2)}
STATE_TOL = (1e-4, 1e-4)
SSD_CASES = [
    # (bh, l, p, n, chunk)
    (8, 256, 64, 32, 128), (8, 128, 32, 16, 64), (8, 512, 128, 64, 128),
    (4, 256, 64, 32, 128), (16, 24, 16, 16, 128),   # reduced mamba2
    (24, 1024, 64, 128, 128),                       # mamba2-130m, batch 1
]


def _ssd_inputs(bh, l, p, n, dtype, dev, seed, with_s0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x = (0.5 * randn(bh, l, p)).to(dtype)
    a = -torch.nn.functional.softplus(randn(bh, l))
    B, C = ((0.3 * randn(bh, l, n)).to(dtype) for _ in range(2))
    s0 = 0.3 * randn(bh, p, n) if with_s0 else None
    return x, a, B, C, s0


def _within(got, want, atol, rtol):
    return bool(((got.float() - want.float()).abs()
                 <= atol + rtol * want.float().abs()).all())


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,l,p,n,chunk", SSD_CASES)
def test_ssd_scan_kernel_equals_plain_on_the_card(bh, l, p, n, chunk, dtype,
                                                  with_s0):
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bh
    dev = _cuda_or_skip()
    x, a, B, C, s0 = _ssd_inputs(bh, l, p, n, dtype, dev, 4, with_s0)
    before = ssd_scan_bh.launches
    y, sT = ssd_scan_bh(x, a, B, C, s0=s0, chunk=chunk)
    want_y, want_s = ref.ssd_scan_bh_ref(x, a, B, C, s0=s0, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan_bh.launches == before + 1
    assert y.dtype == dtype and sT.dtype == torch.float32
    assert _within(y, want_y, *SSD_TOL[dtype])
    assert _within(sT, want_s, *STATE_TOL)


def test_ssd_scan_kernel_strong_decay_on_the_card():
    """a = -16 · dt, dt in [0.5, 1.5): the upper triangle's exponents
    overflow; the kernel selects 0 there (finite, equal to the plain
    version and to the token-by-token recurrence)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bh
    dev = _cuda_or_skip()
    x, _, B, C, _ = _ssd_inputs(24, 512, 64, 128, torch.float32, dev, 5,
                                False)
    gen = torch.Generator(device=dev).manual_seed(6)
    a = -16.0 * (0.5 + torch.rand(24, 512, generator=gen, device=dev))
    y, sT = ssd_scan_bh(x, a, B, C)
    assert torch.isfinite(y).all() and torch.isfinite(sT).all()
    for want_y, want_s in (ref.ssd_scan_bh_ref(x, a, B, C),
                           ref.ssd_ref(x, a, B, C)):
        assert _within(y, want_y, *SSD_TOL[torch.float32])
        assert _within(sT, want_s, *STATE_TOL)


def test_ssd_scan_wrapper_takes_cuda_tensors_only():
    from repro_torch.kernels.ssd_scan import ssd_scan_bh
    before = ssd_scan_bh.launches
    x, B = torch.zeros(2, 16, 8), torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan_bh(x, torch.zeros(2, 16), B, B)
    assert ssd_scan_bh.launches == before
