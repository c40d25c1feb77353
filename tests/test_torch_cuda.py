"""The CUDA kernels against their plain versions, on the card.

Runs only where ``torch.cuda.is_available()`` (the check is made inside
each test): there the wrappers build their ``csrc/*.cu`` sources with
nvcc and launch them. The round step's state after every chunk must
equal ``chunk_step_ref`` on the same CUDA tensors, exactly except the
three time integrals (rtol 1e-5 float32, 1e-6 float64), with the
contended-stretch coalescer off and on (batch 1 and 8), and the
one-launch loop (``run_rounds``) must equal the per-chunk kernel path
bit for bit; the flash
attention and flash decode kernels must match ``kernels.ref`` (see the
tolerances below), and a reduced model's kernel path its plain path.
``python3 chip_smoke.py`` drives the same comparisons at full size.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.jobs import Job
from repro_torch.kernels import round_step as rsk
from repro_torch.kernels.cudalib import stream_zeroed_ints
from repro_torch.sim import rounds, traces
from repro_torch.sim.scan import FBGrid
from repro_torch.sim.sweep import ScanOptions, _pack_rounds, paper_grid

DAY = 24 * 3600.0
INTEGRALS = [rsk.SC_ACC0 + rounds.ACC_KEYS.index(k)
             for k in ("turn_sum", "exec_sum", "node_seconds")]
COALESCED = rsk.SC_ACC0 + rounds.ACC_KEYS.index("coalesced")


def _step_against_plain(policy, grid, pk, spec, horizon):
    """Run the lanes chunk by chunk from the engine's startup state: at
    every chunk the kernel and the plain version start from the same
    state and must agree (exact except the three integrals); the plain
    result carries on for the live lanes. Returns the per-chunk states
    before and after."""
    prm = rounds._rounds_prm_tree(policy, grid, 1)
    ctx = rounds._lane_ctx(policy, prm, pk)
    sc, win = rounds._startup(policy, ctx, spec, pk.ws0[prm["w_idx"]])
    inputs = rsk.lane_inputs(policy, ctx)
    before = rsk.chunk_step.launches
    exact = [i for i in range(rsk.SC_SIZE) if i not in INTEGRALS]
    steps = []
    while bool((sc[:, rsk.SC_T] < horizon).any()):
        assert len(steps) < 4096, "lanes never reached the horizon"
        got = rsk.chunk_step(*inputs, sc, win, policy=policy, spec=spec)
        want = rsk.chunk_step_ref(*inputs, sc, win, policy=policy,
                                  spec=spec)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]), len(steps)
        assert torch.equal(got[0][:, exact], want[0][:, exact]), len(steps)
        torch.testing.assert_close(
            got[0][:, INTEGRALS], want[0][:, INTEGRALS], atol=0,
            rtol=1e-5 if sc.dtype == torch.float32 else 1e-6)
        live = sc[:, rsk.SC_T] < horizon
        sc_n = torch.where(live[:, None], want[0], sc)
        win = torch.where(live[:, None, None], want[1], win)
        steps.append((sc, sc_n))
        sc = sc_n
    assert rsk.chunk_step.launches - before == len(steps)
    return steps


@pytest.mark.parametrize("batch", [1, rounds.COALESCE_BATCH])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("policy", ["fb", "flb_nub"])
def test_kernel_equals_plain_after_every_chunk_on_the_card(policy, dtype,
                                                           batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    horizon = 2 * DAY
    jobs = [j for j in traces.nasa_ipsc(seed=0) if j.submit < horizon]
    ws = [(t, d) for t, d in traces.worldcup98(seed=0, peak_vms=128)
          if t < horizon]
    points = [p for p in paper_grid(128) if p.system == policy]
    opts = ScanOptions(dtype=np.float64 if dtype == torch.float64 else None,
                       coalesce=batch)
    (_, _, fb, flb, fb_packs, flb_packs, fb_spec, flb_spec) = _pack_rounds(
        points, [(jobs, ws)], horizon, opts, dev)
    grid, pk, spec = ((fb, fb_packs[0], fb_spec) if policy == "fb"
                      else (flb, flb_packs[0], flb_spec))
    assert spec.batch == batch
    steps = _step_against_plain(policy, grid, pk, spec, horizon)
    assert len(steps) > 20
    coalesced = steps[-1][1][:, COALESCED]
    assert bool((coalesced > 0).any()) == (batch > 1)


def test_coalescer_defers_at_theta_on_the_card():
    """The reference's crafted all-contended trace (its coalescer
    regression, tests/test_engine_differential.py), rebuilt from numpy:
    16 nodes, 6 generations of 16 unit jobs of 1000 s all submitted at 0,
    no WS demand, one lease longer than the horizon. One round per launch
    (compact_every = 1), so each launch shows one round: the kernel
    equals the plain version after each, coalesces completions, and ends
    a coalesced round at the divergence instant (the chain end of the
    generation it started), short of the horizon it had without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    C, gens, rt = 16, 6, 1000.0
    n = C * gens
    submit, size, runtime = np.zeros(n), np.ones(n, int), np.full(n, rt)
    jobs = [Job(i, float(s), size=int(z), runtime=float(r))
            for i, (s, z, r) in enumerate(zip(submit, size, runtime))]
    duration = gens * rt + 500.0
    lease = 10 * duration
    for dtype in (torch.float32, torch.float64):
        f = np.float64 if dtype == torch.float64 else np.float32
        spec = rounds.RoundsSpec(duration=duration, max_rounds=64,
                                 window=128, compact_every=1,
                                 batch=rounds.COALESCE_BATCH)
        pk = rounds.pack_event_workloads([(jobs, [(0.0, 0)])], duration,
                                         spec.window, "fb", [lease],
                                         [float(C)], dtype=f, device=dev)
        grid = FBGrid(capacity=torch.tensor([float(C)], dtype=dtype,
                                            device=dev),
                      lease=torch.tensor([lease], dtype=dtype, device=dev))
        steps = _step_against_plain("fb", grid, pk, spec, duration)
        final = steps[-1][1]
        assert int(final[0, rsk.SC_ACC0]) == n          # all completed
        assert float(final[0, COALESCED]) > 0
        # A round that coalesced completions and ended at a chain end
        # (a multiple of rt) before the horizon.
        cut = [float(a[0, rsk.SC_T]) for b, a in steps
               if float(a[0, COALESCED]) > float(b[0, COALESCED])
               and float(a[0, rsk.SC_T]) < duration]
        assert cut and all(t % rt == 0 for t in cut), cut
        assert len(steps) <= -(-n // rounds.COALESCE_BATCH)


def _run_against_chunks(policy, grid, pk, spec, outer_max):
    """The engine's one-launch loop (``run_rounds``) against the
    per-chunk kernel path from the same startup state: the per-chunk
    path steps every lane with ``chunk_step`` and freezes a lane once
    ``(i < outer_max) & (t < duration)`` fails. Returns both final
    states and step counts."""
    prm = rounds._rounds_prm_tree(policy, grid, 1)
    ctx = rounds._lane_ctx(policy, prm, pk)
    sc0, win0 = rounds._startup(policy, ctx, spec, pk.ws0[prm["w_idx"]])
    inputs = rsk.lane_inputs(policy, ctx)
    sc, win = sc0, win0
    i = torch.zeros(sc.shape[0], dtype=torch.int32, device=sc.device)
    dur = torch.tensor(spec.duration, dtype=sc.dtype, device=sc.device)
    while True:
        live = (i < outer_max) & (sc[:, rsk.SC_T] < dur)
        if not bool(live.any()):
            break
        sc_n, win_n = rsk.chunk_step(*inputs, sc, win, policy=policy,
                                     spec=spec)
        sc = torch.where(live[:, None], sc_n, sc)
        win = torch.where(live[:, None, None], win_n, win)
        i = i + live.to(torch.int32)
    launches = rsk.run_rounds.launches
    rsk.zero_outer_steps()
    got = rsk.run_rounds(*inputs, sc0, win0, policy=policy, spec=spec,
                         outer_max=outer_max)
    torch.cuda.synchronize()
    assert rsk.run_rounds.launches == launches + 1
    assert rsk.outer_steps() == int(i.max())
    return got, (sc, win, i)


@pytest.mark.parametrize("outer_max", [None, 7])
@pytest.mark.parametrize("batch", [1, rounds.COALESCE_BATCH])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("policy", ["fb", "flb_nub"])
def test_one_launch_run_equals_the_per_chunk_path_on_the_card(
        policy, dtype, batch, outer_max):
    """Every field bit for bit, the three integrals too (the same
    arithmetic per step), and the per-lane outer-step counts; with
    outer_max 7 the round budget, not the horizon, stops the lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    horizon = 2 * DAY
    jobs = [j for j in traces.nasa_ipsc(seed=0) if j.submit < horizon]
    ws = [(t, d) for t, d in traces.worldcup98(seed=0, peak_vms=128)
          if t < horizon]
    points = [p for p in paper_grid(128) if p.system == policy]
    opts = ScanOptions(dtype=np.float64 if dtype == torch.float64 else None,
                       coalesce=batch)
    (_, _, fb, flb, fb_packs, flb_packs, fb_spec, flb_spec) = _pack_rounds(
        points, [(jobs, ws)], horizon, opts, dev)
    grid, pk, spec = ((fb, fb_packs[0], fb_spec) if policy == "fb"
                      else (flb, flb_packs[0], flb_spec))
    full = -(-spec.max_rounds // spec.compact_every)
    (sc, win, steps), (sc_c, win_c, steps_c) = _run_against_chunks(
        policy, grid, pk, spec, full if outer_max is None else outer_max)
    assert torch.equal(sc, sc_c) and torch.equal(win, win_c)
    assert torch.equal(steps, steps_c)
    if outer_max is None:
        assert bool((sc[:, rsk.SC_T] >= horizon).all())
        assert int(steps.max()) > 20
    else:
        assert int(steps.max()) == outer_max
        assert bool((sc[:, rsk.SC_T] < horizon).any())


def test_rounds_grids_launch_once_per_policy_on_the_card():
    """The engine on the card: one run_rounds launch per policy, no
    per-chunk launch, and the metrics of the plain host loop (exact
    except the three integrals' rows, rtol 1e-5 in float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    horizon = 2 * DAY
    jobs = [j for j in traces.sdsc_blue(seed=0) if j.submit < horizon]
    ws = [(t, d) for t, d in traces.worldcup98(seed=0, peak_vms=128)
          if t < horizon]
    points = [p for p in paper_grid(128) if p.system in ("fb", "flb_nub")]
    outs = []
    for kernel in ("cuda", "torch"):
        opts = ScanOptions(kernel=kernel)
        (_, _, fb, flb, fb_packs, flb_packs, fb_spec,
         flb_spec) = _pack_rounds(points, [(jobs, ws)], horizon, opts, dev)
        chunks, runs = rsk.chunk_step.launches, rsk.run_rounds.launches
        outs.append(rounds.rounds_grids(fb, flb, fb_packs[0], flb_packs[0],
                                        fb_spec=fb_spec, flb_spec=flb_spec))
        torch.cuda.synchronize()
        assert rsk.chunk_step.launches == chunks
        assert rsk.run_rounds.launches - runs == (2 if kernel == "cuda"
                                                  else 0)
    for policy in ("fb", "flb_nub"):
        for key, got in outs[0][policy].items():
            want = outs[1][policy][key]
            if key in ("avg_turnaround", "avg_execution", "node_hours"):
                torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
            else:
                assert torch.equal(got, want), (policy, key)


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
    # every head dim and G 1, 2, 4, 8 through the bfloat16 tensor-core
    # kernel: ragged S, windows below one 64-key tile, Sq < 64 (the
    # q_offset tail below)
    (16, 4, 300, 128, 40, 50.0), (8, 1, 130, 32, None, None),
    (4, 4, 70, 16, 20, None), (32, 4, 200, 64, 9, 30.0),
    (8, 2, 1000, 256, None, 50.0),
]
DECODE_CASES = [
    # (bkv, g, S, hd, pos, window, softcap)
    (4, 2, 1024, 64, 100, None, 50.0), (4, 2, 1024, 64, 900, 256, 50.0),
    (4, 2, 1100, 32, 1099, 512, 30.0), (4, 4, 1100, 256, 1050, None, None),
    (4, 2, 88, 16, 80, 64, 50.0), (6, 3, 40, 64, 23, None, None),
    (32, 2, 8192, 256, 6000, 4096, 50.0),   # gemma2-2b, batch 8
    # pos 0; the last key of a chunk (64 keys at hd 256 in bfloat16, 32
    # in float32) and the first of the next; G 8
    (4, 2, 1024, 256, 0, None, 50.0), (4, 2, 1024, 256, 127, None, None),
    (4, 2, 1024, 256, 128, 64, 50.0), (3, 8, 700, 128, 511, 300, 30.0),
    (2, 8, 300, 64, 299, None, 50.0),
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


# Non-causal attention: (bh, bkv, sq, skv, hd, window, softcap, q_offset);
# a key is visible iff it lies in the window (no diagonal), Sq < 64 at an
# offset too.
FULL_CASES = [
    (8, 2, 200, 200, 256, None, 50.0, 0), (4, 4, 37, 300, 64, 48, None, 250),
    (8, 1, 129, 129, 128, 30, 30.0, 0), (4, 2, 60, 60, 32, None, None, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,bkv,sq,skv,hd,window,cap,q_offset", FULL_CASES)
def test_flash_attention_noncausal_kernel_equals_plain_on_the_card(
        bh, bkv, sq, skv, hd, window, cap, q_offset, dtype):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bkv
    dev = _cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(bh, sq, hd, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(bkv, skv, hd, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    kw = dict(causal=False, window=window, softcap=cap, q_offset=q_offset)
    got = flash_attention_bkv(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    atol, rtol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def test_flash_decode_combine_leaves_its_counters_at_zero_on_the_card():
    """The last block of each row group combines the runs and resets its
    counter, so launch after launch on one stream, and on a second
    stream with counters of its own, gives the plain version's result."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_decode as fdk
    dev = _cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(16, 2, 256, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(16, 2048, 256, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    atol, rtol = ATTN_TOL[torch.bfloat16]
    side = torch.cuda.Stream(dev)
    for stream in (torch.cuda.current_stream(dev), side):
        with torch.cuda.stream(stream):
            for pos in (0, 1000, 2047):
                at = torch.tensor(pos, dtype=torch.int32, device=dev)
                got = fdk.flash_decode_bkv(q, k, v, at, window=1500,
                                           softcap=50.0)
                want = ref.flash_decode_ref(q, k, v, at, window=1500,
                                            softcap=50.0)
                stream.synchronize()
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=atol, rtol=rtol)
        assert int(stream_zeroed_ints(stream, 1).abs().sum()) == 0


@pytest.mark.parametrize("pos,window", [(-1, None), (-5, 64), (1087, 64),
                                        (5000, 64)])
def test_flash_decode_with_no_visible_key_writes_zeros_on_the_card(pos,
                                                                    window):
    """A position that leaves no key visible (before the cache, or every
    key left of the window) gives zeros, not the output buffer's old
    contents; the counters stay at zero."""
    from repro_torch.kernels import flash_decode as fdk
    dev = _cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(4, 2, 256, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(4, 1024, 256, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    # leave NaNs in the blocks the allocator hands out next
    junk = [q.new_full(q.shape, float("nan")) for _ in range(8)]
    del junk
    at = torch.tensor(pos, dtype=torch.int32, device=dev)
    got = fdk.flash_decode_bkv(q, k, v, at, window=window, softcap=50.0)
    torch.cuda.synchronize()
    assert bool((got == 0).all())
    assert int(stream_zeroed_ints(
        torch.cuda.current_stream(dev), 1).abs().sum()) == 0


@pytest.mark.parametrize("pos,window", [(-1, None), (400, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_with_no_visible_key_equals_plain_on_the_card(
        pos, window, dtype):
    """q (2, 2, 64), S 256: before the cache, or every key left of the
    window; the kernel and the plain version both give zeros."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_decode as fdk
    dev = _cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn(2, 2, 64, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(2, 256, 64, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    at = torch.tensor(pos, dtype=torch.int32, device=dev)
    got = fdk.flash_decode_bkv(q, k, v, at, window=window)
    want = ref.flash_decode_ref(q, k, v, at, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((got == 0).all())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_rows_with_no_visible_key_are_zero_on_the_card(
        dtype, causal):
    """q at an offset past the keys with a window: rows from position
    163 on see no key (all keys left of their window) and are 0 in the
    kernel and the plain version; the rows before them match."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bkv
    dev = _cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(4, 70, 64, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(2, 100, 64, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, window=64, softcap=50.0, q_offset=130)
    got = flash_attention_bkv(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert bool((want[:, 163 - 130:] == 0).all())
    assert bool((got[:, 163 - 130:] == 0).all())
    atol, rtol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


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
    (2, 80, 64, 128, 128),                          # one ragged chunk
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_strong_decay_on_the_card(dtype):
    """a = -16 · dt, dt in [0.5, 1.5): the upper triangle's exponents
    overflow; the kernel selects 0 there (finite, equal to the plain
    version and to the token-by-token recurrence)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bh
    dev = _cuda_or_skip()
    x, _, B, C, _ = _ssd_inputs(24, 512, 64, 128, dtype, dev, 5, False)
    gen = torch.Generator(device=dev).manual_seed(6)
    a = -16.0 * (0.5 + torch.rand(24, 512, generator=gen, device=dev))
    y, sT = ssd_scan_bh(x, a, B, C)
    assert torch.isfinite(y.float()).all() and torch.isfinite(sT).all()
    for want_y, want_s in (ref.ssd_scan_bh_ref(x, a, B, C),
                           ref.ssd_ref(x, a, B, C)):
        assert _within(y, want_y, *SSD_TOL[dtype])
        assert _within(sT, want_s, *STATE_TOL)


@pytest.mark.parametrize("bh,dtype", [(192, torch.bfloat16),
                                      (24, torch.bfloat16),
                                      (24, torch.float32)])
def test_ssd_scan_chain_at_full_width_on_the_card(bh, dtype):
    """mamba2-130m at L 4096: BH 192 (batch 8) is many waves of blocks
    with several chunk levels in flight at once; BH 24 (batch 1) has a
    level of 24 rows that wait on each other's hand-offs. Both equal
    the plain version, and the ticket counter and flags are left at 0."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssk
    dev = _cuda_or_skip()
    x, a, B, C, s0 = _ssd_inputs(bh, 4096, 64, 128, dtype, dev, 8, True)
    y, sT = ssk.ssd_scan_bh(x, a, B, C, s0=s0)
    want_y, want_s = ref.ssd_scan_bh_ref(x, a, B, C, s0=s0)
    torch.cuda.synchronize()
    assert _within(y, want_y, *SSD_TOL[dtype])
    assert _within(sT, want_s, *STATE_TOL)
    stream = torch.cuda.current_stream(dev)
    assert int(stream_zeroed_ints(stream, 1).abs().sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_calls_repeat_and_overlap_bit_for_bit_on_the_card(dtype):
    """Back-to-back calls on one stream give identical results, and two
    calls running at once on two streams (each with its own counter and
    flags) equal the same calls made in series, bit for bit."""
    from repro_torch.kernels import ssd_scan as ssk
    dev = _cuda_or_skip()
    one = _ssd_inputs(96, 2048, 64, 128, dtype, dev, 9, True)
    two = _ssd_inputs(72, 2048, 64, 128, dtype, dev, 10, False)
    serial = [ssk.ssd_scan_bh(*one[:4], s0=one[4]),
              ssk.ssd_scan_bh(*two[:4], s0=two[4])]
    again = ssk.ssd_scan_bh(*one[:4], s0=one[4])
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(again, serial[0]))
    main = torch.cuda.current_stream(dev)
    side = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    for s in side:
        s.wait_stream(main)
    out = []
    for s, args in zip(side, (one, two)):
        with torch.cuda.stream(s):
            out.append(ssk.ssd_scan_bh(*args[:4], s0=args[4]))
    torch.cuda.synchronize()
    for got, want in zip(out, serial):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for s in side:
        assert int(stream_zeroed_ints(s, 1).abs().sum()) == 0


def test_ssd_scan_products_run_on_the_tensor_cores_on_the_card():
    """The built library's SASS holds HGMMA (wgmma) instructions: the
    chunk products run on the tensor cores."""
    import shutil
    import subprocess
    from pathlib import Path
    from repro_torch.kernels import ssd_scan as ssk
    _cuda_or_skip()
    home = Path(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc").parent
    sass = subprocess.run([str(home / "cuobjdump"), "-sass",
                           str(ssk.LIBRARY.build())], capture_output=True,
                          text=True, check=True).stdout
    assert "HGMMA" in sass


def test_ssd_scan_wrapper_takes_cuda_tensors_only():
    from repro_torch.kernels.ssd_scan import ssd_scan_bh
    before = ssd_scan_bh.launches
    x, B = torch.zeros(2, 16, 8), torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan_bh(x, torch.zeros(2, 16), B, B)
    assert ssd_scan_bh.launches == before
