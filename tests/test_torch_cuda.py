"""The CUDA kernels against their plain versions, on the card.

Runs only where ``torch.cuda.is_available()`` (the check is made inside
each test): there the wrappers build their ``csrc/*.cu`` sources with
nvcc and launch them. The round step's state after every chunk must
equal ``chunk_step_ref`` on the same CUDA tensors, exactly except the
three time integrals (rtol 1e-5 float32, 1e-6 float64), with the
contended-stretch coalescer off and on (batch 1 and 8), and the
one-launch loop (``run_rounds``) must equal the per-chunk kernel path
bit for bit; a pack with fault schedules runs the plain step on the card
(no launch) with the CPU's rows, and the kernel refuses it; the scan
engine (plain tensor code) gives the CPU's rows, a generated scenario
batch runs one kernel launch per policy with the plain step's rows, and
scenario synthesis is deterministic per seed on the card and equals the
CPU's up to the transforms' rounding; the flash
attention and flash decode kernels must match ``kernels.ref`` (see the
tolerances below), and a reduced model's kernel path its plain path; a
reduced MoE model's prefill on the card equals the CPU's; the jaxsim
kernel (one launch per study) gives the plain version's rows on random
grids, float32 and float64, with the job state in shared memory and,
for a table too large for it, in global memory.
``python3 chip_smoke.py`` drives the same comparisons at full size.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.jobs import Job
from repro_torch.kernels import round_step as rsk
from repro_torch.kernels.cudalib import stream_zeroed_ints
from repro_torch.sim import rounds, traces
from repro_torch.sim.scan import FBGrid, _lane_prm_tree
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
    prm = _lane_prm_tree(policy, grid, 1)
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
    prm = _lane_prm_tree(policy, grid, 1)
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


def _fault_pack(dev, capacity=32, horizon=2 * DAY, mtbf_h=(2.0, 24.0)):
    """results/BENCH_faults.json's configuration on a cut of the paper
    traces: one lane per MTBF, each with its own schedule."""
    from repro_torch.sim.faults import (burst_schedule, exponential_schedule,
                                        merge_schedules)
    jobs = [Job(jid=i, submit=j.submit, size=min(j.size, capacity // 2),
                runtime=j.runtime)
            for i, j in enumerate(j for j in traces.nasa_ipsc(seed=0)
                                  if j.submit < horizon * 0.6)][:120]
    ws = traces.worldcup98(seed=0, peak_vms=16, duration=horizon)
    scheds = [merge_schedules(
        exponential_schedule(seed=7, n_nodes=capacity // 2,
                             mtbf=h * 3600.0, mttr=1800.0, duration=horizon),
        burst_schedule(seed=11, k=capacity // 4, mtbf=4 * h * 3600.0,
                       mttr=3600.0, duration=horizon)) for h in mtbf_h]
    spec = rounds.RoundsSpec(
        duration=horizon, window=rounds.FB_ROUNDS_WINDOW,
        max_rounds=rounds.round_budget(len(jobs), len(ws), horizon, 3600.0)
        + 8 * max(len(s) for s in scheds))
    pk = rounds.pack_event_workloads(
        [(jobs, ws)] * len(scheds), horizon, spec.window, "fb", [3600.0],
        [float(capacity)], faults=scheds, device=dev)
    grid = FBGrid(capacity=torch.tensor([float(capacity)], device=dev),
                  lease=torch.tensor([3600.0], device=dev))
    return grid, pk, spec


def test_fault_pack_runs_the_plain_step_on_the_card():
    """A fault pack on cuda resolves to kernel "torch" (no launch) and
    gives the CPU rows, exact except the three integrals (rtol 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    outs = []
    for d in (dev, torch.device("cpu")):
        grid, pk, spec = _fault_pack(d)
        assert spec.resolve_kernel(pk.device, True) == "torch"
        launches = (rsk.chunk_step.launches, rsk.run_rounds.launches)
        outs.append(rounds.rounds_grids(grid, None, pk, None,
                                        fb_spec=spec)["fb"])
        assert (rsk.chunk_step.launches, rsk.run_rounds.launches) == launches
    assert float(outs[0]["kills"].sum()) > 0
    for key, got in outs[0].items():
        want = outs[1][key]
        assert got.device.type == "cuda"
        if key in ("avg_turnaround", "avg_execution", "node_hours"):
            torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)
        else:
            assert torch.equal(got.cpu(), want), key


def test_kernel_refuses_a_fault_table_on_the_card():
    """kernel="cuda", run_rounds and chunk_step refuse a fault pack; the
    same pack without its schedules still launches the kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    grid, pk, spec = _fault_pack(dev)
    cuda_spec = dataclasses.replace(spec, kernel="cuda")
    with pytest.raises(NotImplementedError, match="fault injection"):
        rounds.rounds_grids(grid, None, pk, None, fb_spec=cuda_spec)
    prm = _lane_prm_tree("fb", grid, int(pk.submit.shape[0]))
    ctx = rounds._lane_ctx("fb", prm, pk)
    ftab = rsk.fault_table(ctx)
    inputs = rsk.lane_inputs("fb", ctx, ftab)
    sc, win = rounds._startup("fb", ctx, spec, pk.ws0[prm["w_idx"]])
    launches = (rsk.chunk_step.launches, rsk.run_rounds.launches)
    with pytest.raises(NotImplementedError, match="fault injection"):
        rsk.chunk_step(*inputs, sc, win, policy="fb", spec=spec, ftab=ftab)
    with pytest.raises(NotImplementedError, match="fault injection"):
        rsk.run_rounds(*inputs, sc, win, policy="fb", spec=spec,
                       outer_max=4, ftab=ftab)
    assert (rsk.chunk_step.launches, rsk.run_rounds.launches) == launches
    plain = dataclasses.replace(pk, fault_times=None, fault_failed=None,
                                fault_wsv=None)
    assert spec.resolve_kernel(plain.device) == "cuda"
    out = rounds.rounds_grids(grid, None, plain, None, fb_spec=spec)["fb"]
    torch.cuda.synchronize()
    assert rsk.run_rounds.launches == launches[1] + 1
    assert float(out["completed_jobs"].min()) > 0


# ------------------------- the scan engine and generated scenarios on the card

def _rows_equal(got, want):
    """Sweep rows: exact except the three integrals (rtol 1e-5)."""
    for rg, rw in zip(got, want):
        for a, b in zip(rg, rw):
            for k in a:
                if k in ("avg_turnaround", "avg_execution", "node_hours"):
                    assert a[k] == pytest.approx(b[k], rel=1e-5), k
                else:
                    assert a[k] == b[k], k


def test_scan_rows_on_the_card_equal_the_cpu_rows():
    """mode="scan" (plain tensor code, no kernel) gives the CPU's rows on
    cuda for both policies and two traces, and launches nothing."""
    from repro_torch.sim.sweep import run_sweep_workloads
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    horizon = 2 * DAY
    wls = [([j for j in tr(seed=0) if j.submit < horizon],
            [(t, d) for t, d in traces.worldcup98(seed=s, peak_vms=128)
             if t < horizon])
           for s, tr in enumerate((traces.nasa_ipsc, traces.sdsc_blue))]
    points = [p for p in paper_grid(128) if p.system in ("fb", "flb_nub")]
    launches = (rsk.chunk_step.launches, rsk.run_rounds.launches)
    rows = [run_sweep_workloads(points, wls, horizon, mode="scan",
                                device=d) for d in ("cuda", "cpu")]
    assert (rsk.chunk_step.launches, rsk.run_rounds.launches) == launches
    assert all(r["engine"] == "scan" for rs in rows[0] for r in rs)
    _rows_equal(*rows)


def _scenario_grid(W, duration, max_jobs):
    from repro_torch.sim import scenarios as sc
    return sc.ScenarioGrid(
        seeds=tuple(range(W)),
        pbj=sc.PBJParams(nodes=128.0,
                         utilization=np.linspace(0.35, 0.8, W),
                         n_jobs=np.round(np.linspace(0.6, 0.95, W)
                                         * max_jobs),
                         alpha=np.linspace(0.15, 0.7, W)),
        ws=sc.WSParams(peak=np.round(np.linspace(32.0, 128.0, W))),
        duration=duration, max_jobs=max_jobs)


SCENARIO_POINTS = (("fb", 96), ("fb", 128), ("fb", 160),
                   ("flb_nub", 3600.0), ("flb_nub", 1800.0))


def test_generated_scenarios_kernel_rows_equal_plain_at_width_45():
    """A 9-seed ScenarioGrid over five points (45 lanes) through the
    round-step kernel: one launch per policy, rows equal the plain
    step's on the card."""
    from repro_torch.sim.sweep import SweepPoint, run_sweep_workloads
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    grid = _scenario_grid(9, 2 * DAY, 400)
    points = [SweepPoint("fb", capacity=v) if s == "fb" else
              SweepPoint("flb_nub", lb_pbj=13, lb_ws=12, lease_seconds=v)
              for s, v in SCENARIO_POINTS]
    runs = rsk.run_rounds.launches
    kernel = run_sweep_workloads(points, grid, mode="rounds")
    assert rsk.run_rounds.launches - runs == 2
    plain = run_sweep_workloads(points, grid, mode="rounds",
                                scan_options=ScanOptions(kernel="torch"))
    assert rsk.run_rounds.launches - runs == 2
    assert len(kernel) == 9 and all(len(r) == 5 for r in kernel)
    assert all(r["truncated"] == 0 for rs in kernel for r in rs)
    _rows_equal(kernel, plain)


def test_synthesize_on_the_card_is_deterministic_per_seed():
    """Two syntheses on cuda are equal; lane w equals a one-lane grid of
    its seed; the moments hold (count, sorted arrivals, sizes, peak)."""
    import dataclasses as dc
    from repro_torch.sim import scenarios as sc
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    grid = _scenario_grid(4, 2 * DAY, 400)
    a, b = sc.synthesize(grid), sc.synthesize(grid)
    for f in ("submit", "size", "runtime", "n_jobs", "ws_values"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    one = sc.synthesize(dc.replace(
        grid, seeds=(3,), pbj=sc.PBJParams(
            nodes=128.0, utilization=0.8, n_jobs=float(a.n_jobs[3]),
            alpha=0.7), ws=sc.WSParams(peak=128.0)))
    for f in ("submit", "size", "runtime", "ws_values"):
        assert np.array_equal(getattr(a, f)[3], getattr(one, f)[0]), f
    for w in range(4):
        n = int(a.n_jobs[w])
        assert np.all(np.diff(a.submit[w, :n]) >= 0)
        assert np.all(np.isinf(a.submit[w, n:]))
        assert a.ws_values[w].max() == grid.ws.peak[w]
        assert a.ws_values[w].min() >= 1.0


def assert_synth_close(want, got, rtol=1e-5):
    """Two syntheses of one grid from the same draws, made on different
    devices: counts and the padding exact, submit and runtime within
    ``rtol`` (the devices' float32 sin / log differ in the last bit),
    sizes exact per group of arrivals within ``rtol`` of each other
    (such a group's order is not decided by the tolerance), WS demands
    within 1 VM everywhere, equal at >= 99.9 % of the steps, peak
    exact."""
    np.testing.assert_array_equal(got.n_jobs, want.n_jobs)
    for w in range(len(want.n_jobs)):
        n = int(want.n_jobs[w])
        sub_r, sz_r, rt_r = (x[w] for x in (want.submit, want.size,
                                            want.runtime))
        sub_p, sz_p, rt_p = (x[w] for x in (got.submit, got.size,
                                            got.runtime))
        np.testing.assert_allclose(sub_p[:n], sub_r[:n], rtol=rtol, atol=0)
        assert np.all(np.isinf(sub_p[n:])) and np.all(sz_p[n:] == 0)
        assert np.all(rt_p[n:] == 0)
        brk = np.nonzero(np.diff(sub_r[:n]) > rtol * sub_r[1:n])[0] + 1
        for a, b in zip(np.r_[0, brk], np.r_[brk, n]):
            pr = sorted(zip(sz_r[a:b], rt_r[a:b]))
            pp = sorted(zip(sz_p[a:b], rt_p[a:b]))
            assert [s for s, _ in pr] == [s for s, _ in pp], (w, a, b)
            np.testing.assert_allclose([r for _, r in pp],
                                       [r for _, r in pr], rtol=rtol, atol=0)
        v_r, v_p = want.ws_values[w], got.ws_values[w]
        assert np.abs(v_p - v_r).max() <= 1.0
        assert np.mean(v_p == v_r) >= 0.999
        assert v_p.max() == v_r.max()


def test_synthesize_on_the_card_equals_the_cpu():
    """The draws come from CPU generators on every device, so a grid
    synthesized on cuda equals the CPU's up to the transforms'
    rounding (assert_synth_close)."""
    from repro_torch.sim import scenarios as sc
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    grid = _scenario_grid(12, 2 * DAY, 400)
    assert_synth_close(sc.synthesize(grid, "cpu"), sc.synthesize(grid))


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
    (24, 8, 1000, 64, None, None),      # granite-moe-3b: hd 64, G 3
]
DECODE_CASES = [
    # (bkv, g, S, hd, pos, window, softcap)
    (4, 2, 1024, 64, 100, None, 50.0), (4, 2, 1024, 64, 900, 256, 50.0),
    (4, 2, 1100, 32, 1099, 512, 30.0), (4, 4, 1100, 256, 1050, None, None),
    (4, 2, 88, 16, 80, 64, 50.0), (6, 3, 40, 64, 23, None, None),
    (32, 2, 8192, 256, 6000, 4096, 50.0),   # gemma2-2b, batch 8
    (64, 3, 8192, 64, 4616, None, None),    # granite-moe-3b, batch 8
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
                                  "mamba2_130m", "jamba15_large_398b",
                                  "whisper_base", "llama32_vision_90b"])
def test_model_kernel_path_equals_plain_path_on_the_card(arch):
    """Reduced model: prefill and a scalar-position decode through the
    kernels (impl="cuda": both attention kernels, or the SSD scan)
    against the plain path (impl="torch"), float32 (the models' own
    tolerance, atol 5e-5 / rtol 5e-4, widened to 1e-4 for the kernels'
    summation order); vlm and audio models on a seeded random
    frontend."""
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models.transformer import Model
    dev = _cuda_or_skip()
    cfg = reduced_config(get_config(arch))
    model = Model(cfg, dev, compute_dtype=torch.float32).init(0)
    assert model.impl == "cuda"
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (2, 81), device=dev, generator=gen)
    batch = {"tokens": toks[:, :80]}
    if cfg.family in ("vlm", "audio"):
        batch["frontend"] = torch.randn(2, cfg.frontend_len, cfg.d_model,
                                        device=dev, generator=gen)
    outs = []
    for m in (model, model.with_impl("torch")):
        cache = m.init_cache(2, 96, dtype=torch.float32)
        lg0, cache = m.prefill(batch, cache)
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


# --------------------------------------------------- MoE models on the card

def test_moe_model_prefill_on_the_card_equals_cpu():
    """Reduced granite_moe_3b: prefill and a decode step on the card (the
    attention kernels, the MoE layer's batched products) against the CPU
    plain route with the same weights, float32 at the models' tolerance
    widened to 1e-4 for the kernels' summation order."""
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models.transformer import Model
    dev = _cuda_or_skip()
    cfg = reduced_config(get_config("granite_moe_3b"))
    cpu = Model(cfg, "cpu", compute_dtype=torch.float32).init(0)
    card = Model(cfg, dev, compute_dtype=torch.float32)
    card.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 81),
                         generator=torch.Generator().manual_seed(2))
    outs = []
    for m, d in ((card, dev), (cpu, torch.device("cpu"))):
        cache = m.init_cache(2, 96, dtype=torch.float32)
        lg0, cache = m.prefill({"tokens": toks[:, :80].to(d)}, cache)
        lg1, _ = m.decode(toks[:, 80:].to(d), cache, 80)
        outs.append((lg0.cpu(), lg1.cpu()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=5e-4)


# ------------------------------------------- the jaxsim kernel on the card
#
# simulate_kernel against simulate_ref on the same CUDA tensors: completed
# jobs, peak, adjust events and node-hours exactly (integer-valued sums),
# avg_turnaround within rtol 1e-5 (float32) or 1e-6 (float64): the
# kernel sums the turnarounds in float64, the plain version in the dtype.

JAXSIM_RTOL = {torch.float32: 1e-5, torch.float64: 1e-6}


def _random_lanes(n_lanes, seed, dev, dtype):
    g = torch.Generator().manual_seed(seed)
    prm = torch.stack([
        torch.randint(13, 160, (n_lanes,), generator=g).float(),
        1.0 + torch.rand(n_lanes, generator=g),
        0.05 + 0.5 * torch.rand(n_lanes, generator=g),
        0.2 + 0.8 * torch.rand(n_lanes, generator=g)], -1)
    return prm.to(dev, dtype).contiguous()


def _random_table(n_jobs, n_steps, seed, dev, dtype, lease=3600.0):
    """Jobs over the first 80 % of the run, sizes 1-128 (many small),
    runtimes 5 min to 20 h; WS demand 0-200 VMs per substep."""
    g = torch.Generator().manual_seed(seed)
    horizon = 0.8 * n_steps * lease / 12
    submit = torch.sort(torch.rand(n_jobs, generator=g) * horizon).values
    size = torch.minimum(torch.floor(2.0 ** (torch.rand(n_jobs, generator=g)
                                             * 7.0)), torch.tensor(128.0))
    runtime = 300.0 + torch.rand(n_jobs, generator=g) * 72000.0
    ws = torch.randint(0, 200, (n_steps,), generator=g).float()
    return [x.to(dev, dtype).contiguous() for x in (submit, size, runtime,
                                                    ws)]


def _hold_jaxsim(got, want, dtype):
    for k in ("completed_jobs", "peak_nodes", "adjust_events",
              "node_hours"):
        assert torch.equal(got[k], want[k]), (k, got[k], want[k])
    torch.testing.assert_close(got["avg_turnaround"],
                               want["avg_turnaround"],
                               rtol=JAXSIM_RTOL[dtype], atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_jobs,n_steps,n_lanes", [
    (2603, 600, 37),       # a NASA-sized table, in shared memory
    (300, 1500, 5),
    (16000, 240, 3),       # past the shared-memory limit: global scratch
])
def test_jaxsim_kernel_equals_plain_on_the_card(n_jobs, n_steps, n_lanes,
                                                dtype):
    from repro_torch.kernels import jaxsim_step as jk
    dev = _cuda_or_skip()
    prm = _random_lanes(n_lanes, n_jobs + n_steps, dev, dtype)
    table = _random_table(n_jobs, n_steps, n_jobs, dev, dtype)
    kw = dict(n_steps=n_steps, lease_seconds=3600.0, lb_ws=12, substeps=12)
    assert jk.fits_shared_memory(n_jobs, dtype, dev) == (n_jobs < 16000)
    before = jk.simulate_kernel.launches
    got = jk.simulate_kernel(prm, *table, **kw)
    want = jk.simulate_ref(prm, *table, **kw)
    torch.cuda.synchronize()
    assert jk.simulate_kernel.launches == before + 1
    assert int(got["completed_jobs"].sum()) > 0
    assert float(got["adjust_events"].sum()) > 0
    _hold_jaxsim(got, want, dtype)


def test_jaxsim_sweep_on_the_card_equals_cpu():
    """The §6.6.4 study's first points over a 2-day cut: the entry point
    on the card (one launch) equals the CPU's plain rows."""
    from repro_torch.core import jaxsim
    from repro_torch.kernels import jaxsim_step as jk
    dev = _cuda_or_skip()
    jobs = [j for j in traces.nasa_ipsc(0) if j.submit < 2 * DAY]
    ws = traces.worldcup98(0, peak_vms=128)
    grid = [{"B": b, "U": u, "V": v, "G": g} for b, u, v, g in (
        (13, 1.2, 0.2, 0.5), (154, 2.0, 0.5, 0.99), (25, 1.0, 0.1, 0.25))]
    for dtype in (None, np.float64):
        before = jk.simulate_kernel.launches
        got = jaxsim.sweep(grid, jobs, ws, 2 * DAY, device=dev, dtype=dtype)
        assert jk.simulate_kernel.launches == before + 1
        want = jaxsim.sweep(grid, jobs, ws, 2 * DAY, device="cpu",
                            dtype=dtype)
        rtol = 1e-6 if dtype else 1e-5
        for a, b in zip(got, want):
            assert {k: v for k, v in a.items() if k != "avg_turnaround"} \
                == {k: v for k, v in b.items() if k != "avg_turnaround"}
            assert a["avg_turnaround"] == pytest.approx(b["avg_turnaround"],
                                                        rel=rtol)


def test_jaxsim_kernel_refuses_bad_inputs():
    from repro_torch.kernels import jaxsim_step as jk
    dev = _cuda_or_skip()
    prm = _random_lanes(2, 0, dev, torch.float32)
    table = _random_table(50, 24, 0, dev, torch.float32)
    kw = dict(n_steps=24, lease_seconds=3600.0)
    before = jk.simulate_kernel.launches
    with pytest.raises(ValueError, match="ws"):
        jk.simulate_kernel(prm, *table[:3], table[3][:20], **kw)
    with pytest.raises(ValueError, match="prm"):
        jk.simulate_kernel(prm[:, :3].contiguous(), *table, **kw)
    with pytest.raises(TypeError, match="size"):
        jk.simulate_kernel(prm, table[0], table[1].double(), *table[2:],
                           **kw)
    with pytest.raises(ValueError, match="contiguous"):
        jk.simulate_kernel(prm, table[0], table[1].repeat(2)[::2],
                           *table[2:], **kw)
    with pytest.raises(TypeError, match="float32 or float64"):
        jk.simulate_kernel(*(x.half() for x in [prm, *table]), **kw)
    with pytest.raises(ValueError, match="simulate_ref"):
        jk.simulate_kernel(prm.cpu(), *(x.cpu() for x in table), **kw)
    assert jk.simulate_kernel.launches == before
