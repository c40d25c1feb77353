"""The port's fixed-dt scan engine (``repro_torch.sim.scan``, the sweep's
``mode="scan"``) against the JAX package's ``repro.sim.scan``.

* ``pack_workloads``, ``pick_dt`` and ``compact_window`` equal the
  reference's, in float32 and float64;
* ``scan_grids`` rows equal the reference's on two 2-day workloads (the
  faults benchmark's cut: the first 120 jobs, sizes capped at 16, demand
  at peak 16): counts exact, the three time integrals within rtol 1e-5
  (float32) or 1e-6 (float64); with ``ScanOptions(dt=, chunk_len=)``
  set, the sweep's rows equal the reference's at the same spec;
* the sweep's scan rows hold ``CONTRACTS["scan"]`` against the event
  engine, FB with ``checkpoint_preempt`` is refused, FLB-NUB with it
  gives the same rows;
* the kill behaviours of the reference's ``tests/test_scan_policies.py``
  hold on the port: killed jobs re-enter and finish, a partial kill
  takes the fewest nodes, FLB-NUB never kills.

The reference ``repro.sim.sweep`` does not import on jax 0.9, so the
reference rows come from ``repro.sim.scan`` directly, with the spec the
reference sweep's ``ScanOptions.resolve`` builds.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.jobs import Job as RefJob
from repro.sim import scan as ref
from repro.sim import traces as ref_traces
from repro_torch.core.jobs import Job
from repro_torch.core.pbj_manager import PBJPolicyParams
from repro_torch.sim import scan, traces
from repro_torch.sim.contracts import CONTRACTS, check_fidelity
from repro_torch.sim.engine import build_fb, clone_jobs, run_sim
from repro_torch.sim.sweep import (ScanOptions, SweepPoint, _assemble_rows,
                                   _build, run_sweep, run_sweep_workloads)

DAY = 24 * 3600.0
HORIZON = 2 * DAY
DTYPES = [np.float32, np.float64]
RTOL = {np.float32: 1e-5, np.float64: 1e-6}
INTEGRALS = ("avg_turnaround", "avg_execution", "node_hours")
# FB at two capacities; FLB-NUB at the paper's B 25 with a 1 h, a 15 min
# and a 30 min lease, and B 13.
FB_POINTS = ((24.0, 3600.0), (32.0, 3600.0))
FLB_POINTS = ((25.0, 12.0, 3600.0), (25.0, 12.0, 900.0),
              (25.0, 12.0, 1800.0), (13.0, 12.0, 3600.0))
U, V, G = (PBJPolicyParams().request_threshold,
           PBJPolicyParams().release_threshold,
           PBJPolicyParams().elastic_factor)


def bench_cut(jobs, peak, seed):
    """The faults benchmark's 2-day cut of a trace: the first 120 jobs
    submitted in the first 60 %, sizes capped at 16, WorldCup at peak
    ``peak``."""
    cut = [RefJob(jid=i, submit=j.submit, size=min(j.size, 16),
                  runtime=j.runtime)
           for i, j in enumerate(j for j in jobs if j.submit < HORIZON * 0.6)]
    return (cut[:120], ref_traces.worldcup98(seed=seed, peak_vms=peak,
                                             duration=HORIZON))


@pytest.fixture(scope="module")
def workloads():
    return [bench_cut(ref_traces.nasa_ipsc(seed=0), 16, 0),
            bench_cut(ref_traces.sdsc_blue(seed=0), 16, 1)]


def _both(dtype, fn):
    """Run ``fn`` with x64 enabled for float64 (jax defaults to f32)."""
    if dtype == np.float64:
        with jax.enable_x64(True):
            return fn()
    return fn()


def _spec(lib, policy, leases, ws_traces):
    """The reference sweep's ``ScanOptions.resolve`` with no overrides."""
    dt = lib.pick_dt(policy, leases, ws_traces, HORIZON)
    chunk = max(2, int(round((3600.0 if policy == "fb" else 1800.0) / dt)))
    return lib.ScanSpec(n_steps=int(np.ceil(HORIZON / dt)), dt=dt,
                        window=lib.FB_WINDOW if policy == "fb"
                        else lib.FLB_WINDOW, chunk_len=chunk,
                        ff_passes=lib.DEFAULT_FF_PASSES)


def _grids(lib, mk):
    fb = lib.FBGrid(capacity=mk([c for c, _ in FB_POINTS]),
                    lease=mk([L for _, L in FB_POINTS]))
    flb = lib.FLBGrid(B=mk([b for b, _, _ in FLB_POINTS]),
                      lb_ws=mk([w for _, w, _ in FLB_POINTS]),
                      U=mk([U] * len(FLB_POINTS)),
                      V=mk([V] * len(FLB_POINTS)),
                      G=mk([G] * len(FLB_POINTS)),
                      lease=mk([L for _, _, L in FLB_POINTS]))
    return fb, flb


def _specs(lib, workloads):
    return (_spec(lib, "fb", [L for _, L in FB_POINTS], None),
            _spec(lib, "flb_nub", [L for _, _, L in FLB_POINTS],
                  [ws for _, ws in workloads]))


# ------------------------------------------------------------------ packing

@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_workloads_equals_reference(workloads, dtype):
    fb_spec, flb_spec = _specs(ref, workloads)
    for spec in (fb_spec, flb_spec):
        want, n_want = _both(dtype, lambda: ref.pack_workloads(
            workloads, HORIZON, spec.dt, window=spec.window,
            chunk_len=spec.chunk_len))
        got, n_got = scan.pack_workloads(
            workloads, HORIZON, spec.dt, window=spec.window,
            chunk_len=spec.chunk_len, dtype=dtype, device="cpu")
        assert n_got == n_want
        for k in ("submit", "size", "runtime", "ws", "ws0", "ws_changed",
                  "hi_chunk", "n_jobs"):
            a = np.asarray(getattr(want, k))
            b = getattr(got, k).numpy()
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_pick_dt_equals_reference_and_caps():
    ws = [(0.0, 1), (150.0, 2), (300.0, 3)]
    ws_fine = [(0.0, 1), (1.0, 2), (2.0, 1)]
    ws_late = [(0.0, 1), (9000.0, 2), (9150.0, 3)]
    cases = [("fb", [3600.0], None, None), ("flb_nub", [3600.0], None, None),
             ("flb_nub", [120.0], None, None), ("flb_nub", [3600.0], [ws],
                                                None),
             ("flb_nub", [3600.0], [ws_fine], None),
             ("fb", [3600.0], [ws], None),
             ("flb_nub", [3600.0], [ws_late], 7200.0),
             ("flb_nub", [3600.0], [ws_late], None),
             ("flb_nub", [900.0, 3600.0], [ws_late, ws], 1e5)]
    for policy, leases, traces, duration in cases:
        assert scan.pick_dt(policy, leases, traces, duration) \
            == ref.pick_dt(policy, leases, traces, duration)
    assert scan.pick_dt("flb_nub", [3600.0], [ws]) == 150.0
    assert scan.pick_dt("flb_nub", [3600.0], [ws_fine]) == scan.FLB_MIN_DT
    assert scan.pick_dt("flb_nub", [3600.0], [ws_late],
                        duration=7200.0) == scan.FLB_DT
    assert scan.pick_dt("fb", [3600.0], [ws]) == scan.FB_DT


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(3))
def test_compact_window_equals_reference(dtype, seed):
    rng = np.random.default_rng(seed)
    N, K, Jp = 5, 16, 40
    keep = rng.random((N, K)) < 0.6
    keep[0] = True
    keep[1] = False
    jidx = np.sort(rng.integers(0, Jp, (N, K)), axis=1).astype(np.int32)
    next_row = rng.integers(K, Jp + 3, N).astype(np.int32)
    run = rng.random((N, K)) < 0.5
    rem = rng.integers(0, 5000, (N, K)).astype(dtype)
    start = rng.integers(0, 9000, (N, K)).astype(dtype)

    def go():
        return jax.vmap(lambda k, j, n, r, m, s: ref.compact_window(
            k, j, n, Jp, ((r, False), (m, jnp.zeros((), dtype)),
                          (s, jnp.zeros((), dtype)))))(
            keep, jidx, next_row, run, rem, start)

    j_r, n_r, (run_r, rem_r, st_r) = _both(dtype, go)
    t = torch.from_numpy
    j_p, n_p, (run_p, rem_p, st_p) = scan.compact_window(
        t(keep), t(jidx), t(next_row), Jp,
        ((t(run), False), (t(rem), 0.0), (t(start), 0.0)))
    for a, b, name in ((j_r, j_p, "jidx"), (n_r, n_p, "next_row"),
                       (run_r, run_p, "run"), (rem_r, rem_p, "rem"),
                       (st_r, st_p, "start")):
        a = np.asarray(a)
        if name not in ("jidx", "next_row"):    # int width follows x64
            assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


# --------------------------------------------------------- the engine rows

def _metrics_close(got, want, dtype, label):
    for k, a in want.items():
        a = np.asarray(a)
        b = got[k].numpy()
        assert a.shape == b.shape, (label, k)
        if k in INTEGRALS:
            np.testing.assert_allclose(b, a, rtol=RTOL[dtype], atol=0,
                                       err_msg=f"{label} {k}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{label} {k}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_scan_grids_rows_equal_reference(workloads, dtype, monkeypatch):
    fb_spec, flb_spec = _specs(ref, workloads)
    assert flb_spec.dt == 300.0 and fb_spec.dt == 900.0
    if dtype == np.float64:
        # Under x64 the reference's compact_window returns its window
        # cursor as int64 (a cumsum of bools), which the reference's own
        # int32 scan carry refuses on jax 0.9. Cast those two index
        # outputs back to int32 (same values) so the float64 reference
        # runs at all; nothing else of the reference changes.
        compact = ref.compact_window

        def int32_cursor(*args, **kwargs):
            jidx, next_row, fields = compact(*args, **kwargs)
            return jidx.astype(jnp.int32), next_row.astype(jnp.int32), \
                fields

        monkeypatch.setattr(ref, "compact_window", int32_cursor)

    def go():
        f = jnp.float64 if dtype == np.float64 else jnp.float32
        fb, flb = _grids(ref, lambda v: jnp.asarray(v, f))
        packs = [ref.pack_workloads(workloads, HORIZON, s.dt,
                                    window=s.window, chunk_len=s.chunk_len)[0]
                 for s in (fb_spec, flb_spec)]
        return ref.scan_grids(fb, flb, *packs, fb_spec=fb_spec,
                              flb_spec=flb_spec)

    want = _both(dtype, go)
    f = torch.float64 if dtype == np.float64 else torch.float32
    fb, flb = _grids(scan, lambda v: torch.tensor(v, dtype=f))
    p_specs = _specs(scan, workloads)
    packs = [scan.pack_workloads(workloads, HORIZON, s.dt, window=s.window,
                                 chunk_len=s.chunk_len, dtype=dtype,
                                 device="cpu")[0] for s in p_specs]
    got = scan.scan_grids(fb, flb, *packs, fb_spec=p_specs[0],
                          flb_spec=p_specs[1])
    for policy in ("fb", "flb_nub"):
        _metrics_close(got[policy], want[policy], dtype, policy)
    # The grid really exercises the engine: FB kills, jobs complete.
    assert float(got["fb"]["kills"].sum()) > 0
    assert float(got["flb_nub"]["completed_jobs"].min()) > 100
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="CUDA device\\(s\\) visible"):
            scan.scan_grids(fb, flb, *packs, fb_spec=p_specs[0],
                            flb_spec=p_specs[1], devices=2)


def test_scan_options_dt_and_chunk_len_equal_reference(workloads):
    """``ScanOptions(dt=, chunk_len=)`` overrides both policies' substep
    and re-gather cadence: the sweep's scan rows equal the reference's
    ``scan_grids`` at the spec the reference sweep builds from the same
    options (float32: counts exact, integrals within rtol 1e-5), and
    differ from the rows at the default cadence."""
    dt, chunk = 600.0, 3
    points = ([SweepPoint("fb", capacity=c, lease_seconds=L)
               for c, L in FB_POINTS]
              + [SweepPoint("flb_nub", lb_pbj=B - w, lb_ws=w,
                            lease_seconds=L) for B, w, L in FLB_POINTS])
    opts = ScanOptions(dt=dt, chunk_len=chunk)
    specs = [ref.ScanSpec(n_steps=int(np.ceil(HORIZON / dt)), dt=dt,
                          window=win, chunk_len=chunk,
                          ff_passes=ref.DEFAULT_FF_PASSES)
             for win in (ref.FB_WINDOW, ref.FLB_WINDOW)]
    for policy, want in zip(("fb", "flb_nub"), specs):
        got = opts.resolve(policy, [3600.0], HORIZON)
        assert (got.n_steps, got.dt, got.window, got.chunk_len,
                got.ff_passes) == (want.n_steps, want.dt, want.window,
                                   want.chunk_len, want.ff_passes)
    fb, flb = _grids(ref, lambda v: jnp.asarray(v, jnp.float32))
    packs = [ref.pack_workloads(workloads, HORIZON, s.dt, window=s.window,
                                chunk_len=s.chunk_len)[0] for s in specs]
    out = ref.scan_grids(fb, flb, *packs, fb_spec=specs[0],
                         flb_spec=specs[1])
    out = {p: {k: np.asarray(v) for k, v in m.items()}
           for p, m in out.items()}
    want = _assemble_rows(points, [0, 1], [2, 3, 4, 5], out,
                          len(workloads), "scan")
    got = run_sweep_workloads(points, workloads, HORIZON, mode="scan",
                              scan_options=opts, device="cpu")
    default = run_sweep_workloads(points, workloads, HORIZON, mode="scan",
                                  device="cpu")
    for w, (rows_w, rows_g) in enumerate(zip(want, got)):
        for a, b in zip(rows_w, rows_g):
            for k, v in a.items():
                if k in INTEGRALS:
                    assert b[k] == pytest.approx(v, rel=RTOL[np.float32],
                                                 abs=0), (w, a["system"], k)
                else:
                    assert b[k] == v, (w, a["system"], k)
    assert got != default


def test_sweep_scan_rows_hold_scan_contract():
    """mode="scan" rows over the paper's two weeks (NASA iPSC + WorldCup
    at peak 128, where the reference holds the band) inside
    CONTRACTS["scan"] of the event engine: the Fig. 13 capacities, Fig.
    14 pool sizes and Fig. 18 leases of the reference's own scan-contract
    grid."""
    jobs = traces.nasa_ipsc(seed=0)
    ws = traces.worldcup98(seed=0, peak_vms=128)
    grid = ([SweepPoint("fb", capacity=c) for c in (128, 154, 192, 256)]
            + [SweepPoint("flb_nub", lb_pbj=B - 12, lb_ws=12)
               for B in (13, 25, 51, 154)]
            + [SweepPoint("flb_nub", lb_pbj=13, lb_ws=12, lease_seconds=L,
                          label=f"FLB-NUB(L={L:g}s)")
               for L in (900.0, 3600.0, 14400.0)])
    rows = run_sweep_workloads(grid, [(jobs, ws)], traces.TWO_WEEKS,
                               mode="scan", device="cpu")[0]
    assert all(r["engine"] == "scan" and r["window_overflow"] == 0
               for r in rows)
    event = [run_sim(_build(p), clone_jobs(jobs), ws, traces.TWO_WEEKS,
                     name=p.name()).row() for p in grid]
    assert check_fidelity(rows, event) == [], CONTRACTS["scan"]
    # Fig. 13: node-hours grow with C, in both engines.
    nh = [r["node_hours"] for r in rows[:4]]
    assert nh == sorted(nh)


def test_scan_mode_refuses_fb_checkpoint_preempt(workloads):
    jobs, ws = workloads[0]
    preempt = PBJPolicyParams(checkpoint_preempt=True)
    with pytest.raises(ValueError, match="checkpoint_preempt.*scan"):
        run_sweep([SweepPoint("fb", capacity=24, params=preempt)], jobs, ws,
                  HORIZON, mode="scan", device="cpu")
    # FLB-NUB never kills, so the flag is a no-op there.
    rows = [run_sweep([SweepPoint("flb_nub", lb_pbj=13, lb_ws=12,
                                  params=PBJPolicyParams(
                                      checkpoint_preempt=flag))],
                      jobs, ws, HORIZON, mode="scan", device="cpu")[0]
            for flag in (False, True)]
    assert rows[0] == rows[1]
    assert rows[0]["kills"] == 0 and rows[0]["engine"] == "scan"


# ------------------------------------------ the reference's kill behaviours

OPTS = ScanOptions(window=32)   # tiny window: these workloads are small


def scan_row(point, jobs, ws, duration):
    return run_sweep([point], jobs, ws, duration, mode="scan",
                     scan_options=OPTS, device="cpu")[0]


def spike_workload():
    """C = 10: three jobs fill the site, then a WS spike to 8 leaves 2
    nodes — both size-4 jobs must be killed (§5.1 rule 2) and can only
    finish by re-entering the queue after the demand recedes."""
    jobs = [Job(0, 0.0, size=4, runtime=2 * 3600.0),
            Job(1, 0.0, size=4, runtime=2 * 3600.0),
            Job(2, 0.0, size=2, runtime=1200.0)]
    ws = [(0.0, 0), (1800.0, 8), (2 * 3600.0, 0)]
    return jobs, ws


def random_workload(seed):
    rng = random.Random(seed)
    jobs = [Job(i, rng.uniform(0.0, 12 * 3600.0),
                size=2 ** rng.randrange(0, 4),
                runtime=rng.uniform(900.0, 2 * 3600.0))
            for i in range(30)]
    ws = [(k * 900.0, rng.randrange(0, 13)) for k in range(0, 96, 2)]
    return jobs, ws


def test_fb_scan_killed_jobs_reenter_and_finish():
    jobs, ws = spike_workload()
    row = scan_row(SweepPoint("fb", capacity=10), jobs, ws, 8 * 3600.0)
    ev = run_sim(build_fb(10), clone_jobs(jobs), ws, 8 * 3600.0)
    assert ev.kills == 2 and row["kills"] == 2
    assert ev.completed_jobs == 3 and row["completed_jobs"] == 3
    assert row["peak_nodes"] == ev.peak_nodes == 10
    assert row["node_hours"] == pytest.approx(ev.node_hours, rel=0.05)
    assert row["window_overflow"] == 0


def test_fb_scan_partial_kill_prefers_fewest_nodes():
    jobs, _ = spike_workload()
    ws = [(0.0, 0), (1800.0, 5), (2 * 3600.0, 0)]
    row = scan_row(SweepPoint("fb", capacity=10), jobs, ws, 8 * 3600.0)
    ev = run_sim(build_fb(10), clone_jobs(jobs), ws, 8 * 3600.0)
    assert ev.kills == 1 and row["kills"] == 1
    assert row["completed_jobs"] == ev.completed_jobs == 3


@pytest.mark.parametrize("seed", range(3))
def test_fb_scan_matches_event_on_random_traces(seed):
    jobs, ws = random_workload(seed)
    C = 12
    row = scan_row(SweepPoint("fb", capacity=C), jobs, ws, DAY)
    ev = run_sim(build_fb(C), clone_jobs(jobs), ws, DAY)
    assert row["window_overflow"] == 0
    assert (row["kills"] > 0) == (ev.kills > 0)
    assert abs(row["kills"] - ev.kills) <= max(2, 0.5 * ev.kills)
    assert abs(row["completed_jobs"] - ev.completed_jobs) <= 2
    assert row["node_hours"] == pytest.approx(ev.node_hours, rel=0.15)
    assert row["peak_nodes"] <= C
    assert row["node_hours"] <= C * DAY / 3600.0 + 1e-6


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_flb_nub_scan_never_kills(seed):
    """FLB-NUB satisfies WS elastically and releases only free nodes, so
    its scan rows carry no kill, on workloads where FB does kill."""
    jobs, ws = random_workload(seed) if seed else spike_workload()
    row = scan_row(SweepPoint("flb_nub", lb_pbj=13, lb_ws=12), jobs, ws, DAY)
    assert row["kills"] == 0
    fb = scan_row(SweepPoint("fb", capacity=10 if seed == 0 else 12), jobs,
                  ws, DAY)
    assert fb["kills"] > 0, seed
    # §5.2: the rigid pool B is never dropped.
    assert row["peak_nodes"] >= 25
    assert row["node_hours"] >= 25 * DAY / 3600.0 - 1e-6
