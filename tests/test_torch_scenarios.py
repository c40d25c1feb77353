"""The port's generated scenario batches (``repro_torch.sim.scenarios``)
against the JAX package's ``repro.sim.scenarios``.

* Draws → transform parity: the reference's own draws (rebuilt from a
  ``jax.random`` key with the reference's splits and calls) through the
  port's transforms give the reference's job tables and demand series:
  ``n_jobs`` and sizes exact, submit and runtime within rtol 1e-5, WS
  demands within 1 VM everywhere and equal at >= 99.9 % of the steps,
  the peak exact. The two compute the arrival CDF with sums in another
  order, so arrival times differ in the last bits; where two arrivals
  lie within that tolerance of each other their order is not
  determined, and the sizes are compared as a multiset over such a tie.
* The reference's scenario tests on the port's own draws: determinism
  per seed, lane independence, parameter broadcast, the paper points'
  moments.
* ``pack_scenarios`` / ``sample_workloads`` of the reference's batch
  equal the reference's; the generated sweep's rows equal the
  reference's ``rounds_grids`` on the same batch and hold
  ``CONTRACTS["rounds"]`` on sampled lanes; the ``ScenarioGrid`` errors.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.sim import rounds as ref_rounds
from repro.sim import scan as ref_scan
from repro.sim import scenarios as ref
from repro_torch.sim import scenarios as sc
from repro_torch.sim import traces
from repro_torch.sim.contracts import CONTRACTS
from repro_torch.sim.sweep import (ScanOptions, SweepPoint,
                                   _sweep_rounds_generated, run_sweep,
                                   run_sweep_workloads)

DAY = 24 * 3600.0
RTOL = 1e-5
POINTS = [SweepPoint("fb", capacity=48, label="FB(C=48)"),
          SweepPoint("fb", capacity=64, label="FB(C=64)"),
          SweepPoint("flb_nub", lb_pbj=13, lb_ws=12, label="FLB-NUB(B=25)"),
          SweepPoint("flb_nub", lb_pbj=13, lb_ws=12, lease_seconds=1800.0,
                     label="FLB-NUB(L=30min)")]


# ------------------------------------------- the reference's draws, rebuilt

def ref_pbj_draws(key, params, max_jobs):
    """``repro.sim.scenarios.synth_pbj``'s seven draws (its lines
    151-170), under the port's names."""
    kt, kb, ke, kd, kf, ks, kr = jax.random.split(key, 7)
    probs = jnp.asarray(params.size_probs, jnp.float32)
    return {
        "u_arrival": jax.random.uniform(kt, (max_jobs,)),
        "u_center": jax.random.uniform(kb, (ref._BURST_EPISODES,)),
        "episode": jax.random.randint(ke, (max_jobs,), 0,
                                      ref._BURST_EPISODES),
        "exponential": jax.random.exponential(kd, (max_jobs,)),
        "u_burst": jax.random.uniform(kf, (max_jobs,)),
        "size_class": jax.random.categorical(
            ks, jnp.log(probs + 1e-12), shape=(max_jobs,)),
        "normal": jax.random.normal(kr, (max_jobs,)),
    }


def ref_ws_draws(key, n_steps, step_seconds):
    """``repro.sim.scenarios.synth_ws``'s five draws (its lines 189-202)."""
    kn, kday, kh, kl, ka = jax.random.split(key, 5)
    n_days = max(int(n_steps * step_seconds // 86400.0), 2)
    u = jax.random.uniform
    return {"normal": jax.random.normal(kn, (n_steps,)),
            "day": jax.random.randint(kday, (ref._WS_SURGES,), 1, n_days),
            "hour": u(kh, (ref._WS_SURGES,), minval=12.0, maxval=20.0),
            "length": u(kl, (ref._WS_SURGES,), minval=0.6, maxval=1.4),
            "amp": u(ka, (ref._WS_SURGES,), minval=0.5, maxval=1.0)}


def _lane(params, cls):
    """One lane's parameters: the reference's float32 arrays (as its
    jitted batch sees them) and the port's (1,)-tensor dataclass."""
    ref_p = ref._broadcast_params(params, 1)
    ref_p = type(ref_p)(**{f.name: np.asarray(getattr(ref_p, f.name))[0]
                           for f in dataclasses.fields(ref_p)})
    port = cls(**{f.name: getattr(params, f.name)
                  for f in dataclasses.fields(params)})
    return ref_p, sc._lane_params(sc._broadcast_params(port, 1), "cpu")


def _draws(d):
    return {k: torch.from_numpy(np.array(v))[None] for k, v in d.items()}


def assert_tables_match(want, got):
    """``want`` / ``got`` = (submit, size, runtime, n_jobs) of one lane."""
    sub_r, sz_r, rt_r, n_r = (np.asarray(x) for x in want)
    sub_p, sz_p, rt_p, n_p = got
    n = int(n_r)
    assert int(n_p) == n
    assert sz_p.dtype == sz_r.dtype and sub_p.dtype == sub_r.dtype
    np.testing.assert_allclose(sub_p[:n], sub_r[:n], rtol=RTOL, atol=0)
    assert np.all(np.isinf(sub_p[n:])) and np.all(sz_p[n:] == 0)
    assert np.all(rt_p[n:] == 0)
    # Arrivals within the tolerance of each other form a tie whose order
    # the tolerance does not decide: compare (size, runtime) per tie.
    brk = np.nonzero(np.diff(sub_r[:n]) > RTOL * sub_r[1:n])[0] + 1
    for a, b in zip(np.r_[0, brk], np.r_[brk, n]):
        pr = sorted(zip(sz_r[a:b], rt_r[a:b]))
        pp = sorted(zip(sz_p[a:b], rt_p[a:b]))
        assert [s for s, _ in pr] == [s for s, _ in pp], (a, b)
        np.testing.assert_allclose([r for _, r in pp], [r for _, r in pr],
                                   rtol=RTOL, atol=0)
    return int((sz_p[:n] != sz_r[:n]).sum())


@pytest.mark.parametrize("point", ["nasa", "sdsc"])
@pytest.mark.parametrize("seed", range(4))
def test_pbj_transform_reproduces_reference_from_its_draws(point, seed):
    params = {"nasa": ref.NASA_IPSC_PBJ, "sdsc": ref.SDSC_BLUE_PBJ}[point]
    M, T = 3000, ref.TWO_WEEKS
    key = ref.lane_keys((seed,))[0, 0]
    ref_p, port_p = _lane(params, sc.PBJParams)
    want = jax.jit(lambda k, p: ref.synth_pbj(k, p, max_jobs=M,
                                              duration=T))(key, ref_p)
    got = sc._pbj_from_draws(_draws(ref_pbj_draws(key, params, M)), port_p,
                             max_jobs=M, duration=T)
    swapped = assert_tables_match(want, [x[0].numpy() for x in got])
    assert swapped <= 0.005 * int(want[3])


@pytest.mark.parametrize("n_steps,step", [(4032, 300.0), (192, 900.0)])
@pytest.mark.parametrize("seed", range(4))
def test_ws_transform_reproduces_reference_from_its_draws(seed, n_steps,
                                                          step):
    params = ref.WORLDCUP_WS
    key = ref.lane_keys((seed,))[0, 1]
    ref_p, port_p = _lane(params, sc.WSParams)
    want = np.asarray(jax.jit(lambda k, p: ref.synth_ws(
        k, p, n_steps=n_steps, step_seconds=step))(key, ref_p))
    got = sc._ws_from_draws(_draws(ref_ws_draws(key, n_steps, step)),
                            port_p, n_steps=n_steps,
                            step_seconds=step)[0].numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got - want).max() <= 1.0
    assert np.mean(got == want) >= 0.999
    assert got.max() == want.max() == 64.0


def test_traces_forward_the_generator_names():
    assert traces.synth_pbj is sc.synth_pbj
    assert traces.ScenarioGrid is sc.ScenarioGrid
    assert traces.lane_keys is sc.lane_keys


# ------------------------------------ the reference's tests, port's draws

def small_grid(seeds=(0, 1, 2, 3), duration=2 * DAY, max_jobs=200):
    return sc.ScenarioGrid(
        seeds=tuple(seeds),
        pbj=sc.PBJParams(nodes=64.0, utilization=0.5,
                         n_jobs=float(max_jobs - 50)),
        ws=sc.WSParams(peak=32.0), duration=duration, max_jobs=max_jobs)


FIELDS = ("submit", "size", "runtime", "n_jobs", "ws_values")


def test_synthesize_deterministic_per_seed():
    grid = small_grid()
    a, b = sc.synthesize(grid, "cpu"), sc.synthesize(grid, "cpu")
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    c = sc.synthesize(dataclasses.replace(grid, seeds=(7, 8, 9, 10)), "cpu")
    assert not np.array_equal(a.submit, c.submit)
    assert not np.array_equal(a.ws_values, c.ws_values)


def test_lane_depends_only_on_its_seed():
    """Lane w of a grid equals a one-lane grid of seeds[w], whatever the
    batch's width or the lane's position in it."""
    seeds = (3, 11, 42)
    wide = sc.synthesize(small_grid(seeds), "cpu")
    for w, s in enumerate(seeds):
        one = sc.synthesize(small_grid((s,)), "cpu")
        for f in FIELDS:
            assert np.array_equal(getattr(wide, f)[w],
                                  getattr(one, f)[0]), (s, f)
    keys = sc.lane_keys(seeds)
    assert keys.shape == (3, 2) and len({int(k) for k in keys.ravel()}) == 6
    np.testing.assert_array_equal(sc.lane_keys((42,))[0], keys[2])


def test_param_broadcast_and_per_lane_axes():
    grid = sc.ScenarioGrid(
        seeds=(0, 1, 2),
        pbj=sc.PBJParams(nodes=64.0, n_jobs=100.0,
                         utilization=np.array([0.3, 0.5, 0.7])),
        ws=sc.WSParams(peak=np.array([16.0, 32.0, 64.0])),
        duration=2 * DAY, max_jobs=150)
    s = sc.synthesize(grid, "cpu")
    util = np.array([(s.size[w] * s.runtime[w]).sum()
                     for w in range(3)]) / (64.0 * 2 * DAY)
    assert np.allclose(util, [0.3, 0.5, 0.7], atol=1e-3)
    assert list(s.ws_values.max(axis=1)) == [16.0, 32.0, 64.0]
    with pytest.raises(ValueError, match="leading dim"):
        sc.synthesize(sc.ScenarioGrid(
            seeds=(0, 1, 2),
            pbj=sc.PBJParams(utilization=np.array([0.3, 0.5])),
            duration=2 * DAY, max_jobs=150), "cpu")


@pytest.mark.parametrize("point,nodes,util,n_jobs,rt_band", [
    (sc.NASA_IPSC_PBJ, 128, 0.466, 2603, (400.0, 700.0)),
    (sc.SDSC_BLUE_PBJ, 144, 0.762, 2657, (1500.0, 2500.0)),
])
def test_pbj_paper_points_match_trace_moments(point, nodes, util, n_jobs,
                                              rt_band):
    s = sc.synthesize(sc.ScenarioGrid(seeds=(0,), pbj=point), "cpu")
    n = int(s.n_jobs[0])
    assert n == n_jobs
    size, rt = s.size[0][:n], s.runtime[0][:n]
    sub = s.submit[0]
    assert np.all(np.diff(sub[:n]) >= 0)
    assert np.all(np.isinf(sub[n:]))
    assert np.all((size >= 1) & (size <= nodes))
    assert np.all(np.log2(size) == np.round(np.log2(size)))
    realized = float((size * rt).sum()) / (nodes * sc.TWO_WEEKS)
    assert realized == pytest.approx(util, abs=1e-3)
    assert rt_band[0] < rt.mean() < rt_band[1]
    assert rt.min() >= 1.0


def test_ws_paper_point_matches_worldcup_moments():
    s = sc.synthesize(sc.ScenarioGrid(seeds=(0, 1), ws=sc.WORLDCUP_WS,
                                      max_jobs=100,
                                      pbj=sc.PBJParams(n_jobs=50.0)), "cpu")
    v = s.ws_values
    assert np.all(v.max(axis=1) == 64.0)
    assert v.min() >= 1.0
    assert np.all(v == np.round(v))
    changes = (v[:, 1:] != v[:, :-1]).sum(axis=1)
    assert np.all(changes > 500)


# ------------------------------------------------ packing and the sweep

@pytest.fixture(scope="module")
def ref_batch():
    """The reference's batch: 2 days, max_jobs 400, three lanes."""
    return ref.synthesize(ref.ScenarioGrid(
        seeds=(0, 1, 2), pbj=ref.PBJParams(nodes=64.0, utilization=0.5,
                                           n_jobs=350.0),
        ws=ref.WSParams(peak=32.0), duration=2 * DAY, max_jobs=400))


@pytest.mark.parametrize("policy,leases,levels", [
    ("fb", [3600.0, 3600.0], [48.0, 64.0]),
    ("flb_nub", [3600.0, 1800.0], [12.0, 12.0])])
def test_pack_scenarios_equals_reference(ref_batch, policy, leases, levels):
    want = ref.pack_scenarios(ref_batch, 96, policy, leases, levels)
    got = sc.pack_scenarios(ref_batch, 96, policy, leases, levels,
                            device="cpu")
    for f in dataclasses.fields(want):
        a = getattr(want, f.name)
        b = getattr(got, f.name)
        if a is None:
            assert b is None, f.name
            continue
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, f.name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f.name)


def test_sample_workloads_round_trips(ref_batch):
    got = sc.sample_workloads(ref_batch, [0, 2])
    want = ref.sample_workloads(ref_batch, [0, 2])
    for (gj, gw), (rj, rw), w in zip(got, want, (0, 2)):
        assert gw == rw
        assert [dataclasses.astuple(j) for j in gj] == \
            [dataclasses.astuple(j) for j in rj]
        n = int(ref_batch.n_jobs[w])
        assert [j.submit for j in gj] == ref_batch.submit[w, :n].tolist()
        assert [j.size for j in gj] == ref_batch.size[w, :n].tolist()
    # The traces step exactly where the dense grid changes.
    vals = ref_batch.ws_values[0]
    assert len(got[0][1]) == 1 + int((vals[1:] != vals[:-1]).sum())


def _reference_rows(batch):
    """The reference's rounds_grids over its own pack_scenarios, as its
    ``_sweep_rounds_generated`` calls them."""
    changes = batch.ws_values[:, 1:] != batch.ws_values[:, :-1]
    n_ws = int(changes.sum(axis=1).max()) + 1
    f = jnp.float32
    out = {}
    for policy, pts in (("fb", POINTS[:2]), ("flb_nub", POINTS[2:])):
        leases = [p.lease_seconds for p in pts]
        K = (ref_rounds.FB_ROUNDS_WINDOW if policy == "fb"
             else ref_rounds.FLB_ROUNDS_WINDOW)
        spec = ref_rounds.RoundsSpec(
            duration=batch.duration, window=K,
            max_rounds=ref_rounds.round_budget(batch.submit.shape[1], n_ws,
                                               batch.duration, min(leases)))
        if policy == "fb":
            levels = [float(p.capacity) for p in pts]
            grid = (ref_scan.FBGrid(capacity=jnp.asarray(levels, f),
                                    lease=jnp.asarray(leases, f)), None)
        else:
            levels = [float(p.lb_ws) for p in pts]
            col = lambda fn: jnp.asarray([fn(p) for p in pts], f)
            grid = (None, ref_scan.FLBGrid(
                B=col(lambda p: p.lb_pbj + p.lb_ws), lb_ws=col(
                    lambda p: p.lb_ws),
                U=col(lambda p: p.params.request_threshold),
                V=col(lambda p: p.params.release_threshold),
                G=col(lambda p: p.params.elastic_factor),
                lease=jnp.asarray(leases, f)))
        pk = ref.pack_scenarios(batch, K, policy, leases, levels)
        packs = (pk, None) if policy == "fb" else (None, pk)
        kw = {"fb_spec": spec} if policy == "fb" else {"flb_spec": spec}
        out[policy] = {k: np.asarray(v) for k, v in
                       ref_rounds.rounds_grids(*grid, *packs, **kw)[
                           policy].items()}
    return out


def test_generated_sweep_rows_equal_reference(ref_batch):
    grid = sc.ScenarioGrid(seeds=(0, 1, 2), duration=2 * DAY, max_jobs=400)
    rows = _sweep_rounds_generated(POINTS, grid, ScanOptions(),
                                   synth=ref_batch, device="cpu")
    want = _reference_rows(ref_batch)
    for w in range(3):
        for i, p in enumerate(POINTS):
            policy, j = ("fb", i) if i < 2 else ("flb_nub", i - 2)
            row = rows[w][i]
            assert row["engine"] == "rounds" and row["truncated"] == 0
            for k in ("completed_jobs", "peak_nodes", "adjust_events",
                      "pbj_adjust_events", "kills", "window_overflow",
                      "rounds", "coalesced"):
                assert row[k] == int(round(float(want[policy][k][w, j]))), \
                    (w, p.name(), k)
            for k in ("avg_turnaround", "avg_execution", "node_hours"):
                assert row[k] == pytest.approx(float(want[policy][k][w, j]),
                                               rel=RTOL), (w, p.name(), k)


def test_generated_sweep_holds_rounds_contract_on_sampled_lanes():
    """The port's own batch through run_sweep_workloads: every lane's
    moments, then the sampled lanes {0, W//2, W-1} through the event
    engine, held to CONTRACTS["rounds"]."""
    W = 5
    grid = sc.ScenarioGrid(
        seeds=tuple(range(W)),
        pbj=sc.PBJParams(nodes=64.0,
                         utilization=np.linspace(0.35, 0.8, W),
                         n_jobs=np.round(np.linspace(250.0, 380.0, W))),
        ws=sc.WSParams(peak=np.round(np.linspace(16.0, 48.0, W))),
        duration=2 * DAY, max_jobs=400)
    rows = run_sweep_workloads(POINTS, grid, mode="rounds", device="cpu")
    synth = sc.synthesize(grid, "cpu")
    again = _sweep_rounds_generated(POINTS, grid, ScanOptions(),
                                    synth=synth, device="cpu")
    assert rows == again
    sample = sorted({0, W // 2, W - 1})
    ev = run_sweep_workloads(POINTS, sc.sample_workloads(synth, sample),
                             2 * DAY, mode="event", device="cpu")
    for j, w in enumerate(sample):
        for i, p in enumerate(POINTS):
            assert rows[w][i]["truncated"] == 0
            assert CONTRACTS["rounds"].check_row(rows[w][i],
                                                 ev[j][i]) == [], (w, p)


def test_scenario_grid_errors():
    grid = small_grid((0, 1))
    fb = [SweepPoint("fb", capacity=40)]
    with pytest.raises(ValueError, match="rounds engine only"):
        run_sweep_workloads(fb, grid, mode="scan", device="cpu")
    with pytest.raises(ValueError, match="rounds engine only"):
        run_sweep_workloads(fb, grid, mode="event", device="cpu")
    with pytest.raises(ValueError, match="ScenarioGrid.duration"):
        run_sweep_workloads(fb, grid, duration=DAY, device="cpu")
    for bad in (SweepPoint("dcs", prc_pbj=32, prc_ws=32),
                SweepPoint("ec2")):
        with pytest.raises(ValueError, match="FB / FLB-NUB points only"):
            run_sweep_workloads(fb + [bad], grid, device="cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="CUDA device\\(s\\) visible"):
            run_sweep_workloads(fb, grid, devices=2, device="cpu")
    preempt = SweepPoint("fb", capacity=40, params=dataclasses.replace(
        fb[0].params, checkpoint_preempt=True))
    with pytest.raises(ValueError, match="checkpoint_preempt"):
        run_sweep_workloads([preempt], grid, device="cpu")
    # duration equal to the grid's is accepted; so is "auto".
    rows = run_sweep_workloads(fb, grid, duration=grid.duration,
                               mode="auto", device="cpu")
    assert [r[0]["engine"] for r in rows] == ["rounds", "rounds"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sc.synthesize(grid)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_sweep(fb, [], [(0.0, 0)], DAY, mode="scan")
