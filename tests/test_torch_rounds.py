"""The port's event-rounds engine against the JAX package's, row by row.

* ``repro_torch.sim.rounds.rounds_grids`` rows equal the reference
  ``repro.sim.rounds.rounds_grids`` (``kernel="xla"``) on a
  ``paper_grid`` subset of both policies over TWO workloads at once (the
  flattened trace × point lanes), on the same packed inputs: every
  metric exact except the three built from time integrals
  (avg_turnaround, avg_execution, node_hours), held at rtol 1e-5 in
  float32. The coalescer's rows are in test_torch_rounds_coalesce.py.
* The event-round property, mirroring tests/test_rounds.py: in float64
  the completion times are event times, so completed jobs, turnaround
  and execution agree with the port's copy of the event engine to
  round-off.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.sim import rounds as ref_rounds
from repro.sim import scan as ref_scan
from repro.sim import traces as ref_traces
from repro_torch.core.jobs import Job
from repro_torch.sim import rounds
from repro_torch.sim.engine import build_fb, build_flb_nub, clone_jobs, run_sim
from repro_torch.sim.sweep import ScanOptions, SweepPoint, paper_grid, run_sweep

DAY = 24 * 3600.0
HORIZON = 2 * DAY
INTEGRAL_METRICS = ("avg_turnaround", "avg_execution", "node_hours")
# Fig. 13 capacities 0.5 / 0.75 of a 128-node DCS, Fig. 14 B = 13 / 51
# and the Fig. 18 L = 15 min point — both policies' ticks, kills and
# queues on a two-day slice.
GRID = [p for i, p in enumerate(paper_grid(64, 64)) if i in (1, 3, 6, 8, 11)]


def two_workloads():
    out = []
    for fn in (ref_traces.nasa_ipsc, ref_traces.sdsc_blue):
        jobs = [j for j in fn(seed=0) if j.submit < HORIZON]
        ws = [(t, d) for t, d in ref_traces.worldcup98(seed=0, peak_vms=64)
              if t < HORIZON]
        out.append((jobs, ws))
    return out


def policy_points(policy):
    return [p for p in GRID if p.system == policy]


def reference_rows(policy, workloads, batch):
    """Reference rounds_grids metrics (W, P) plus its pack's arrays."""
    pts = policy_points(policy)
    leases = [p.lease_seconds for p in pts]
    K = (ref_rounds.FB_ROUNDS_WINDOW if policy == "fb"
         else ref_rounds.FLB_ROUNDS_WINDOW)
    max_jobs = max(len(j) for j, _ in workloads)
    n_ws = max(len(w) for _, w in workloads)
    spec = ref_rounds.RoundsSpec(
        duration=HORIZON, window=K, batch=batch,
        max_rounds=ref_rounds.round_budget(max_jobs, n_ws, HORIZON,
                                           min(leases)))
    f = jnp.float32
    if policy == "fb":
        levels = [float(p.capacity) for p in pts]
        grid = ref_scan.FBGrid(capacity=jnp.asarray(levels, f),
                               lease=jnp.asarray(leases, f))
    else:
        levels = [float(p.lb_ws) for p in pts]
        grid = ref_scan.FLBGrid(
            B=jnp.asarray([float(p.lb_pbj + p.lb_ws) for p in pts], f),
            lb_ws=jnp.asarray(levels, f),
            U=jnp.asarray([p.params.request_threshold for p in pts], f),
            V=jnp.asarray([p.params.release_threshold for p in pts], f),
            G=jnp.asarray([p.params.elastic_factor for p in pts], f),
            lease=jnp.asarray(leases, f))
    pk = ref_rounds.pack_event_workloads(workloads, HORIZON, K, policy,
                                         leases, levels)
    arrays = {k: np.asarray(getattr(pk, k)) for k in rounds._PACK_FIELDS}
    kw = {"fb_spec": spec} if policy == "fb" else {"flb_spec": spec}
    out = ref_rounds.rounds_grids(grid if policy == "fb" else None,
                                  grid if policy != "fb" else None,
                                  pk if policy == "fb" else None,
                                  pk if policy != "fb" else None, **kw)
    return ({k: np.asarray(v) for k, v in out[policy].items()}, arrays,
            spec)


def port_rows(policy, arrays, rspec, batch):
    from repro_torch.sim.scan import FBGrid, FLBGrid
    pts = policy_points(policy)
    pk = rounds.from_reference_pack(arrays, device="cpu")
    f = pk.submit.dtype

    def col(fn):
        return torch.tensor([float(fn(p)) for p in pts], dtype=f)

    if policy == "fb":
        grid = FBGrid(capacity=col(lambda p: p.capacity),
                      lease=col(lambda p: p.lease_seconds))
    else:
        grid = FLBGrid(B=col(lambda p: p.lb_pbj + p.lb_ws),
                       lb_ws=col(lambda p: p.lb_ws),
                       U=col(lambda p: p.params.request_threshold),
                       V=col(lambda p: p.params.release_threshold),
                       G=col(lambda p: p.params.elastic_factor),
                       lease=col(lambda p: p.lease_seconds))
    spec = rounds.RoundsSpec(duration=rspec.duration,
                             max_rounds=rspec.max_rounds,
                             window=rspec.window, batch=batch)
    kw = {"fb_spec": spec} if policy == "fb" else {"flb_spec": spec}
    out = rounds.rounds_grids(grid if policy == "fb" else None,
                              grid if policy != "fb" else None,
                              pk if policy == "fb" else None,
                              pk if policy != "fb" else None, **kw)
    return {k: v.numpy() for k, v in out[policy].items()}


def assert_rows_match(ref, port, label):
    assert set(ref) == set(port), label
    for k in ref:
        assert ref[k].shape == port[k].shape, (label, k)
        if k in INTEGRAL_METRICS:
            np.testing.assert_allclose(ref[k], port[k], rtol=1e-5, atol=0,
                                       err_msg=f"{label} {k}")
        else:
            np.testing.assert_array_equal(ref[k], port[k],
                                          err_msg=f"{label} {k}")


def check_policy(policy, batch):
    workloads = two_workloads()
    ref, arrays, rspec = reference_rows(policy, workloads, batch)
    port = port_rows(policy, arrays, rspec, batch)
    assert_rows_match(ref, port, (policy, batch))
    assert (port["truncated"] == 0).all() and (port["completed_jobs"] > 0).all()
    return port


@pytest.mark.parametrize("policy", ["fb", "flb_nub"])
def test_rounds_grids_rows_match_reference(policy):
    port = check_policy(policy, 1)
    if policy == "fb":
        assert port["kills"].sum() > 0        # the §5.1 kill path ran


def test_pack_matches_reference_pack():
    """The port's own pack equals the reference's field by field."""
    workloads = two_workloads()
    pts = policy_points("flb_nub")
    leases = [p.lease_seconds for p in pts]
    levels = [float(p.lb_ws) for p in pts]
    ref = ref_rounds.pack_event_workloads(workloads, HORIZON, 96, "flb_nub",
                                          leases, levels)
    port = rounds.pack_event_workloads(workloads, HORIZON, 96, "flb_nub",
                                       leases, levels, device="cpu")
    for k in rounds._PACK_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, k)),
                                      getattr(port, k).numpy(), err_msg=k)
    split = rounds.pack_event_workloads(workloads, HORIZON, 96, "flb_nub",
                                        leases, levels, split=True,
                                        device="cpu")
    assert len(split) == 2
    assert torch.equal(split[1].submit[0], port.submit[1])


@pytest.mark.parametrize("policy", ["fb", "flb_nub"])
def test_fold_tables_equal_reference_and_per_point_loop(policy):
    """The copied fold-table builders: the batched build equals the
    per-point loop and the JAX package's build, element for element."""
    from repro_torch.core.profiles import step_points
    jobs, ws = two_workloads()[0]
    times, values = step_points(ws, HORIZON)
    leases = np.array([900.0, 3600.0, 7200.0])
    levels = np.array([12.0, 40.0, 64.0])
    got = rounds.ws_fold_tables_batch(times, values, HORIZON, policy,
                                      leases, levels)
    loop = rounds._ws_fold_tables_ref(times, values, HORIZON, policy,
                                      leases, levels)
    ref = ref_rounds.ws_fold_tables_batch(times, values, HORIZON, policy,
                                          leases, levels)
    for g, l, r in zip(got, loop, ref):
        np.testing.assert_array_equal(g[0], l)
        np.testing.assert_array_equal(g, r)


# ---------------------------------------- exact completion times (float64)

def random_workload(seed, n_jobs=40, ws_level=2):
    """Queue-provoking random trace with constant low WS demand (no
    demand rises, so FB never kills)."""
    rng = random.Random(seed)
    jobs = [Job(i, rng.uniform(0.0, 16 * 3600.0),
                size=2 ** rng.randrange(0, 4),
                runtime=rng.uniform(600.0, 3 * 3600.0))
            for i in range(n_jobs)]
    return jobs, [(0.0, ws_level)]


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("system", ["fb", "flb_nub"])
def test_completion_times_match_event_engine_in_float64(seed, system):
    jobs, ws = random_workload(seed)
    if system == "fb":
        point, ref_sys = SweepPoint("fb", capacity=12), build_fb(12)
    else:
        point = SweepPoint("flb_nub", lb_pbj=6, lb_ws=4)
        ref_sys = build_flb_nub(6, 4)
    ref = run_sim(ref_sys, clone_jobs(jobs), ws, DAY)
    row = run_sweep([point], jobs, ws, DAY, mode="rounds", device="cpu",
                    scan_options=ScanOptions(ff_passes=8,
                                             dtype=np.float64))[0]
    assert row["window_overflow"] == 0 and row["truncated"] == 0
    assert row["completed_jobs"] == ref.completed_jobs, (seed, system)
    assert row["avg_turnaround"] == pytest.approx(ref.avg_turnaround,
                                                  rel=1e-9), (seed, system)
    assert row["avg_execution"] == pytest.approx(ref.avg_execution,
                                                 rel=1e-9), (seed, system)
    assert row["kills"] == ref.kills == 0
    assert row["peak_nodes"] == ref.peak_nodes
