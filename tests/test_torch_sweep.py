"""The port's sweep (``repro_torch.sim.sweep``) against the JAX package.

On a two-day NASA iPSC + WorldCup slice and the full ``paper_grid``:

* FB / FLB-NUB rows of ``run_sweep(mode="rounds")`` and ``mode="auto"``
  equal the reference ``rounds_grids`` (``kernel="xla"``) metrics —
  exact, except the three integral metrics at rtol 1e-5 (float32);
* vectorized DCS / EC2 rows match the reference event engine
  ``repro.sim.engine.run_sim``: integer metrics exactly, node-hours to
  1e-9 relative;
* FB / FLB-NUB rows sit inside ``CONTRACTS["rounds"]`` against the
  port's event engine.

The reference ``repro.sim.sweep`` is not imported: the grids and packs
are built from the reference's rounds and scan modules directly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.sim import engine as ref_engine
from repro.sim import rounds as ref_rounds
from repro.sim import scan as ref_scan
from repro.sim import traces as ref_traces
from repro_torch.core.pbj_manager import PBJPolicyParams
from repro_torch.sim import rounds
from repro_torch.sim.contracts import CONTRACTS, check_fidelity
from repro_torch.sim.engine import clone_jobs, run_sim
from repro_torch.sim.sweep import (ScanOptions, SweepPoint, _build,
                                   paper_grid, run_sweep,
                                   run_sweep_workloads, warmup_sweep)

DAY = 24 * 3600.0
HORIZON = 2 * DAY
GRID = paper_grid(64, 64)


@pytest.fixture(scope="module")
def workload():
    jobs = [j for j in ref_traces.nasa_ipsc(seed=0) if j.submit < HORIZON]
    ws = [(t, d) for t, d in ref_traces.worldcup98(seed=0, peak_vms=64)
          if t < HORIZON]
    return jobs, ws


@pytest.fixture(scope="module")
def rounds_rows(workload):
    return run_sweep(GRID, *workload, HORIZON, mode="rounds", device="cpu")


def reference_metrics(policy, workload):
    """The reference rounds_grids (kernel="xla") on this policy's points
    of the grid, as the reference sweep would call it."""
    jobs, ws = workload
    idx = [i for i, p in enumerate(GRID) if p.system == policy]
    pts = [GRID[i] for i in idx]
    leases = [p.lease_seconds for p in pts]
    K = (ref_rounds.FB_ROUNDS_WINDOW if policy == "fb"
         else ref_rounds.FLB_ROUNDS_WINDOW)
    spec = ref_rounds.RoundsSpec(
        duration=HORIZON, window=K,
        max_rounds=ref_rounds.round_budget(len(jobs), len(ws), HORIZON,
                                           min(leases)))
    f = jnp.float32
    if policy == "fb":
        levels = [float(p.capacity) for p in pts]
        grid = ref_scan.FBGrid(capacity=jnp.asarray(levels, f),
                               lease=jnp.asarray(leases, f))
        args = (grid, None)
    else:
        levels = [float(p.lb_ws) for p in pts]
        grid = ref_scan.FLBGrid(
            B=jnp.asarray([float(p.lb_pbj + p.lb_ws) for p in pts], f),
            lb_ws=jnp.asarray(levels, f),
            U=jnp.asarray([p.params.request_threshold for p in pts], f),
            V=jnp.asarray([p.params.release_threshold for p in pts], f),
            G=jnp.asarray([p.params.elastic_factor for p in pts], f),
            lease=jnp.asarray(leases, f))
        args = (None, grid)
    pk = ref_rounds.pack_event_workloads([(jobs, ws)], HORIZON, K, policy,
                                         leases, levels, split=True)[0]
    packs = (pk, None) if policy == "fb" else (None, pk)
    kw = {"fb_spec": spec} if policy == "fb" else {"flb_spec": spec}
    out = ref_rounds.rounds_grids(*args, *packs, **kw)[policy]
    return idx, {k: np.asarray(v)[0] for k, v in out.items()}


_ROW_KEYS = ("completed_jobs", "avg_turnaround", "avg_execution",
             "node_hours", "peak_nodes", "adjust_events",
             "pbj_adjust_events", "kills", "window_overflow", "rounds",
             "truncated", "coalesced")


@pytest.mark.parametrize("mode", ["rounds", "auto"])
@pytest.mark.parametrize("policy", ["fb", "flb_nub"])
def test_rounds_rows_equal_reference_metrics(workload, rounds_rows, policy,
                                             mode):
    rows = rounds_rows if mode == "rounds" else run_sweep(
        GRID, *workload, HORIZON, mode=mode, device="cpu")
    idx, ref = reference_metrics(policy, workload)
    for j, i in enumerate(idx):
        row = rows[i]
        assert row["engine"] == "rounds"
        for k in _ROW_KEYS:
            want = float(ref[k][j])
            if k in ("avg_turnaround", "avg_execution", "node_hours"):
                assert row[k] == pytest.approx(want, rel=1e-5), (i, k)
            else:
                assert row[k] == int(round(want)), (i, k)


def test_vectorized_rows_match_reference_event_engine(workload,
                                                      rounds_rows):
    """DCS / EC2 fast-path rows vs the JAX package's event engine: ints
    exact, node-hours to 1e-9 (the verify recipe)."""
    jobs, ws = workload
    checked = 0
    for p, row in zip(GRID, rounds_rows):
        if p.system not in ("dcs", "ec2"):
            continue
        sys_ = (ref_engine.build_dcs(p.prc_pbj, p.prc_ws, p.lease_seconds)
                if p.system == "dcs"
                else ref_engine.build_ec2_rightscale(p.lease_seconds))
        ref = ref_engine.run_sim(sys_, ref_engine.clone_jobs(jobs), ws,
                                 HORIZON).row()
        assert row["engine"] == "vectorized"
        assert row["node_hours"] == pytest.approx(ref["node_hours"],
                                                  rel=1e-9), p.name()
        for k in ("peak_nodes", "adjust_events", "pbj_adjust_events",
                  "kills"):
            assert row[k] == ref[k], (p.name(), k)
        if p.system == "ec2":
            assert row["completed_jobs"] == ref["completed_jobs"]
        checked += 1
    assert checked == 6


def test_rounds_rows_inside_contract_vs_event_engine(workload, rounds_rows):
    jobs, ws = workload
    event = [run_sim(_build(p), clone_jobs(jobs), ws, HORIZON,
                     name=p.name()).row()
             if p.system in ("fb", "flb_nub") else None for p in GRID]
    fast = [r if r["engine"] == "rounds" else None for r in rounds_rows]
    assert sum(r is not None for r in fast) == 15
    assert check_fidelity(fast, event) == [], CONTRACTS["rounds"]


def test_sweep_modes_devices_and_fallbacks(workload):
    jobs, ws = workload
    fb = SweepPoint("fb", capacity=40)
    assert run_sweep([fb], jobs, ws, HORIZON, mode="scan",
                     device="cpu")[0]["engine"] == "scan"
    with pytest.raises(ValueError, match="unknown mode"):
        run_sweep([fb], jobs, ws, HORIZON, mode="fast", device="cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="CUDA device\\(s\\) visible"):
            run_sweep([fb], jobs, ws, HORIZON, devices=2, device="cpu")
    with pytest.raises(ValueError, match="kernel=\"cuda\" needs CUDA"):
        run_sweep([fb], jobs, ws, HORIZON, device="cpu",
                  scan_options=ScanOptions(kernel="cuda"))
    preempt = SweepPoint("fb", capacity=40,
                         params=PBJPolicyParams(checkpoint_preempt=True))
    with pytest.raises(ValueError, match="checkpoint_preempt"):
        run_sweep([preempt], jobs, ws, HORIZON, mode="rounds", device="cpu")
    row = run_sweep([preempt], jobs, ws, HORIZON, mode="auto",
                    device="cpu")[0]
    assert row["engine"] == "event"
    with pytest.raises(ValueError, match="ScenarioGrid"):
        run_sweep_workloads([fb], object(), HORIZON, device="cpu")
    assert warmup_sweep([fb], [(jobs, ws)], HORIZON, device="cpu") > 0


def test_entry_points_need_cuda_unless_cpu_is_asked_for(workload):
    """No hidden CPU fallback: without a CUDA device, an entry point
    called without device="cpu" raises. With a card, the default is it."""
    from repro_torch import compat
    if torch.cuda.is_available():
        assert compat.resolve_device().type == "cuda"
        return
    jobs, ws = workload
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep([SweepPoint("fb", capacity=40)], jobs, ws, HORIZON)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rounds.fb_rounds_row(jobs, ws, 40, 3600.0, HORIZON)
