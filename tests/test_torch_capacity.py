"""The port's capacity queries (``repro_torch.sim.capacity``) on the CPU.

* ``headline_queries(tiny=True)`` gives EXACTLY the JAX package's
  recorded tiny answers (``results/BENCH_capacity_tiny.json``): DCS 128
  with 381 completed jobs, min FB C = 39 (395 completed), FLB-NUB peak
  658, EC2 peak 712.
* ``min_capacity`` returns the brute-force argmin on a small interval,
  and its answer is feasible while its predecessor is not.
"""

import json
from pathlib import Path

import pytest

from repro_torch.sim import traces
from repro_torch.sim.capacity import (CapacitySLO, CostModel,
                                      headline_queries, min_capacity,
                                      pareto_front)
from repro_torch.sim.sweep import SweepPoint, run_sweep

DAY = 24 * 3600.0
HORIZON = 2 * DAY
RESULTS = Path(__file__).resolve().parents[1] / "results"


def tiny_workload():
    jobs = [j for j in traces.nasa_ipsc(seed=0) if j.submit < HORIZON]
    ws = [(t, d) for t, d in traces.worldcup98(seed=0, peak_vms=64)
          if t < HORIZON]
    return jobs, ws


def test_tiny_headline_equals_reference_record():
    want = json.loads((RESULTS / "BENCH_capacity_tiny.json").read_text()
                      )["headline"]
    got = headline_queries(tiny=True, device="cpu")
    assert got["private"] == want["private"]
    assert got["public"] == want["public"]
    assert (got["private"]["min_fb_capacity"], got["public"]["flb_peak"],
            got["public"]["ec2_peak"]) == (39, 658, 712)
    assert got["private"]["dcs_completed"] == 381
    assert got["gate"]["ok"] and not got["gate"]["checked"]


@pytest.mark.parametrize("lease", [3600.0, 1800.0])
def test_min_capacity_equals_brute_force_argmin(lease):
    jobs, ws = tiny_workload()
    slo = CapacitySLO(min_completed_frac=0.9)
    lo, hi = 60, 90
    template = SweepPoint("fb", lease_seconds=lease)
    report = min_capacity(template, (jobs, ws), slo, lo=lo, hi=hi,
                          duration=HORIZON, device="cpu")
    res = report.result()
    # Brute force: every capacity of the interval in ONE sweep (the
    # lanes batch), first feasible C.
    pts = [SweepPoint("fb", capacity=c, lease_seconds=lease)
           for c in range(lo, hi + 1)]
    rows = run_sweep(pts, jobs, ws, HORIZON, mode="rounds", device="cpu")
    feasible = [slo.satisfied(r, len(jobs)) for r in rows]
    assert feasible[-1] and not feasible[0]
    assert res.capacity == lo + feasible.index(True)
    assert feasible[res.capacity - lo] and not feasible[res.capacity - lo - 1]
    assert res.row == rows[res.capacity - lo]
    assert report.rows_evaluated < len(pts)


def test_pareto_front_and_cost_lens_over_port_rows():
    jobs, ws = tiny_workload()
    pts = [SweepPoint("fb", capacity=c) for c in (32, 64, 96)] + [
        SweepPoint("flb_nub", lb_pbj=13, lb_ws=12, lease_seconds=1800.0)]
    front = pareto_front(pts, jobs, ws, duration=HORIZON, mode="rounds",
                         device="cpu")
    assert len(front.frontier) >= 2
    for p in front.points:
        if not p.on_frontier:
            assert p.dominated_by in front.frontier
    best = CostModel().cheapest(front.frontier_rows())
    assert best.total_usd > 0
