"""Per-engine fidelity contracts — the single source of truth.

Every fast path of the sweep engine is validated against the
discrete-event reference (``repro.sim.engine.run_sim``), each with its
own tolerance band:

* the fixed-``dt`` **scan** is approximate by time discretization —
  completed jobs within 2 %, node-hours and peak within 15 %;
* the event-round **rounds** engine (coalesced or not) replays events
  at exact times — completed jobs must match EXACTLY (and completion
  times bit-match in float64), node-hours and peak within 5 % (the
  residue is first-fit pass convergence and §5.1 kill tie-breaking,
  not discretization);
* the **vectorized** DCS/EC2 baselines are closed-form — exact to
  round-off (integer metrics equal, node-hours to ~1e-9 relative);
* the **live** serving stack replayed over a trace
  (``repro.serving.replay``) shares the event pump with the reference,
  so completions are exact; its extra degrees of freedom — the §6.4
  autoscaler deriving demand from traffic instead of reading the trace
  — are bounded by :func:`demand_drift` (``LiveContract``);
* the **faults** chaos tier (``repro.sim.faults``) replays one fault
  schedule through all three paths. Event-vs-live is exact (same pump).
  Event-vs-rounds keeps node-hours and peak in tight bands but allows
  ±``completed_abs`` completed jobs: at a fault instant both engines
  free the same node count, but kill-victim tie-breaking can requeue
  different jobs and shift which ones finish inside the horizon
  (measured: node-hours/peak exact, completions ±1–2 on heavily
  contended workloads). ``FaultContract`` also states the recovery
  invariant itself: :func:`no_lost_jobs` — every submitted job is
  either completed or still tracked (queued/running), never dropped by
  a failure.

Both the test suite (tests/test_engine_differential.py) and the CI
benchmark gate (``benchmarks/run.py sweep --check-fidelity``) import
THIS table, so the gate and the tests cannot drift apart: a contract
change is one edit, reviewed once, enforced everywhere.
"""

from __future__ import annotations

import dataclasses

__all__ = ["EngineContract", "LiveContract", "FaultContract",
           "HeadlineContract", "SCAN_CONTRACT", "ROUNDS_CONTRACT",
           "VECTORIZED_CONTRACT", "LIVE_CONTRACT", "FAULT_CONTRACT",
           "HEADLINE_CONTRACT", "CONTRACTS",
           "check_fidelity", "demand_drift", "no_lost_jobs"]


@dataclasses.dataclass(frozen=True)
class EngineContract:
    """Tolerances of one engine vs the event reference: relative drift
    bounds per metric, plus whether completed-job counts must be exact
    (a stronger statement than ``completed_rel == 0`` — it is asserted
    on the integer counts, with no epsilon)."""

    completed_rel: float
    node_hours_rel: float
    peak_rel: float
    completed_exact: bool = False

    def check_row(self, fast: dict, event: dict) -> list:
        """Compare one sweep row against its event-engine reference.
        Returns a list of violation strings (empty = within contract).
        """
        violations = []
        ev_jobs = event["completed_jobs"]
        dj = abs(fast["completed_jobs"] - ev_jobs) / max(1, ev_jobs)
        if self.completed_exact:
            if fast["completed_jobs"] != ev_jobs:
                violations.append(
                    f"completed_jobs {fast['completed_jobs']} != "
                    f"{ev_jobs} (exact contract)")
        elif dj > self.completed_rel:
            violations.append(
                f"completed_jobs drift {dj:.4f} > {self.completed_rel}")
        dn = abs(fast["node_hours"] - event["node_hours"]) \
            / max(1e-9, event["node_hours"])
        if dn > self.node_hours_rel:
            violations.append(
                f"node_hours drift {dn:.4f} > {self.node_hours_rel}")
        dp = abs(fast["peak_nodes"] - event["peak_nodes"]) \
            / max(1, event["peak_nodes"])
        if dp > self.peak_rel:
            violations.append(
                f"peak_nodes drift {dp:.4f} > {self.peak_rel}")
        return violations


def demand_drift(live: list, ref: list, duration: float) -> tuple:
    """Time-weighted drift between two step series ``[(t, value), ...]``
    (each value holds from its breakpoint to the next). Returns
    ``(mae_rel, peak_rel)``: the integral of ``|live - ref|`` over the
    union of breakpoints, normalized by the reference's own integral,
    and the relative error of the peaks. This is the §6.4 question
    stated as a number: how closely does utilization-driven instance
    adjustment re-derive the demand trace it is serving?"""

    def value_at(series, t):
        v = 0
        for bt, bv in series:
            if bt <= t:
                v = bv
            else:
                break
        return v

    live = sorted(live)
    ref = sorted(ref)
    points = sorted({0.0, duration}
                    | {t for t, _ in live if t < duration}
                    | {t for t, _ in ref if t < duration})
    abs_area = 0.0
    ref_area = 0.0
    for t0, t1 in zip(points, points[1:]):
        dt = t1 - t0
        abs_area += abs(value_at(live, t0) - value_at(ref, t0)) * dt
        ref_area += value_at(ref, t0) * dt
    mae_rel = abs_area / max(1e-9, ref_area)
    peak_live = max((v for _, v in live), default=0)
    peak_ref = max((v for _, v in ref), default=0)
    peak_rel = abs(peak_live - peak_ref) / max(1, peak_ref)
    return mae_rel, peak_rel


@dataclasses.dataclass(frozen=True)
class LiveContract(EngineContract):
    """The live-stack contract: the row tolerances of EngineContract
    plus bounds on the autoscaler-derived demand curve vs the replayed
    trace. ``demand_mae_rel`` absorbs the adjustment lag (one sampling
    window per demand step) and the ±1 flap when utilization sits at
    the calibrated ~0.78 equilibrium just under the 80 % threshold;
    ``demand_peak_rel`` bounds transient overshoot at surge ramps."""

    demand_mae_rel: float = 0.25
    demand_peak_rel: float = 0.25

    def check_live(self, live: dict, event: dict, live_demand: list,
                   ref_demand: list, duration: float) -> list:
        violations = self.check_row(live, event)
        mae, peak = demand_drift(live_demand, ref_demand, duration)
        if mae > self.demand_mae_rel:
            violations.append(
                f"demand MAE drift {mae:.4f} > {self.demand_mae_rel}")
        if peak > self.demand_peak_rel:
            violations.append(
                f"demand peak drift {peak:.4f} > {self.demand_peak_rel}")
        return violations


@dataclasses.dataclass(frozen=True)
class FaultContract(EngineContract):
    """The chaos tier's rounds-vs-event contract. Node-hours and peak
    stay in the tight rounds bands (failures change *capacity*, which
    both engines account identically), but completed jobs get an
    absolute ±``completed_abs`` allowance on top of the relative band:
    kill-victim tie-breaking at fault instants frees the same node
    count either way yet can requeue different jobs, shifting which
    ones finish inside the horizon. A row passes the completion check
    if it is within EITHER bound — the absolute slack covers tiny
    heavily-contended workloads where one job is a large fraction."""

    completed_abs: int = 2

    def check_row(self, fast: dict, event: dict) -> list:
        violations = []
        ev_jobs = event["completed_jobs"]
        dj_abs = abs(fast["completed_jobs"] - ev_jobs)
        dj_rel = dj_abs / max(1, ev_jobs)
        if dj_abs > self.completed_abs and dj_rel > self.completed_rel:
            violations.append(
                f"completed_jobs drift {dj_abs} jobs ({dj_rel:.4f} rel) "
                f"> max({self.completed_abs} abs, "
                f"{self.completed_rel} rel)")
        dn = abs(fast["node_hours"] - event["node_hours"]) \
            / max(1e-9, event["node_hours"])
        if dn > self.node_hours_rel:
            violations.append(
                f"node_hours drift {dn:.4f} > {self.node_hours_rel}")
        dp = abs(fast["peak_nodes"] - event["peak_nodes"]) \
            / max(1, event["peak_nodes"])
        if dp > self.peak_rel:
            violations.append(
                f"peak_nodes drift {dp:.4f} > {self.peak_rel}")
        return violations


def no_lost_jobs(jobs, system) -> list:
    """The recovery invariant of the chaos tier: after a run with
    failures, every submitted job is either completed or still tracked
    by the PBJ manager (queued or running) — a node failure may delay a
    job arbitrarily, but may never *drop* it. Returns violation strings
    (empty = invariant holds)."""
    tracked = {j.jid for j in system.pbj.queue}
    tracked |= {j.jid for j in system.pbj.running.jobs()}
    violations = []
    for j in jobs:
        if not j.completed and j.jid not in tracked:
            violations.append(
                f"job {j.jid} lost: not completed, not queued, "
                f"not running (kills={j.kills})")
    return violations


@dataclasses.dataclass(frozen=True)
class HeadlineContract:
    """Bands for the §6 headline numbers *as query outputs* — the
    capacity layer (``repro.sim.capacity.headline_queries``) answers the
    paper's two claims as optimization queries and this contract states
    how far the answers may sit from the paper.

    ``config_reduction``: §6.5.3 / Fig. 13 — the private-cloud FB system
    needs a ≈40 % smaller cluster configuration than DCS at the same
    completed-job throughput. The reproduction's moment-matched
    iPSC/860 + WorldCup'98 pair measures 0.473 (min feasible C = 135 vs
    the DCS size 256). The floor is the paper's own claim — the query
    must demonstrate AT LEAST the 40 % saving — and the ceiling guards
    against a degenerate workload making the query trivially easy.

    ``peak_reduction``: §6.6.3 — FLB-NUB's peak resource consumption is
    "up to 31 %" lower than the EC2+RightScale baseline. Measured 0.386
    on the iPSC pair and 0.337 on NASA BLUE. The floor is the paper's
    31 % minus the rounds engine's 5 % peak band (0.31 · 0.95 ≈ 0.29,
    rounded down to 0.28); the ceiling is a sanity bound.
    """

    config_reduction_lo: float = 0.40
    config_reduction_hi: float = 0.55
    peak_reduction_lo: float = 0.28
    peak_reduction_hi: float = 0.45

    def check(self, config_reduction: float,
              peak_reduction: float) -> list:
        """Returns violation strings (empty = both §6 numbers land in
        band)."""
        violations = []
        if not (self.config_reduction_lo <= config_reduction
                <= self.config_reduction_hi):
            violations.append(
                f"config_reduction {config_reduction:.4f} outside "
                f"[{self.config_reduction_lo}, {self.config_reduction_hi}]"
                f" (§6.5.3 claims ≈40 %)")
        if not (self.peak_reduction_lo <= peak_reduction
                <= self.peak_reduction_hi):
            violations.append(
                f"peak_reduction {peak_reduction:.4f} outside "
                f"[{self.peak_reduction_lo}, {self.peak_reduction_hi}]"
                f" (§6.6.3 claims up to 31 %)")
        return violations


SCAN_CONTRACT = EngineContract(completed_rel=0.02, node_hours_rel=0.15,
                               peak_rel=0.15)
ROUNDS_CONTRACT = EngineContract(completed_rel=0.0, node_hours_rel=0.05,
                                 peak_rel=0.05, completed_exact=True)
VECTORIZED_CONTRACT = EngineContract(completed_rel=0.0,
                                     node_hours_rel=1e-9, peak_rel=0.0,
                                     completed_exact=True)
# Live replay vs the event simulator on one trace: both run the same
# heap/clock/ProvisioningSystem (the pump), so job completions must
# match exactly; node-hours/peak drift only through the autoscaler's
# demand lag (measured ≤2 % node-hours and 2.5–17 % demand MAE across
# the BENCH_live lanes — the band leaves headroom for trace-shaped
# transients).
LIVE_CONTRACT = LiveContract(completed_rel=0.0, node_hours_rel=0.10,
                             peak_rel=0.10, completed_exact=True,
                             demand_mae_rel=0.25, demand_peak_rel=0.25)
# Chaos tier, rounds-vs-event: node-hours/peak measured exact across
# the randomized differential (the pack clamps nominal failures to the
# ledger's per-capacity clamp), banded at 2 % for float headroom;
# completions allow ±2 jobs or 2 % for kill-victim tie-breaking.
# Event-vs-LIVE under the same schedule shares the pump and stays under
# LIVE_CONTRACT's exact-completion check — no separate band.
FAULT_CONTRACT = FaultContract(completed_rel=0.02, node_hours_rel=0.02,
                               peak_rel=0.02, completed_abs=2)
# The §6 headline numbers as capacity-query outputs — gated by
# tests/test_capacity.py and ``benchmarks.run capacity``.
HEADLINE_CONTRACT = HeadlineContract()

# Keyed by the ``engine`` tag run_sweep puts on each row; "queries"
# keys the capacity layer's headline gate.
CONTRACTS = {
    "scan": SCAN_CONTRACT,
    "rounds": ROUNDS_CONTRACT,
    "vectorized": VECTORIZED_CONTRACT,
    "live": LIVE_CONTRACT,
    "faults": FAULT_CONTRACT,
    "queries": HEADLINE_CONTRACT,
}


def check_fidelity(fast_rows, event_rows) -> list:
    """Check aligned row lists (same sweep points, same order) against
    each fast row's engine contract. ``event`` rows are skipped (the
    reference cannot drift from itself). Returns violation strings
    tagged with the offending system."""
    violations = []
    for fast, ev in zip(fast_rows, event_rows):
        if fast is None or fast["engine"] == "event":
            continue
        contract = CONTRACTS[fast["engine"]]
        for v in contract.check_row(fast, ev):
            violations.append(f"{fast['system']}: {v}")
    return violations
