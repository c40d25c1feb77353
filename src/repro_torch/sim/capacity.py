"""Capacity-planning query layer — from evaluation to optimization.

Counterpart of ``repro.sim.capacity`` over the port's sweep
(``repro_torch.sim.sweep``): host logic, with a ``device`` keyword that
every query passes through to the sweep (CUDA by default, the CPU only
when asked for). The rest of this docstring is the reference's.

The paper's headline results are *optimization* answers stated over the
very grids the sweep engines batch: §6.5.3's "a ≈40 % smaller cluster
configuration at the same throughput" is the argmin of capacity C
subject to a completion SLO, and §6.6.3's "up to 31 % lower peak than
EC2+RightScale" compares the optima of two systems. This module turns
``run_sweep_workloads`` into the query engine for such questions:

* :func:`min_capacity` — vectorized bisection for "the minimum capacity
  meeting a throughput/completion SLO". Every bisection iteration runs
  as ONE ``run_sweep_workloads`` batch over all still-active
  (template × workload) lanes: the candidate midpoints of every
  unconverged lane are packed into a single point list (converged lanes
  contribute nothing — they are masked out of the batch), so a grid of
  K templates over W workloads converges in ~log2(hi − lo) batched
  calls instead of (hi − lo) · K · W single evaluations. Composes with
  ``mode="rounds"`` (the batched event-round engine) and
  ``ScanOptions.devices`` sharding like any other sweep.

* :func:`pareto_front` — the non-dominated set of a (C, B, L,
  kill-threshold) policy grid under a configurable objective tuple
  (default: minimize node-hours and peak nodes, maximize completed
  jobs), with the dominating policy recorded for every dominated point.

* :class:`CostModel` / :class:`CostEstimate` — a multi-cloud cost lens:
  per-provider $/node-hour plus a per-adjustment request cost (every
  ``adjust_events`` ledger entry is one provisioning-API round-trip —
  see :func:`repro_torch.core.baselines.billable_requests`), seeded with an
  EC2-on-demand-shaped default. Prices any sweep row, workload mix or
  Pareto frontier and answers "cheapest provider for this mix".

* :func:`headline_queries` — the paper's two §6 numbers reproduced *as
  query outputs* and gated against
  ``repro_torch.sim.contracts.HEADLINE_CONTRACT``.

Monotonicity caveat: bisection assumes SLO feasibility is monotone in
the capacity knob — true at the thresholds the paper sweeps, but the
raw ``completed_jobs`` curve is not perfectly monotone (kill
tie-breaking can cost a job as C grows: FB(133) completes 2528 of the
iPSC trace, FB(134) completes 2527). The guarantee :func:`min_capacity`
makes — and tests/test_capacity.py asserts — is therefore the local
one: the returned capacity is feasible AND its predecessor is
infeasible. Where the feasibility curve has multiple crossings the
query returns one valid crossing, exactly like scalar ``bisect`` on a
non-sorted list.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.baselines import billable_requests
from repro_torch.core.jobs import Job
from repro_torch.sim.sweep import (ScanOptions, SweepPoint,
                                   run_sweep_workloads)

__all__ = ["CapacitySLO", "CapacityResult", "CapacityReport",
           "min_capacity", "ParetoPoint", "ParetoFront", "pareto_front",
           "ProviderRate", "CostEstimate", "CostModel",
           "DEFAULT_PROVIDERS", "headline_queries"]


# ------------------------------------------------------------------ SLOs

@dataclasses.dataclass(frozen=True)
class CapacitySLO:
    """A service-level objective a capacity must meet.

    At least one criterion is required; all given criteria must hold
    simultaneously. ``min_completed`` is an absolute completed-job
    floor, ``min_completed_frac`` a fraction of the workload's job
    count (both are throughput statements — completed jobs over the
    shared §6.1 horizon), ``max_avg_turnaround`` an average-turnaround
    ceiling in seconds (J1 of §6.3).
    """

    min_completed: Optional[int] = None
    min_completed_frac: Optional[float] = None
    max_avg_turnaround: Optional[float] = None

    def __post_init__(self):
        if (self.min_completed is None and self.min_completed_frac is None
                and self.max_avg_turnaround is None):
            raise ValueError("empty SLO: set min_completed, "
                             "min_completed_frac or max_avg_turnaround")
        if (self.min_completed_frac is not None
                and not 0.0 < self.min_completed_frac <= 1.0):
            raise ValueError(
                f"min_completed_frac must be in (0, 1], got "
                f"{self.min_completed_frac}")

    def target_completed(self, n_jobs: int) -> Optional[int]:
        """The effective completed-job floor for a workload of
        ``n_jobs`` jobs (the max of both throughput criteria)."""
        targets = []
        if self.min_completed is not None:
            targets.append(int(self.min_completed))
        if self.min_completed_frac is not None:
            targets.append(int(math.ceil(self.min_completed_frac * n_jobs)))
        return max(targets) if targets else None

    def satisfied(self, row: Dict, n_jobs: int) -> bool:
        """Does a sweep row meet every criterion?"""
        target = self.target_completed(n_jobs)
        if target is not None:
            if "completed_jobs" not in row:
                raise ValueError(
                    f"row for {row.get('system', '?')} carries no "
                    f"completed_jobs (vectorized DCS rows are cost/peak "
                    f"only) — evaluate DCS templates with mode='event'")
            if int(row["completed_jobs"]) < target:
                return False
        if self.max_avg_turnaround is not None:
            if "avg_turnaround" not in row:
                raise ValueError(
                    f"row for {row.get('system', '?')} carries no "
                    f"avg_turnaround — use mode='event' for this "
                    f"template")
            if float(row["avg_turnaround"]) > self.max_avg_turnaround:
                return False
        return True

    def describe(self, n_jobs: int) -> str:
        parts = []
        target = self.target_completed(n_jobs)
        if target is not None:
            parts.append(f"completed_jobs >= {target}")
        if self.max_avg_turnaround is not None:
            parts.append(f"avg_turnaround <= {self.max_avg_turnaround}")
        return " and ".join(parts)


# ------------------------------------------------- the capacity knob

def _with_capacity(template: SweepPoint, c: int) -> SweepPoint:
    """The template at capacity-knob value ``c``: FB's cluster size C,
    FLB-NUB's total pool B = lb_pbj + lb_ws (the template's ``lb_ws``
    caps the WS share, clamped to keep lb_pbj >= 1 — mirroring
    ``paper_grid``'s ``min(lb_ws, B - 1)``), DCS's batch partition
    PRC_PBJ (the web partition stays the template's)."""
    c = int(c)
    if template.system == "fb":
        return dataclasses.replace(template, capacity=c, label="")
    if template.system == "flb_nub":
        w = min(template.lb_ws, max(c - 1, 0))
        return dataclasses.replace(template, lb_pbj=c - w, lb_ws=w,
                                   label="")
    if template.system == "dcs":
        return dataclasses.replace(template, prc_pbj=c, label="")
    raise ValueError(
        f"system {template.system!r} has no capacity knob to bisect "
        f"(EC2+RightScale sizes itself from demand — compare it as a "
        f"baseline row instead)")


def _validate_templates(templates: Sequence[SweepPoint], mode: str):
    for t in templates:
        if t.system == "ec2":
            _with_capacity(t, 1)        # raises with the explanation
        if t.system == "dcs" and mode != "event":
            raise ValueError(
                "DCS templates need mode='event': the vectorized DCS "
                "path computes cost/peak only, and an SLO query needs "
                "completed_jobs")


# ----------------------------------------------------------- bisection

@dataclasses.dataclass(frozen=True)
class CapacityResult:
    """One lane's answer: the minimal feasible capacity-knob value."""

    template: SweepPoint
    template_index: int
    workload: int
    capacity: int                     # minimal feasible knob value
    point: SweepPoint                 # template at that capacity
    row: Dict                         # sweep row at that capacity
    at_grid_edge: bool                # True when capacity == lo (the
    #                                   predecessor was never probed)


@dataclasses.dataclass(frozen=True)
class CapacityReport:
    """A :func:`min_capacity` answer plus its evaluation ledger.

    ``results`` holds one :class:`CapacityResult` per
    (template × workload) lane, workload-major. ``rows_evaluated``
    counts every (point × workload) sweep row the query computed across
    its batches; ``brute_force_rows`` is what a full grid scan of the
    same interval would have cost — the ratio is the query's win and
    the ``benchmarks.run capacity`` ledger records both.
    """

    slo: CapacitySLO
    lo: int
    hi: int
    results: List[CapacityResult]
    iterations: int                   # batched sweep calls issued
    rows_evaluated: int
    brute_force_rows: int

    def result(self, template_index: int = 0,
               workload: int = 0) -> CapacityResult:
        for r in self.results:
            if (r.template_index == template_index
                    and r.workload == workload):
                return r
        raise KeyError((template_index, workload))


def _normalize_workloads(workloads):
    """Accept either one ``(jobs, ws_trace)`` pair or a sequence of
    them (the ``run_sweep_workloads`` shape)."""
    if (len(workloads) == 2 and workloads[0] is not None
            and all(isinstance(j, Job) for j in workloads[0])
            and not isinstance(workloads[1], Job)):
        return [(list(workloads[0]), list(workloads[1]))]
    return [(list(jobs), list(ws)) for jobs, ws in workloads]


def _ws_peak(ws_trace) -> int:
    return max((int(d) for _, d in ws_trace), default=0)


def min_capacity(templates: Union[SweepPoint, Sequence[SweepPoint]],
                 workloads, slo: CapacitySLO, *,
                 lo: int = 1, hi: int,
                 duration: Optional[float] = None,
                 mode: str = "rounds",
                 scan_options: ScanOptions = ScanOptions(),
                 devices=None, device=None,
                 _stack_offset: int = 0) -> CapacityReport:
    """Minimum capacity meeting ``slo``, for every (template × workload)
    lane at once, by batched bisection over the knob interval
    ``[lo, hi]``.

    ``templates`` are :class:`SweepPoint`\\ s whose capacity knob the
    query owns (FB's C, FLB-NUB's pool B, DCS's PRC_PBJ — see
    :func:`_with_capacity`); every other field (lease, U/V/G policy
    params, the DCS web partition) is held fixed, so passing several
    templates sweeps (policy × lease) lanes jointly. ``workloads`` is
    one ``(jobs, ws_trace)`` pair or a list of them.

    The first batch probes ``lo`` and ``hi`` for every lane. A lane
    infeasible at ``hi`` has an *empty* bisection interval — the SLO
    cannot be met on this grid — and raises :class:`ValueError`
    immediately (naming the lane, the shortfall, and the WS-trace peak
    when ``hi`` sits below it: a pool smaller than the web demand peak
    saturates silently and no capacity in the interval can win it
    back). A lane already feasible at ``lo`` returns the grid edge
    (``at_grid_edge=True`` — the predecessor was never probed). Every
    following iteration packs the unconverged lanes' midpoints into one
    ``run_sweep_workloads`` call; converged lanes drop out of the
    batch. Returns a :class:`CapacityReport` whose per-lane results
    satisfy: ``row`` feasible, and capacity−1 infeasible (unless at the
    grid edge).
    """
    if isinstance(templates, SweepPoint):
        templates = [templates]
    templates = list(templates)
    if not templates:
        raise ValueError("min_capacity needs at least one template")
    lo, hi = int(lo), int(hi)
    if lo < 1:
        raise ValueError(f"lo must be >= 1, got {lo}")
    if hi < lo:
        raise ValueError(f"empty capacity interval: hi={hi} < lo={lo}")
    _validate_templates(templates, mode)
    wls = _normalize_workloads(workloads)
    n_jobs = [len(jobs) for jobs, _ in wls]
    W, T = len(wls), len(templates)

    cache: Dict[Tuple[int, int], Dict] = {}   # (ti, c) -> rows per wl
    ledger = {"batches": 0, "rows": 0}

    def evaluate(caps_by_t: Dict[int, set]):
        """ONE sweep batch for all (template, capacity) pairs not yet
        cached; rows land in ``cache`` keyed (ti, c) -> [row per
        workload]."""
        pts, index = [], []
        for ti in sorted(caps_by_t):
            for c in sorted(caps_by_t[ti]):
                if (ti, c) not in cache:
                    pts.append(_with_capacity(templates[ti], c))
                    index.append((ti, c))
        if not pts:
            return
        # 2 frames here (this closure + min_capacity itself), plus any
        # wrappers above us — diagnostics name the user's call site.
        rows = run_sweep_workloads(pts, wls, duration, mode=mode,
                                   scan_options=scan_options,
                                   devices=devices, device=device,
                                   _stack_offset=2 + _stack_offset)
        ledger["batches"] += 1
        ledger["rows"] += len(pts) * W
        for k, key in enumerate(index):
            cache[key] = [rows[w][k] for w in range(W)]

    def feasible(ti: int, wi: int, c: int) -> bool:
        return slo.satisfied(cache[(ti, c)][wi], n_jobs[wi])

    # Bracket batch: lo and hi for every template, all lanes at once.
    evaluate({ti: {lo, hi} for ti in range(T)})

    infeasible_lanes = []
    # Per-lane bisection state: None once converged, else
    # (known_bad, known_good) with known_bad infeasible, known_good
    # feasible, answer in (known_bad, known_good].
    state: Dict[Tuple[int, int], Optional[Tuple[int, int]]] = {}
    answer: Dict[Tuple[int, int], int] = {}
    for ti in range(T):
        for wi in range(W):
            if not feasible(ti, wi, hi):
                row = cache[(ti, hi)][wi]
                got = row.get("completed_jobs")
                peak = _ws_peak(wls[wi][1])
                hint = (f"; note hi={hi} is below the WS trace peak "
                        f"{peak} — the web lane saturates and no "
                        f"capacity in the interval can meet the SLO"
                        if hi < peak else "")
                infeasible_lanes.append(
                    f"{_with_capacity(templates[ti], hi).name()} × "
                    f"workload {wi}: "
                    f"completed {got} at capacity {hi}, SLO needs "
                    f"{slo.describe(n_jobs[wi])}{hint}")
            elif feasible(ti, wi, lo):
                answer[(ti, wi)] = lo
                state[(ti, wi)] = None
            else:
                state[(ti, wi)] = (lo, hi)
    if infeasible_lanes:
        raise ValueError(
            "SLO infeasible at the top of the capacity interval "
            "(empty bisection interval) on "
            f"{len(infeasible_lanes)} lane(s):\n  "
            + "\n  ".join(infeasible_lanes)
            + "\nRaise hi or relax the SLO.")

    # Bisection: one batched sweep per iteration over the union of
    # active lanes' midpoints (converged lanes contribute nothing).
    while True:
        mids: Dict[int, set] = {}
        lane_mid = {}
        for lane, st in state.items():
            if st is None:
                continue
            bad, good = st
            if good - bad <= 1:
                answer[lane] = good
                state[lane] = None
                continue
            mid = (bad + good) // 2
            lane_mid[lane] = mid
            mids.setdefault(lane[0], set()).add(mid)
        if not lane_mid:
            break
        evaluate(mids)
        for lane, mid in lane_mid.items():
            bad, good = state[lane]
            if feasible(lane[0], lane[1], mid):
                state[lane] = (bad, mid)
            else:
                state[lane] = (mid, good)

    results = [CapacityResult(
        template=templates[ti], template_index=ti, workload=wi,
        capacity=answer[(ti, wi)],
        point=_with_capacity(templates[ti], answer[(ti, wi)]),
        row=cache[(ti, answer[(ti, wi)])][wi],
        at_grid_edge=answer[(ti, wi)] == lo)
        for wi in range(W) for ti in range(T)]
    return CapacityReport(
        slo=slo, lo=lo, hi=hi, results=results,
        iterations=ledger["batches"], rows_evaluated=ledger["rows"],
        brute_force_rows=(hi - lo + 1) * T * W)


# ------------------------------------------------------- Pareto front

# Optimization sense per objective: +1 minimizes, -1 maximizes.
_SENSES = {"node_hours": 1.0, "peak_nodes": 1.0, "avg_turnaround": 1.0,
           "avg_execution": 1.0, "adjust_events": 1.0, "kills": 1.0,
           "completed_jobs": -1.0, "throughput": -1.0}


@dataclasses.dataclass(frozen=True)
class ParetoPoint:
    """One grid point of a :class:`ParetoFront`. ``dominated_by`` is
    the index of a frontier point that dominates it (the first such in
    frontier order), or ``None`` when the point is itself on the
    frontier."""

    index: int
    point: Optional[SweepPoint]
    row: Dict
    dominated_by: Optional[int]

    @property
    def on_frontier(self) -> bool:
        return self.dominated_by is None


@dataclasses.dataclass(frozen=True)
class ParetoFront:
    """The non-dominated set of a policy grid under ``objectives``."""

    objectives: Tuple[str, ...]
    points: List[ParetoPoint]
    frontier: Tuple[int, ...]         # indices into ``points``

    def frontier_points(self) -> List[ParetoPoint]:
        return [self.points[i] for i in self.frontier]

    def frontier_rows(self) -> List[Dict]:
        return [self.points[i].row for i in self.frontier]


def pareto_front(points: Optional[Sequence[SweepPoint]] = None,
                 jobs: Optional[Sequence[Job]] = None,
                 ws_trace=None, *,
                 rows: Optional[Sequence[Dict]] = None,
                 objectives: Sequence[str] = ("node_hours", "peak_nodes",
                                              "completed_jobs"),
                 duration: Optional[float] = None,
                 mode: Optional[str] = None,
                 scan_options: ScanOptions = ScanOptions(),
                 devices=None, device=None) -> ParetoFront:
    """Non-dominated set of a policy grid.

    Either pass ``points`` + ``jobs`` + ``ws_trace`` (the grid is
    evaluated through :func:`run_sweep_workloads` — one batch) or
    pre-computed ``rows`` (any row dicts, e.g. a sweep already paid
    for; ``points`` then just labels them). ``objectives`` picks the
    metric tuple; senses come from the metric's meaning (node-hours,
    peak, turnaround, kills and adjust-events minimize; completed jobs
    / throughput maximize). A point dominates another when it is no
    worse on every objective and strictly better on at least one; ties
    on all objectives leave both points on the frontier.
    """
    objectives = tuple(objectives)
    for m in objectives:
        if m not in _SENSES:
            raise ValueError(
                f"unknown objective {m!r}; known: {sorted(_SENSES)}")
    if rows is None:
        if points is None or jobs is None or ws_trace is None:
            raise ValueError(
                "pass either rows=... or points + jobs + ws_trace")
        rows = run_sweep_workloads(list(points), [(jobs, ws_trace)],
                                   duration, mode=mode,
                                   scan_options=scan_options,
                                   devices=devices, device=device,
                                   _stack_offset=1)[0]
    rows = list(rows)
    if not rows:
        raise ValueError("empty grid")
    pts = list(points) if points is not None else [None] * len(rows)
    if len(pts) != len(rows):
        raise ValueError(f"{len(pts)} points vs {len(rows)} rows")

    key = "completed_jobs" if "throughput" in objectives else None
    mat = np.empty((len(rows), len(objectives)))
    for i, row in enumerate(rows):
        for j, m in enumerate(objectives):
            k = key if m == "throughput" else m
            if k not in row:
                raise ValueError(
                    f"row {i} ({row.get('system', '?')}) has no {k!r} "
                    f"metric — vectorized DCS rows are cost/peak only; "
                    f"evaluate that point with mode='event'")
            mat[i, j] = _SENSES[m] * float(row[k])

    # i dominates j: <= everywhere and < somewhere (minimizing view).
    le = (mat[:, None, :] <= mat[None, :, :]).all(axis=-1)
    lt = (mat[:, None, :] < mat[None, :, :]).any(axis=-1)
    dominates = le & lt
    dominated = dominates.any(axis=0)
    frontier = tuple(int(i) for i in np.flatnonzero(~dominated))

    out = []
    for j in range(len(rows)):
        dom_by = None
        if dominated[j]:
            for i in frontier:
                if dominates[i, j]:
                    dom_by = i
                    break
        out.append(ParetoPoint(index=j, point=pts[j], row=rows[j],
                               dominated_by=dom_by))
    return ParetoFront(objectives=objectives, points=out,
                       frontier=frontier)


# ----------------------------------------------------------- cost lens

@dataclasses.dataclass(frozen=True)
class ProviderRate:
    """One provider's pricing: $/node-hour plus $ per provisioning-API
    request (each ``adjust_events`` ledger entry is one request)."""

    name: str
    node_hour_usd: float
    request_usd: float = 0.0

    def __post_init__(self):
        if self.node_hour_usd < 0 or self.request_usd < 0:
            raise ValueError(f"negative rate for {self.name!r}")


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Priced usage: ``total_usd = node_hours·node_hour_usd +
    requests·request_usd``. Estimates for the same provider add
    (workload mixes sum their usage)."""

    provider: str
    node_hours: float
    requests: int
    node_hour_usd: float
    request_usd: float

    @property
    def node_cost_usd(self) -> float:
        return self.node_hours * self.node_hour_usd

    @property
    def request_cost_usd(self) -> float:
        return self.requests * self.request_usd

    @property
    def total_usd(self) -> float:
        return self.node_cost_usd + self.request_cost_usd

    def __add__(self, other: "CostEstimate") -> "CostEstimate":
        if not isinstance(other, CostEstimate):
            return NotImplemented
        if (other.provider != self.provider
                or other.node_hour_usd != self.node_hour_usd
                or other.request_usd != self.request_usd):
            raise ValueError(
                f"cannot add estimates priced under different rates "
                f"({self.provider!r} vs {other.provider!r})")
        return dataclasses.replace(
            self, node_hours=self.node_hours + other.node_hours,
            requests=self.requests + other.requests)


# Stylized 2010-era list-price shapes (the paper's EC2 baseline era:
# an m1.small was $0.085/h on demand, ~$0.031/h effective 3-yr
# reserved). Illustrative defaults, not quotes — pass your own
# ProviderRate tuple for real pricing.
DEFAULT_PROVIDERS: Tuple[ProviderRate, ...] = (
    ProviderRate("ec2-on-demand", node_hour_usd=0.085,
                 request_usd=0.0005),
    ProviderRate("ec2-reserved", node_hour_usd=0.031,
                 request_usd=0.0005),
    ProviderRate("azure-classic", node_hour_usd=0.096,
                 request_usd=0.0),
    ProviderRate("gogrid", node_hour_usd=0.19, request_usd=0.0),
    ProviderRate("private-amortized", node_hour_usd=0.045,
                 request_usd=0.0),
)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Multi-cloud cost lens over sweep rows.

    ``estimate`` prices one row under one provider; ``estimate_mix``
    sums a workload mix; ``compare`` prices the same usage under every
    provider, cheapest first, so ``compare(...)[0]`` answers "cheapest
    provider for this workload mix"; ``price_frontier`` prices every
    point of a :class:`ParetoFront`'s frontier.
    """

    providers: Tuple[ProviderRate, ...] = DEFAULT_PROVIDERS

    def __post_init__(self):
        if not self.providers:
            raise ValueError("CostModel needs at least one provider")
        names = [p.name for p in self.providers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate provider names in {names}")

    def rate(self, provider: Optional[str] = None) -> ProviderRate:
        if provider is None:
            return self.providers[0]
        for p in self.providers:
            if p.name == provider:
                return p
        raise ValueError(
            f"unknown provider {provider!r}; have "
            f"{[p.name for p in self.providers]}")

    @staticmethod
    def _usage(row) -> Tuple[float, int]:
        nh = float(row["node_hours"]) if isinstance(row, dict) \
            else float(getattr(row, "node_hours"))
        return nh, billable_requests(row)

    def estimate(self, row,
                 provider: Optional[str] = None) -> CostEstimate:
        r = self.rate(provider)
        nh, req = self._usage(row)
        return CostEstimate(provider=r.name, node_hours=nh,
                            requests=req, node_hour_usd=r.node_hour_usd,
                            request_usd=r.request_usd)

    def estimate_mix(self, rows,
                     provider: Optional[str] = None) -> CostEstimate:
        r = self.rate(provider)
        est = CostEstimate(provider=r.name, node_hours=0.0, requests=0,
                           node_hour_usd=r.node_hour_usd,
                           request_usd=r.request_usd)
        for row in rows:
            est = est + self.estimate(row, r.name)
        return est

    def compare(self, rows) -> List[CostEstimate]:
        """Price the same usage under every provider, cheapest first
        (ties keep provider-table order). ``rows`` is one row or a
        mix."""
        if isinstance(rows, dict) or hasattr(rows, "node_hours"):
            rows = [rows]
        ests = [self.estimate_mix(rows, p.name) for p in self.providers]
        return sorted(ests, key=lambda e: e.total_usd)

    def cheapest(self, rows) -> CostEstimate:
        return self.compare(rows)[0]

    def price_frontier(self, front: ParetoFront,
                       provider: Optional[str] = None
                       ) -> List[Tuple[int, CostEstimate]]:
        return [(i, self.estimate(front.points[i].row, provider))
                for i in front.frontier]


# ----------------------------------------------------- headline queries

def headline_queries(*, tiny: bool = False, mode: str = "rounds",
                     scan_options: ScanOptions = ScanOptions(),
                     devices=None, device=None) -> Dict:
    """The paper's two §6 claims answered as capacity queries.

    **Private cloud (§6.5.3 / Fig. 13):** how much smaller a cluster
    does the FB PhoenixCloud system need than the dedicated DCS
    partition, at the *same* completed-job throughput? Computed as
    ``1 − min_capacity(FB, SLO=DCS throughput) / DCS size`` on the
    moment-matched iPSC/860 + WorldCup'98 pair. Paper: ≈40 %.

    **Public cloud (§6.6.3):** how much lower is FLB-NUB's peak
    resource consumption than the EC2+RightScale baseline on the same
    workload? Computed as ``1 − peak(FLB-NUB) / peak(EC2)``. Paper: up
    to 31 %.

    Full-size numbers are gated against
    ``repro_torch.sim.contracts.HEADLINE_CONTRACT`` (violations land in the
    returned dict, they do not raise). ``tiny=True`` shrinks to the CI
    two-day slice — the query plumbing runs end-to-end but the horizon
    is far off §6.1's two weeks, so the band gate is skipped and
    ``gate['checked']`` is False.
    """
    from repro_torch.sim import traces
    from repro_torch.sim.contracts import HEADLINE_CONTRACT

    if tiny:
        horizon = 2 * 24 * 3600.0
        peak_vms = 64
        prc_pbj = prc_ws = 64
        jobs = [j for j in traces.nasa_ipsc(seed=0) if j.submit < horizon]
        ws = [(t, d) for t, d in traces.worldcup98(seed=0,
                                                   peak_vms=peak_vms)
              if t < horizon]
        flb_B, ec2_lease = 25, 3600.0
    else:
        horizon = traces.TWO_WEEKS
        prc_pbj = prc_ws = 128
        jobs = traces.nasa_ipsc(seed=0)
        ws = traces.worldcup98(seed=0, peak_vms=128)
        flb_B, ec2_lease = 25, 3600.0

    dcs_size = prc_pbj + prc_ws

    # Private cloud: DCS reference throughput needs completed_jobs, so
    # the single DCS row runs the event engine; the FB bisection lanes
    # batch through the requested fast path.
    dcs_row = run_sweep_workloads(
        [SweepPoint("dcs", prc_pbj=prc_pbj, prc_ws=prc_ws)],
        [(jobs, ws)], horizon, mode="event", device=device,
        _stack_offset=1)[0][0]
    target = int(dcs_row["completed_jobs"])
    report = min_capacity(
        SweepPoint("fb"), (jobs, ws),
        CapacitySLO(min_completed=target),
        lo=1, hi=dcs_size, duration=horizon, mode=mode,
        scan_options=scan_options, devices=devices, device=device,
        _stack_offset=1)
    fb = report.results[0]
    config_reduction = 1.0 - fb.capacity / dcs_size

    # Public cloud: FLB-NUB vs the EC2+RightScale baseline at the
    # paper's Fig. 14 pool size; EC2 rows ride the exact vectorized
    # path in every non-event mode.
    w = min(12, flb_B - 1)
    flb_row, ec2_row = run_sweep_workloads(
        [SweepPoint("flb_nub", lb_pbj=flb_B - w, lb_ws=w),
         SweepPoint("ec2", lease_seconds=ec2_lease)],
        [(jobs, ws)], horizon, mode=mode, scan_options=scan_options,
        devices=devices, device=device, _stack_offset=1)[0]
    peak_reduction = 1.0 - (float(flb_row["peak_nodes"])
                            / float(ec2_row["peak_nodes"]))

    violations = [] if tiny else HEADLINE_CONTRACT.check(
        config_reduction, peak_reduction)
    return {
        "tiny": tiny,
        "private": {
            "dcs_size": dcs_size,
            "dcs_completed": target,
            "min_fb_capacity": fb.capacity,
            "fb_completed": int(fb.row["completed_jobs"]),
            "config_reduction": round(config_reduction, 4),
            "iterations": report.iterations,
            "rows_evaluated": report.rows_evaluated,
            "brute_force_rows": report.brute_force_rows,
        },
        "public": {
            "flb_B": flb_B,
            "flb_peak": int(flb_row["peak_nodes"]),
            "ec2_peak": int(ec2_row["peak_nodes"]),
            "peak_reduction": round(peak_reduction, 4),
        },
        "gate": {
            "checked": not tiny,
            "contract": dataclasses.asdict(HEADLINE_CONTRACT),
            "violations": violations,
            "ok": not violations,
        },
    }
