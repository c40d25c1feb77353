"""Synthetic workload traces, moment-matched to the paper's inputs (§6.2).

The original archives (Parallel Workloads Archive NASA-iPSC-1993 /
SDSC-BLUE-2000, HP World Cup '98) are not redistributable in this offline
container, so we synthesize traces that match every statistic the paper
reports and uses:

  * **NASA iPSC**: 128-node cluster, two weeks, 46.6 % utilization,
    ~2603 completed jobs (Table 1 DCS row), mean execution ≈ 573 s,
    power-of-two job sizes (iPSC/860 hypercube), bursty diurnal arrivals.
  * **SDSC BLUE**: 144 nodes (the paper divides the 8-CPU nodes by 8),
    two weeks, 76.2 % utilization, ~2657 jobs, mean execution ≈ 1975 s.
  * **World Cup '98**: a two-week VM-demand series with peak 64 VMs
    (the paper's Fig. 10 resource-consumption trace), strong diurnal
    pattern plus match-window surges (high peak/normal ratio — the
    property §6.2 highlights).

Utilization is matched *exactly* by rescaling runtimes after sampling so
that Σ size·runtime = util · nodes · duration; all other moments are
matched to within sampling noise. Every generator is deterministic given
``seed``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.jobs import Job

TWO_WEEKS = 14 * 24 * 3600.0


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    name: str
    nodes: int              # original cluster size == PRC of the raw trace
    utilization: float
    n_jobs: int
    mean_runtime: float
    duration: float = TWO_WEEKS


NASA_IPSC = TraceSpec("nasa_ipsc", nodes=128, utilization=0.466,
                      n_jobs=2603, mean_runtime=573.0)
SDSC_BLUE = TraceSpec("sdsc_blue", nodes=144, utilization=0.762,
                      n_jobs=2657, mean_runtime=1975.0)


def _arrivals(rng: np.random.Generator, n: int, duration: float) -> np.ndarray:
    """Bursty diurnal arrival process with deep night/weekend troughs.

    Real archive traces (and the paper's near-zero DCS queueing at 46.6 %
    utilization) imply the queue fully drains at night: arrivals collapse
    outside working hours. A moderate fraction of jobs arrives in short
    bursts (parameter sweeps) — bursts are what make the EC2 baseline's
    peak consumption several times PhoenixCloud's (§6.7: "two or three in
    our experiments"), since on EC2 every submitted job runs immediately.
    """
    n_burst = int(0.12 * n)
    n_base = n - n_burst
    # Diurnal thinning: rate ∝ 1 + 0.95·sin(work-day phase), ~35 % on
    # weekends — nights and weekends nearly drain the queue.
    t = rng.uniform(0, duration, size=6 * n_base)
    day_phase = 2 * np.pi * ((t % 86400.0) / 86400.0 - 0.375)
    keep_p = (1 + 0.95 * np.sin(day_phase)) / 1.95
    weekend = ((t // 86400.0).astype(int) % 7) >= 5
    keep_p = np.where(weekend, keep_p * 0.35, keep_p)
    t = t[rng.uniform(size=t.shape) < keep_p][:n_base]
    # Bursts: ~30 small episodes (parameter sweeps), daytime-weighted.
    episodes = int(rng.integers(24, 40))
    centers = rng.uniform(0, duration, size=3 * episodes)
    c_phase = 2 * np.pi * ((centers % 86400.0) / 86400.0 - 0.375)
    centers = centers[np.sin(c_phase) > -0.2][:episodes]
    weights = rng.dirichlet(np.ones(len(centers)))
    counts = rng.multinomial(n_burst, weights)
    bursts = [c + rng.exponential(180.0, size=k)
              for c, k in zip(centers, counts)]
    out = np.concatenate([t] + bursts)
    out = np.clip(out, 0, duration - 1.0)
    out.sort()
    return out[:n]


_SIZE_EXPS = np.arange(8)           # 1 .. 128, powers of two


def _sample_jobs(spec: TraceSpec, size_probs: np.ndarray, alpha: float,
                 sigma: float, seed: int,
                 arch_pool: Tuple[str, ...] = ()) -> List[Job]:
    """Sample jobs with archive-like structure.

    Real archive traces are dominated by *small* jobs, while runtimes grow
    with job size (big parallel runs are long runs): mean runtime ∝
    size^alpha. ``alpha`` is calibrated so that E[size·rt]/E[rt] matches
    util·nodes·duration / (n_jobs·mean_rt) — i.e. both the paper's
    utilization and its mean execution time hold simultaneously. A final
    global rescale pins utilization exactly.
    """
    rng = np.random.default_rng(seed)
    n = spec.n_jobs
    submit = _arrivals(rng, n, spec.duration)
    n = len(submit)
    sizes = 2 ** rng.choice(_SIZE_EXPS, size=n, p=size_probs)
    sizes = np.minimum(sizes, spec.nodes)
    # Lognormal runtimes, mean growing with size^alpha.
    mean_rt = sizes.astype(float) ** alpha
    mu = np.log(mean_rt) - sigma ** 2 / 2
    runtimes = rng.lognormal(mu, sigma)
    # Exact utilization match: one global rescale.
    target = spec.utilization * spec.nodes * spec.duration
    runtimes *= target / float(np.sum(sizes * runtimes))
    runtimes = np.maximum(runtimes, 1.0)
    # Full-machine jobs run in the nightly dedicated window (a documented
    # property of the iPSC archive: full-cube runs were queued for night
    # slots). Snap their submissions to ~02:00 ± 2 h.
    full = sizes >= spec.nodes
    if np.any(full):
        day = (submit[full] // 86400.0) * 86400.0
        submit = submit.copy()
        submit[full] = day + 2 * 3600.0 + rng.uniform(-7200, 7200,
                                                      size=int(full.sum()))
        submit = np.clip(submit, 0, spec.duration - 1.0)
        order = np.argsort(submit)
        submit, sizes, runtimes = submit[order], sizes[order], runtimes[order]
    archs = (list(arch_pool) * (n // max(1, len(arch_pool)) + 1))[:n] \
        if arch_pool else [None] * n
    return [Job(jid=i, submit=float(submit[i]), size=int(sizes[i]),
                runtime=float(runtimes[i]), arch=archs[i])
            for i in range(n)]


def nasa_ipsc(seed: int = 0, arch_pool: Tuple[str, ...] = ()) -> List[Job]:
    """~46.6 % utilization, low-load trace (mean rt ≈ 573 s; ~3 % of jobs
    use the full 128 nodes, matching the ~50 jobs that never complete in
    the paper's PhoenixCloud(128) row of Table 1)."""
    probs = np.array([.20, .15, .13, .12, .12, .12, .13, .03])
    return _sample_jobs(NASA_IPSC, probs, alpha=0.68, sigma=1.0, seed=seed,
                        arch_pool=arch_pool)


def sdsc_blue(seed: int = 0, arch_pool: Tuple[str, ...] = ()) -> List[Job]:
    """~76.2 % utilization, high-load trace (mean rt ≈ 1975 s)."""
    probs = np.array([.20, .15, .13, .12, .12, .12, .13, .03])
    return _sample_jobs(SDSC_BLUE, probs, alpha=0.15, sigma=1.0, seed=seed,
                        arch_pool=arch_pool)


def _scale_count(d: int, prc: int, prc0: int) -> int:
    """``max(1, round(d · prc / prc0))`` in exact integer arithmetic
    (round half up). Exactness makes scaling involutive for upscales:
    with ``f = prc/prc0 > 1``, ``|d' − d·f| ≤ 1/2`` implies
    ``|d'/f − d| < 1/2`` strictly, so scaling to ``prc`` and back to
    ``prc0`` reproduces ``d`` under ANY nearest rounding — and distinct
    demands stay distinct (``(d2 − d1)·f > 1``), so ``scale_ws``'s
    duplicate-merge drops nothing on the way up. The float
    ``int(round(d * (prc/prc0)))`` this replaces drifts on the way back
    when ``d·prc/prc0`` lands within an ulp of a half-integer."""
    return max(1, (2 * d * prc + prc0) // (2 * prc0))


def scale_jobs(jobs: List[Job], prc: int, prc0: int) -> List[Job]:
    """§6.3 'synthetic heterogeneous workloads': scale a PBJ trace so its
    peak resource demand is ``prc`` instead of ``prc0`` (constant factor on
    job sizes). Upscale round trips exactly: ``scale_jobs(scale_jobs(jobs,
    prc, prc0), prc0, prc)`` reproduces the original sizes for
    ``prc >= prc0`` (see :func:`_scale_count`)."""
    return [Job(jid=j.jid, submit=j.submit,
                size=_scale_count(j.size, prc, prc0), runtime=j.runtime,
                arch=j.arch)
            for j in jobs]


# --------------------------------------------------------------------- WS

def worldcup98(seed: int = 0, peak_vms: int = 64,
               step_seconds: float = 300.0,
               duration: float = TWO_WEEKS) -> List[Tuple[float, int]]:
    """VM-demand step series shaped like the paper's Fig. 10.

    Diurnal base load plus match-window surges; peak is exactly
    ``peak_vms``. Returns a list of (time, demand) change points starting
    at t=0.
    """
    rng = np.random.default_rng(seed + 7)
    t = np.arange(0.0, duration, step_seconds)
    day = (t % 86400.0) / 86400.0
    base = 10 + 6 * np.sin(2 * np.pi * (day - 0.3))          # diurnal 4..16
    base += rng.normal(0, 0.8, size=t.shape)                 # jitter
    surge = np.zeros_like(t)
    n_matches = 12
    match_days = rng.choice(np.arange(1, 14), size=n_matches, replace=True)
    for d in match_days:
        start = d * 86400.0 + rng.uniform(12, 20) * 3600.0   # afternoon/evening
        length = rng.uniform(1.5, 3.5) * 3600.0
        amp = rng.uniform(22, 55)
        ramp = rng.uniform(0.15, 0.3) * length
        rel = t - start
        up = np.clip(rel / ramp, 0, 1)
        down = np.clip((length - rel) / ramp, 0, 1)
        surge += amp * np.clip(np.minimum(up, down), 0, 1)
    demand = np.maximum(base + surge, 1.0)
    demand *= peak_vms / demand.max()                        # exact peak
    demand = np.maximum(np.round(demand).astype(int), 1)
    # Compress to change points.
    out: List[Tuple[float, int]] = [(0.0, int(demand[0]))]
    for i in range(1, len(t)):
        if demand[i] != out[-1][1]:
            out.append((float(t[i]), int(demand[i])))
    return out


def scale_ws(trace: List[Tuple[float, int]], prc: int,
             prc0: int = 64) -> List[Tuple[float, int]]:
    """Scale a WS demand trace to peak ``prc`` (constant factor, §6.3).
    Upscale round trips exactly: ``scale_ws(scale_ws(tr, prc, prc0),
    prc0, prc)`` reproduces the original series for ``prc >= prc0``
    (distinct demands stay distinct, so no change points merge — see
    :func:`_scale_count`)."""
    out: List[Tuple[float, int]] = []
    for t, d in trace:
        nd = _scale_count(d, prc, prc0)
        if not out or nd != out[-1][1]:
            out.append((t, nd))
    return out


# On-device generator family (JAX) — lazily forwarded so this module
# stays importable with numpy alone (repro.sim promises traces-without-
# jax); the generators live in repro.sim.scenarios.
_SCENARIO_NAMES = ("PBJParams", "WSParams", "ScenarioGrid",
                   "SynthesizedBatch", "NASA_IPSC_PBJ", "SDSC_BLUE_PBJ",
                   "WORLDCUP_WS", "synth_pbj", "synth_ws", "lane_keys",
                   "synthesize", "pack_scenarios", "sample_workloads")


def __getattr__(name: str):
    if name in _SCENARIO_NAMES:
        from repro_torch.sim import scenarios
        return getattr(scenarios, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
