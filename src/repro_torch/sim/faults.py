"""Deterministic fault-injection schedules — the chaos tier's input.

A :class:`FaultSchedule` is a fixed-shape FAIL/REPAIR event table:
sorted times plus signed node deltas (+k = k nodes fail at t, -k =
k nodes repaired). Schedules are generated **up front** from a PRNG key
(``np.random.PCG64``), never sampled during simulation, so the same
schedule replays bit-identically through all three execution paths:

* the event engine (``run_sim(..., faults=...)`` → ``EventPump.add_faults``
  → ``ProvisioningSystem.on_fail/on_repair``),
* the rounds engine (``pack_event_workloads(..., faults=...)`` folds the
  fault instants into the jump-to-next-event horizon and turns the
  scalar capacity C into the time-varying ``max(C - failed(t), 0)``),
* the live bridge (``LiveCloud.inject_faults`` pushes the same events
  into the shared pump).

Three generator families cover the MTBF models the reliability surveys
treat as standard: per-node exponential renewal, per-node Weibull
(aging hardware — increasing hazard for shape > 1), and correlated
bursts (a rack/switch domain taking k nodes down at once).

numpy-only on purpose: importable wherever the event engine is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["FaultSchedule", "exponential_schedule", "weibull_schedule",
           "burst_schedule", "merge_schedules"]


@dataclasses.dataclass(frozen=True, eq=False)
class FaultSchedule:
    """Fixed-shape failure event table.

    ``times``  — (E,) float64, sorted ascending, all > 0;
    ``deltas`` — (E,) int64, +k nodes fail / -k nodes repaired; the
    running sum (concurrently-failed count) never goes negative.
    Repairs may land beyond any measurement horizon (a node that dies
    near the end simply stays down); consumers clamp to their own
    duration.
    """

    times: np.ndarray
    deltas: np.ndarray

    def __post_init__(self):
        t = np.asarray(self.times, dtype=np.float64).reshape(-1)
        d = np.asarray(self.deltas, dtype=np.int64).reshape(-1)
        if t.shape != d.shape:
            raise ValueError(f"times {t.shape} / deltas {d.shape} mismatch")
        if t.size and np.any(np.diff(t) < 0):
            raise ValueError("fault times must be sorted ascending")
        if np.any(t <= 0):
            raise ValueError("fault events must have t > 0")
        if np.any(d == 0):
            raise ValueError("fault deltas must be nonzero")
        if t.size and np.any(np.cumsum(d) < 0):
            raise ValueError("repairs exceed concurrent failures")
        object.__setattr__(self, "times", t)
        object.__setattr__(self, "deltas", d)

    def __len__(self) -> int:
        return int(self.times.size)

    def events(self) -> Iterator[Tuple[float, int]]:
        """Iterate ``(t, delta)`` pairs in time order (pump format)."""
        for t, d in zip(self.times, self.deltas):
            yield float(t), int(d)

    def failed_series(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(times, failed_after)``: the concurrently-failed count in
        effect immediately *after* each event time (a right-continuous
        step series starting at 0 before the first event)."""
        return self.times, np.cumsum(self.deltas)

    def max_concurrent(self) -> int:
        if not len(self):
            return 0
        return int(max(0, np.max(np.cumsum(self.deltas))))

    def clamp(self, capacity: int) -> "FaultSchedule":
        """Replay the site ledger's clamp (``Cluster.fail_nodes`` /
        ``repair_nodes``): at most ``capacity`` nodes can be down at
        once, and a repair only revives actually-failed nodes. Returns
        the schedule of *effective* deltas — the series the event engine
        applies — with zero-effect events dropped (the event engine
        treats those as no-ops too)."""
        times: List[float] = []
        deltas: List[int] = []
        failed = 0
        for t, d in self.events():
            eff = min(d, capacity - failed) if d > 0 else -min(-d, failed)
            if eff:
                failed += eff
                times.append(t)
                deltas.append(eff)
        return FaultSchedule(np.asarray(times, np.float64),
                             np.asarray(deltas, np.int64))


# ------------------------------------------------------------ generators


def _renewal(rng: np.random.Generator, duration: float,
             draw_up: Callable[[], float],
             draw_down: Callable[[], float]) -> List[Tuple[float, int]]:
    """One node's alternating up/down renewal process as (t, ±1) events.
    The repair paired with a failure inside the horizon is kept even if
    it lands beyond it (the node is simply still down at the end)."""
    events: List[Tuple[float, int]] = []
    t = draw_up()
    while t < duration:
        events.append((t, +1))
        r = t + max(draw_down(), 1e-6)
        events.append((r, -1))
        t = r + max(draw_up(), 1e-6)
    return events


def _finish(events: List[Tuple[float, int]]) -> FaultSchedule:
    if not events:
        return FaultSchedule(np.zeros(0), np.zeros(0, dtype=np.int64))
    events.sort(key=lambda e: e[0])
    times = np.array([t for t, _ in events], dtype=np.float64)
    deltas = np.array([d for _, d in events], dtype=np.int64)
    return FaultSchedule(times, deltas)


def exponential_schedule(seed: int, n_nodes: int, mtbf: float,
                         mttr: float, duration: float) -> FaultSchedule:
    """Per-node exponential MTBF/MTTR renewal schedule (memoryless
    hazard — the classic availability model)."""
    if mtbf <= 0 or mttr <= 0:
        raise ValueError("mtbf and mttr must be > 0")
    rng = np.random.Generator(np.random.PCG64(seed))
    events: List[Tuple[float, int]] = []
    for _ in range(n_nodes):
        events += _renewal(rng, duration,
                           lambda: rng.exponential(mtbf),
                           lambda: rng.exponential(mttr))
    return _finish(events)


def weibull_schedule(seed: int, n_nodes: int, mtbf: float, mttr: float,
                     duration: float, shape: float = 1.5) -> FaultSchedule:
    """Per-node Weibull time-between-failures (scale chosen so the mean
    equals ``mtbf``; shape > 1 models aging hardware with increasing
    hazard), exponential repair."""
    if mtbf <= 0 or mttr <= 0 or shape <= 0:
        raise ValueError("mtbf, mttr and shape must be > 0")
    scale = mtbf / math.gamma(1.0 + 1.0 / shape)
    rng = np.random.Generator(np.random.PCG64(seed))
    events: List[Tuple[float, int]] = []
    for _ in range(n_nodes):
        events += _renewal(rng, duration,
                           lambda: scale * rng.weibull(shape),
                           lambda: rng.exponential(mttr))
    return _finish(events)


def burst_schedule(seed: int, k: int, mtbf: float, mttr: float,
                   duration: float) -> FaultSchedule:
    """Correlated bursts: ``k`` nodes fail at once (a shared failure
    domain — rack power, top-of-rack switch) at exponential inter-burst
    times, all repaired together after an exponential outage. Bursts
    never overlap: the next inter-burst time starts at the previous
    repair."""
    if k <= 0:
        raise ValueError("burst size k must be > 0")
    if mtbf <= 0 or mttr <= 0:
        raise ValueError("mtbf and mttr must be > 0")
    rng = np.random.Generator(np.random.PCG64(seed))
    events: List[Tuple[float, int]] = []
    t = rng.exponential(mtbf)
    while t < duration:
        events.append((t, +k))
        r = t + max(rng.exponential(mttr), 1e-6)
        events.append((r, -k))
        t = r + max(rng.exponential(mtbf), 1e-6)
    return _finish(events)


def merge_schedules(*schedules: Optional[FaultSchedule]) -> FaultSchedule:
    """Merge schedules (e.g. per-node exponential + correlated bursts)
    into one sorted table; ``None`` entries are skipped."""
    events: List[Tuple[float, int]] = []
    for s in schedules:
        if s is not None:
            events += list(s.events())
    return _finish(events)
