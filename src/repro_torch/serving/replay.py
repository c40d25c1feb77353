"""Trace replay through the *live* serving stack (§6.5 as a live run).

The reference simulator feeds a WS demand trace straight into the
provision service. This module replays the same trace through the other
side of the repo — the serving engine — so the two paths can be diffed:

  1. the demand trace becomes a deterministic **request-arrival stream**
     (``ArrivalClock`` — fractional-carry, no RNG);
  2. requests are served by an :class:`AutoscaledService` built on
     :class:`VirtualReplica` (Replica's slot lifecycle with a fixed
     tokens-per-request latency model, no forward pass — days of trace
     in seconds of wall clock);
  3. the §6.4 instance-adjustment policy watches slot utilization and
     its ``nodes_needed`` is fed back into the shared
     :class:`~repro.core.runtime_bridge.LiveCloud` pump as WS demand —
     the same ``on_ws_demand`` path, the same ledger schema, the same
     clock as the simulator.

Arrival calibration: a request holds one slot for ``hold`` serve ticks,
so Little's law gives active-per-instance ``A = rate·hold``. We pick the
per-demand-unit rate ``rho·slots/hold`` (``rho`` just under the 80 %
threshold), which drives per-instance utilization to ``rho·d/n`` — the
policy's fixed point is ``n ≈ ceil(rho/0.8 · d) ≈ d`` instances, i.e.
the autoscaler *re-derives* the trace's node demand from traffic alone.
The live-vs-sim contract (``CONTRACTS["live"]``) bounds how far that
derived curve may drift from the replayed one.

Capacity note: the FB service caps WS grants at C, but the §6.4 policy
has no upper bound — size ``capacity`` at or above the trace peak (as
the paper's FB experiments do) or the manager's count and the granted
nodes diverge during saturation.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.jobs import Job
from repro_torch.core.runtime_bridge import LiveCloud
from repro_torch.core.ws_manager import InstanceAdjustmentPolicy, WSManager
from repro_torch.serving.autoscaler import AutoscaledService, GrantBackoff
from repro_torch.serving.engine import Request, VirtualReplica
from repro_torch.sim.engine import SimResult, default_duration, summarize
from repro_torch.sim.pump import CALL, WS, DecisionLedger


class ArrivalClock:
    """Deterministic arrival stream: ``rate`` arrivals per serve tick per
    demand unit, fractional remainders carried — replaying a trace twice
    yields byte-identical request streams."""

    def __init__(self, rate: float):
        self.rate = rate
        self.carry = 0.0

    def tick(self, demand: float) -> int:
        self.carry += demand * self.rate
        n = int(self.carry)
        self.carry -= n
        return n


def demand_step_series(ws_trace: Sequence[Tuple[float, int]]
                       ) -> List[Tuple[float, int]]:
    """Normalize a WS trace to a step series starting at t=0 (entries at
    t<=0 collapse to the initial value, matching the pump's startup
    collapse)."""
    entries = sorted(ws_trace, key=lambda e: e[0])
    initial = 0
    series: List[Tuple[float, int]] = []
    for t, d in entries:
        if t <= 0:
            initial = int(d)
        else:
            series.append((float(t), int(d)))
    return [(0.0, initial)] + series


@dataclasses.dataclass
class ReplayResult:
    row: SimResult                     # same shape the simulator emits
    ledger: DecisionLedger             # every grant/kill/ws/tick, timed
    trace_demand: List[Tuple[float, int]]     # the replayed step series
    derived_demand: List[Tuple[float, int]]   # what the autoscaler asked
    requests_completed: int
    peak_instances: int
    shed_requests: int = 0      # admission-throttled arrivals (chaos tier)
    grant_retries: int = 0      # backed-off demand re-posts after a
    #                             short grant (failed capacity)


class _ServeDriver:
    """The self-rescheduling serve tick: a CALL event on the LiveCloud
    pump that generates arrivals, steps the service, and re-posts WS
    demand whenever the autoscaler's node need moves."""

    def __init__(self, cloud: LiveCloud, service: AutoscaledService,
                 trace: List[Tuple[float, int]], clock: ArrivalClock,
                 hold: int, dt: float, duration: float,
                 backoff: Optional[GrantBackoff] = None):
        self.cloud = cloud
        self.service = service
        self.times = [t for t, _ in trace]
        self.values = [d for _, d in trace]
        self.clock = clock
        self.hold = hold
        self.dt = dt
        self.duration = duration
        self._rid = 0
        self._last_need = service.manager.nodes_needed
        self.peak_instances = len(service.replicas)
        # Chaos tier: when the provision service grants fewer nodes
        # than asked (failures shed the difference), re-assert the
        # demand after a bounded jittered-exponential delay instead of
        # every serve tick. None (the no-fault default) keeps the event
        # stream byte-identical to the pre-fault replay.
        self.backoff = backoff
        self._retry_at = -math.inf
        self.grant_retries = 0

    def demand_at(self, t: float) -> int:
        i = bisect.bisect_right(self.times, t) - 1
        return self.values[i] if i >= 0 else 0

    def start(self) -> None:
        self.cloud.pump.push(self.dt, CALL, self)

    def __call__(self, t: float):
        for _ in range(self.clock.tick(self.demand_at(t))):
            self.service.submit(
                Request(rid=self._rid, prompt=np.zeros(4, np.int32),
                        max_new_tokens=self.hold), now=t)
            self._rid += 1
        self.service.tick(now=t)
        self.peak_instances = max(self.peak_instances,
                                  len(self.service.replicas))
        need = self.service.manager.nodes_needed
        if need != self._last_need:
            # Same-time WS sorts ahead of the next CALL: the provision
            # service reacts before another serve tick runs.
            self._last_need = need
            self.cloud.pump.push(t, WS, need)
            if self.backoff is not None:
                self.backoff.reset()
                self._retry_at = -math.inf
        elif self.backoff is not None and t >= self._retry_at:
            # Grant shortfall (failed nodes shed part of the demand):
            # re-post the same demand after a backed-off delay — a
            # repair in between turns the retry into a real grow.
            granted = self.cloud.service.cluster.allocated(
                self.cloud.ws.name)
            if granted < self._last_need:
                delay = self.backoff.next_delay()
                if delay is not None and t + delay <= self.duration:
                    self._retry_at = t + delay
                    self.grant_retries += 1
                    self.cloud.pump.push(t + delay, WS, self._last_need)
                else:
                    self._retry_at = math.inf   # exhausted: wait for a
                    #                             real demand change
            else:
                self.backoff.reset()
        if t + self.dt <= self.duration:
            self.cloud.pump.push(t + self.dt, CALL, self)
        return []


def replay(jobs: Sequence[Job], ws_trace: Sequence[Tuple[float, int]],
           capacity: int, *, slots: int = 8, hold: int = 4,
           rho: float = 0.78, serve_dt: float = 30.0,
           lease_seconds: float = 3600.0,
           duration: Optional[float] = None,
           faults=None, max_queue: Optional[int] = None,
           backoff: Optional[GrantBackoff] = None,
           name: str = "live") -> ReplayResult:
    """Replay ``ws_trace`` as live traffic against a ``LiveCloud`` that
    is simultaneously running ``jobs`` as its PBJ workload. Returns the
    simulator-shaped result row plus both demand curves for diffing.

    Chaos tier: ``faults`` injects a
    :class:`repro.sim.faults.FaultSchedule` on the shared pump;
    ``max_queue`` turns on load-shedding admission at the serving layer;
    ``backoff`` bounds grant-shortfall retries (defaults to a seeded
    :class:`GrantBackoff` whenever faults are injected — without
    faults the retry machinery stays off so no-fault replays remain
    byte-identical to the pre-fault stack)."""
    if duration is None:
        duration = default_duration(jobs, ws_trace)
    trace = demand_step_series(ws_trace)
    d0 = trace[0][1]
    policy = InstanceAdjustmentPolicy(
        initial_instances=max(1, d0), min_instances=1,
        nodes_per_instance=1, window_seconds=2 * serve_dt)
    manager = WSManager(policy=policy)
    cloud = LiveCloud(capacity, lease_seconds=lease_seconds,
                      duration=duration, ws_initial=d0, ws=manager)
    service = AutoscaledService(
        policy=policy, slots_per_replica=slots, manager=manager,
        replica_factory=lambda: VirtualReplica(slots),
        max_queue=max_queue)
    cloud.load_trace(jobs, ws_trace=(), lease_ticks=True)
    if faults is not None:
        cloud.inject_faults(faults)
        if backoff is None:
            backoff = GrantBackoff(base=2 * serve_dt,
                                   max_delay=max(600.0, 2 * serve_dt),
                                   seed=0)
    driver = _ServeDriver(cloud, service, trace,
                          ArrivalClock(rho * slots / hold),
                          hold, serve_dt, duration, backoff=backoff)
    driver.start()
    cloud.run_until(duration)
    row = summarize(cloud.service, list(jobs), duration, name)
    return ReplayResult(
        row=row, ledger=cloud.ledger, trace_demand=trace,
        derived_demand=cloud.ledger.demand_series(),
        requests_completed=len(service.completed),
        peak_instances=driver.peak_instances,
        shed_requests=service.shed_requests,
        grant_retries=driver.grant_retries)
