# Frozen copy of src/repro_torch/core/baselines.py, imports re-pointed at this
# package: part of the benchmark's plain reference, which imports
# nothing of the program.
"""The paper's two comparison systems (§6.5.1, §6.6.1).

* ``DCSSystem`` — dedicated cluster system: static partition, PRC_PBJ
  nodes for the batch TRE and PRC_WS for the web TRE, no coordination.

* ``EC2RightScaleSystem`` — public-cloud baseline: WS is autoscaled
  exactly like PhoenixCloud (RightScale provides the same scalable
  management, §6.6.1), while each batch job's end user leases its nodes
  individually at submission, runs immediately (no queue, no scheduler),
  and releases only at the next lease-unit boundary after completion
  (§6.6.2 — EC2 bills whole hours and users can't predict completions).

Both are concrete ``ProvisioningSystem``s (core/system.py), so the event
engine drives them through the same lifecycle protocol as the two
PhoenixCloud services.
"""

from __future__ import annotations

from typing import List

from portbench.reference.cluster import Cluster, ceil_to_lease
from portbench.reference.jobs import Job
from portbench.reference.pbj_manager import PBJManager, Started
from portbench.reference.system import ProvisioningSystem
from portbench.reference.ws_manager import WSManager


class DCSSystem(ProvisioningSystem):
    """Static partition baseline (§6.5.1)."""

    def __init__(self, prc_pbj: int, prc_ws: int, pbj: PBJManager,
                 ws: WSManager, lease_seconds: float = 3600.0):
        self.cluster = Cluster(prc_pbj + prc_ws)
        self.cluster.register(pbj.name)
        self.cluster.register(ws.name)
        self.pbj = pbj
        self.ws = ws
        self.prc_pbj = prc_pbj
        self.prc_ws = prc_ws
        self.lease_seconds = lease_seconds

    def startup(self, t: float, ws_initial: int = 0) -> List[Started]:
        del ws_initial  # static: WS owns its full partition regardless
        self.cluster.allocate(t, self.ws.name, self.prc_ws)
        self.cluster.allocate(t, self.pbj.name, self.prc_pbj)
        return self.pbj.grant(t, self.prc_pbj)

    def on_ws_demand(self, t: float, demand: int) -> List[Started]:
        # Static allocation: demand changes never move resources.
        self.ws.set_demand(demand)
        return []

    def on_lease_tick(self, t: float) -> List[Started]:
        return []


class EC2RightScaleSystem(ProvisioningSystem):
    """EC2 + RightScale baseline (§6.6.1)."""

    def __init__(self, pbj: PBJManager, ws: WSManager,
                 lease_seconds: float = 3600.0):
        self.cluster = Cluster(capacity=None)
        self.cluster.register(pbj.name)
        self.cluster.register(ws.name)
        self.pbj = pbj            # used only for completion bookkeeping
        self.ws = ws
        self.lease_seconds = lease_seconds
        self._pending_release: List[tuple] = []   # (release_time, size)

    def startup(self, t: float, ws_initial: int = 0) -> List[Started]:
        if ws_initial:
            self.on_ws_demand(t, ws_initial)
        return []

    def on_ws_demand(self, t: float, demand: int) -> List[Started]:
        """RightScale autoscaling == replaying the same consumption trace."""
        self.ws.set_demand(demand)
        cur = self.cluster.allocated(self.ws.name)
        if demand > cur:
            self.cluster.allocate(t, self.ws.name, demand - cur)
        elif demand < cur:
            self.cluster.release(t, self.ws.name, cur - demand)
        return []

    def submit(self, t: float, job: Job) -> List[Started]:
        """End user leases nodes and the job starts immediately."""
        self.cluster.allocate(t, self.pbj.name, job.size)
        return [self.pbj.start_immediately(t, job)]

    def on_finish(self, t: float, jid: int, epoch: int) -> List[Started]:
        job, starts = self.pbj.on_finish(t, jid, epoch)
        if job is not None:
            # §6.6.2: resources released at the end of the lease unit.
            release_at = ceil_to_lease(t, self.lease_seconds)
            self._pending_release.append((release_at, job.size))
        return starts

    def on_lease_tick(self, t: float) -> List[Started]:
        due = [(rt, n) for rt, n in self._pending_release if rt <= t + 1e-6]
        self._pending_release = [(rt, n) for rt, n in self._pending_release
                                 if rt > t + 1e-6]
        for _, n in due:
            self.cluster.release(t, self.pbj.name, n)
            self.pbj.owned -= n
        return []


def billable_requests(row) -> int:
    """Provisioning-API request count a sweep row implies — the unit the
    capacity layer's cost lens (``repro.sim.capacity.CostModel``) prices
    at a provider's per-request rate.

    Every ``adjust_events`` entry is one allocate/release transition of
    the site ledger: under §6.6.2's whole-lease-unit billing each such
    transition is one management-API round-trip on a public cloud
    (RunInstances/TerminateInstances-shaped), so the ledger count IS the
    billable request count. Accepts a sweep row dict or any object with
    an ``adjust_events`` attribute (e.g. ``SimResult``); rows without
    the metric (vectorized DCS carries cost/peak only — a static
    partition makes zero requests) price as zero.
    """
    if isinstance(row, dict):
        n = row.get("adjust_events", 0)
    else:
        n = getattr(row, "adjust_events", 0)
    return int(n or 0)
