# Frozen copy of src/repro_torch/core/provision.py, imports re-pointed at this
# package: part of the benchmark's plain reference, which imports
# nothing of the program.
"""Resource Provision Service — coordinated provisioning policies (§5).

Two services implement the paper's two coordination models:

  * ``FBProvisionService``  (§5.1) — private cloud, fixed capacity C.
    WS demand has strict priority: it is satisfied from the idle pool,
    then from the PBJ TRE's idle nodes, then by force-killing PBJ jobs.
    On every lease tick all idle nodes are provisioned to the PBJ TRE.

  * ``FLBNUBProvisionService`` (§5.2) — public cloud, unbounded capacity.
    The coordinated pool holds B = lb_pbj + lb_ws nodes permanently (the
    rigid lower bounds — they are paid for whether idle or not, which is
    exactly why Fig. 14 shows total consumption growing with B). WS demand
    is always satisfied (within-pool share first, elastic beyond). On each
    lease tick idle pool nodes go to the PBJ TRE, then the PBJ manager
    runs its U/V/G adjustment; requests are granted from the cloud.

Both count every request/release/provision as an adjust event — the
management-overhead metric of Fig. 18.
"""

from __future__ import annotations

from typing import List

from portbench.reference.cluster import Cluster
from portbench.reference.pbj_manager import PBJManager, Started
from portbench.reference.system import ProvisioningSystem
from portbench.reference.ws_manager import WSManager

POOL = "POOL"   # ledger name for the permanently-held coordinated pool


class FBProvisionService(ProvisioningSystem):
    """Fixed Bound model (§5.1): capacity C, WS-priority with kills."""

    def __init__(self, capacity: int, pbj: PBJManager, ws: WSManager,
                 lease_seconds: float = 3600.0):
        self.cluster = Cluster(capacity)
        self.cluster.register(pbj.name)
        self.cluster.register(ws.name)
        self.pbj = pbj
        self.ws = ws
        self.lease_seconds = lease_seconds
        self.shed_count = 0
        # Raw (unclamped) WS demand, remembered so a REPAIR event can
        # refill the WS TRE to min(demand, surviving capacity).
        self._ws_demand_raw = 0

    def startup(self, t: float, ws_initial: int = 0) -> List[Started]:
        """Allocate lower bounds at TRE startup (§5.1 rule 2: the
        coordinated pool is the sum of the lower bounds == C; everything
        not needed by WS goes to PBJ)."""
        self._ws_demand_raw = ws_initial
        ws_initial = min(ws_initial, self.cluster.capacity)
        if ws_initial:
            self.cluster.allocate(t, self.ws.name, ws_initial)
            self.ws.set_demand(ws_initial)
        grant = self.cluster.idle
        self.cluster.allocate(t, self.pbj.name, grant)
        return self.pbj.grant(t, grant)

    # -------------------------------------------------------------- events

    def on_ws_demand(self, t: float, demand: int) -> List[Started]:
        """§5.1 rule 3 — WS demand beats PBJ, killing jobs if necessary.
        Under degraded capacity (failed nodes) demand beyond the
        surviving count is shed — counted, not granted — until repairs
        land (graceful degradation)."""
        self._ws_demand_raw = demand
        granted = min(demand, self.cluster.effective_capacity)
        if demand > granted:
            self.shed_count += demand - granted
        demand = granted
        self.ws.set_demand(demand)
        cur = self.cluster.allocated(self.ws.name)
        if demand > cur:
            need = demand - cur
            take_idle = min(need, self.cluster.idle)
            if take_idle:
                self.cluster.allocate(t, self.ws.name, take_idle)
                need -= take_idle
            restarts: List[Started] = []
            if need > 0:
                released, restarts = self.pbj.force_release(t, need)
                assert released == need, (released, need)
                self.cluster.transfer(t, self.pbj.name, self.ws.name, need)
            return restarts
        elif demand < cur:
            # Shrink: nodes return to the idle pool until the next tick.
            self.cluster.release(t, self.ws.name, cur - demand)
        return []

    def on_lease_tick(self, t: float) -> List[Started]:
        """§5.1 rule 4 — provision all idle resources to the PBJ TRE."""
        idle = self.cluster.idle
        if idle > 0:
            self.cluster.allocate(t, self.pbj.name, idle)
            return self.pbj.grant(t, idle)
        return []

    # --------------------------------------------------------- fault hooks

    def on_fail(self, t: float, k: int) -> List[Started]:
        """Chaos tier: ``k`` nodes die. Absorption order — idle pool
        first, then PBJ jobs (killed through the existing §5.1 path:
        checkpoint hook, requeue, restart from checkpointed progress),
        then WS replicas (shed — demand exceeds surviving capacity until
        a repair). WS keeps its §5.1 priority throughout: after the
        handler, ``ws_alloc == min(demand, C - failed)``, which is
        exactly the time-varying share line the rounds engine folds into
        its WS tables."""
        k = self.cluster.fail_nodes(t, k)
        if k == 0:
            return []
        overflow = (self.cluster.total_allocated
                    - self.cluster.effective_capacity)
        restarts: List[Started] = []
        if overflow > 0:
            give = min(overflow, self.cluster.allocated(self.pbj.name))
            if give:
                released, restarts = self.pbj.force_release(t, give)
                assert released == give, (released, give)
                self.cluster.release(t, self.pbj.name, give)
                overflow -= give
            if overflow > 0:
                # The failure reached WS replicas: drain and shed.
                self.cluster.release(t, self.ws.name, overflow)
                self.ws.set_demand(self.cluster.allocated(self.ws.name))
                self.shed_count += overflow
        return restarts

    def on_repair(self, t: float, k: int) -> List[Started]:
        """Chaos tier: ``k`` nodes return. The WS shortfall refills
        immediately (§5.1 priority); remaining recovered nodes sit idle
        until the next lease tick provisions them to PBJ (rule 4)."""
        k = self.cluster.repair_nodes(t, k)
        if k == 0:
            return []
        cur = self.cluster.allocated(self.ws.name)
        target = min(self._ws_demand_raw, self.cluster.effective_capacity)
        grow = min(target - cur, self.cluster.idle)
        if grow > 0:
            self.cluster.allocate(t, self.ws.name, grow)
            self.ws.set_demand(cur + grow)
        return []


class FLBNUBProvisionService(ProvisioningSystem):
    """Fixed Lower Bound / No Upper Bound model (§5.2)."""

    def __init__(self, lb_pbj: int, lb_ws: int, pbj: PBJManager,
                 ws: WSManager, lease_seconds: float = 3600.0):
        # Unbounded site (§5.2 presumes the provider owns enough resources).
        self.cluster = Cluster(capacity=None)
        self.cluster.register(POOL)      # the B permanently-held nodes
        self.cluster.register(pbj.name)  # leased beyond the pool
        self.cluster.register(ws.name)   # WS demand beyond its lower bound
        self.pbj = pbj
        self.ws = ws
        self.lb_pbj = lb_pbj
        self.lb_ws = lb_ws
        self.lease_seconds = lease_seconds
        # Pool split bookkeeping (who is using the B nodes right now).
        self._pool_pbj = 0     # pool nodes provisioned to PBJ
        self._pool_ws = 0      # pool nodes serving WS demand (<= lb_ws)
        self._pool_failed = 0  # pool nodes currently down (chaos tier)

    @property
    def coordinated_size(self) -> int:
        return self.lb_pbj + self.lb_ws

    @property
    def _pool_idle(self) -> int:
        return (self.coordinated_size - self._pool_failed
                - self._pool_pbj - self._pool_ws)

    def startup(self, t: float, ws_initial: int = 0) -> List[Started]:
        """§5.2 rule 2: allocate lower bounds at startup. The whole pool B
        is held (and paid for) from t0."""
        self.cluster.allocate(t, POOL, self.coordinated_size)
        started = self.pbj.grant(t, self.lb_pbj)
        self._pool_pbj = self.lb_pbj
        if ws_initial:
            self.on_ws_demand(t, ws_initial)
        return started

    # -------------------------------------------------------------- events

    def on_ws_demand(self, t: float, demand: int) -> List[Started]:
        """§5.2 rule 4: WS demand is always satisfied — within-pool share
        first (up to lb_ws), elastically leased beyond."""
        self.ws.set_demand(demand)
        pool_share = min(demand, self.lb_ws, self._pool_ws + self._pool_idle)
        self._pool_ws = pool_share
        beyond = max(0, demand - pool_share)
        cur_beyond = self.cluster.allocated(self.ws.name)
        if beyond > cur_beyond:
            self.cluster.allocate(t, self.ws.name, beyond - cur_beyond)
        elif beyond < cur_beyond:
            self.cluster.release(t, self.ws.name, cur_beyond - beyond)
        return []

    def on_lease_tick(self, t: float) -> List[Started]:
        """§5.2 rule 3 (idle pool → PBJ), then the PBJ U/V/G adjustment."""
        started: List[Started] = []
        idle = self._pool_idle
        if idle > 0:
            self._pool_pbj += idle
            started += self.pbj.grant(t, idle)
        action, n = self.pbj.adjust(t)
        if action == "request":
            # Granted immediately from the unbounded cloud (leased nodes).
            self.cluster.allocate(t, self.pbj.name, n)
            started += self.pbj.grant(t, n)
        elif action == "release":
            # Release leased nodes first (they cost money); pool nodes
            # simply return to the pool and flow back next tick.
            leased = self.cluster.allocated(self.pbj.name)
            from_lease = min(n, leased)
            from_pool = n - from_lease
            self.pbj.confirm_release(n)
            if from_lease:
                self.cluster.release(t, self.pbj.name, from_lease)
            if from_pool:
                self._pool_pbj -= from_pool
                assert self._pool_pbj >= 0
        return started

    # --------------------------------------------------------- fault hooks

    def on_fail(self, t: float, k: int) -> List[Started]:
        """Chaos tier: ``k`` pool nodes die (faults target the
        permanently-held B nodes; elastic leases model the provider's
        replaceable inventory, §5.2's N >> 2 assumption). Absorption
        order: pool idle, then pool PBJ nodes (§5.1 kill path — U/V/G
        re-leases at the next tick), then the WS pool share — which is
        re-satisfied immediately with an elastic lease, so WS never
        sheds under FLB-NUB."""
        k = min(k, self.coordinated_size - self._pool_failed)
        if k <= 0:
            return []
        self._pool_failed += k
        # Down pool nodes stop accruing node-hours until repaired.
        self.cluster.release(t, POOL, k)
        overflow = (self._pool_pbj + self._pool_ws
                    - (self.coordinated_size - self._pool_failed))
        restarts: List[Started] = []
        if overflow > 0:
            give = min(overflow, self._pool_pbj)
            if give:
                released, restarts = self.pbj.force_release(t, give)
                assert released == give, (released, give)
                self._pool_pbj -= give
                overflow -= give
            if overflow > 0:
                self._pool_ws -= overflow
                self.cluster.allocate(t, self.ws.name, overflow)
        return restarts

    def on_repair(self, t: float, k: int) -> List[Started]:
        """Chaos tier: ``k`` pool nodes return and are held (paid for)
        again. The WS share moves back onto recovered pool nodes first
        (pool-first rule 4), releasing the elastic leases that replaced
        them; PBJ re-grows at the next tick (idle pool → PBJ, U/V/G)."""
        k = min(k, self._pool_failed)
        if k <= 0:
            return []
        self._pool_failed -= k
        self.cluster.allocate(t, POOL, k)
        pool_share = min(self.ws.demand, self.lb_ws,
                         self._pool_ws + self._pool_idle)
        delta = pool_share - self._pool_ws
        if delta > 0:
            self._pool_ws = pool_share
            self.cluster.release(t, self.ws.name, delta)
        return []
