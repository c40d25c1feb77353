"""Replica autoscaler — the WS TRE's instance-adjustment loop (§6.4).

Bridges the live serving engine to ``core.ws_manager.WSManager``: slot
utilization across replicas feeds ``observe_utilization``; when the 80 %
policy fires, replicas are added/removed and the node delta is
requested/released from the provision service (the PhoenixCloud
coordination point).

Shrink is a *drain* protocol: the policy marks the least-loaded replica
draining (the router stops sending it traffic), the replica keeps
serving its outstanding slots, and only when it empties is it removed —
at which point ``WSManager.confirm_shrink`` drops the instance count and
the node lease behind it. The manager's count and ``len(replicas)``
therefore agree at every tick boundary, by construction.

``replica_factory`` selects the payload tier: the default builds real
``Replica``s (model forward passes — the smoke tier); the replay layer
(``repro.serving.replay``) passes a ``VirtualReplica`` factory so
replayed days of trace run in seconds.
"""

from __future__ import annotations

import random
import time
from typing import Callable, List, Optional

from repro_torch.core.ws_manager import InstanceAdjustmentPolicy, WSManager
from repro_torch.serving.engine import (LeastLoadedRouter, Replica, Request,
                                  SlotPool)


class GrantBackoff:
    """Bounded, deterministic jittered exponential backoff for the WS
    grow path under degraded capacity (the chaos tier).

    When the provision service grants fewer nodes than the autoscaler
    asked for (nodes failed, demand shed), retrying immediately would
    hammer a cluster that cannot satisfy the request until a repair
    lands. Instead the caller asks :meth:`next_delay` how long to wait
    before re-posting the demand: ``base * 2^attempt`` seconds, jittered
    by a seeded ``random.Random`` (equal-jitter — uniform in (d/2, d])
    so replicated services don't retry in lockstep, capped at ``max_delay``
    and at ``max_retries`` attempts (then ``None`` — give up until the
    demand itself changes). Seeded, so a replayed trace backs off
    identically run to run. :meth:`reset` rearms after a full grant."""

    def __init__(self, base: float = 30.0, max_delay: float = 600.0,
                 max_retries: int = 6, seed: int = 0):
        if base <= 0 or max_delay < base or max_retries < 1:
            raise ValueError("need base > 0, max_delay >= base, "
                             "max_retries >= 1")
        self.base = base
        self.max_delay = max_delay
        self.max_retries = max_retries
        self._rng = random.Random(seed)
        self.attempt = 0

    def next_delay(self) -> Optional[float]:
        """Delay before the next retry, or ``None`` when exhausted."""
        if self.attempt >= self.max_retries:
            return None
        d = min(self.base * (2.0 ** self.attempt), self.max_delay)
        self.attempt += 1
        return d * (1.0 - 0.5 * self._rng.random())   # (d/2, d] jitter

    def reset(self) -> None:
        self.attempt = 0


class AutoscaledService:
    def __init__(self, cfg=None, mesh=None, *,
                 policy: Optional[InstanceAdjustmentPolicy] = None,
                 slots_per_replica: int = 8, max_len: int = 128,
                 params=None,
                 on_scale: Optional[Callable[[int, int], None]] = None,
                 replica_factory: Optional[Callable[[], SlotPool]] = None,
                 manager: Optional[WSManager] = None,
                 max_queue: Optional[int] = None):
        if policy is None:
            policy = InstanceAdjustmentPolicy(
                nodes_per_instance=cfg.serve_chips_per_replica
                if cfg is not None else 1)
        self.cfg = cfg
        self.mesh = mesh
        self.policy = policy
        # A shared manager lets one WSManager serve both roles at once:
        # the autoscaler's instance ledger here AND the provision
        # service's WS TRE in a LiveCloud (the replay wiring).
        self.manager = manager if manager is not None else \
            WSManager(policy=policy)
        self.slots = slots_per_replica
        self.max_len = max_len
        self.router = LeastLoadedRouter()
        self.on_scale = on_scale       # callback(old_n, new_n) → provision
        self._params = params
        self._factory = replica_factory or self._real_replica
        self.replicas: List[SlotPool] = []
        self.draining: List[SlotPool] = []
        self._mk_replica_count = 0
        for _ in range(self.policy.initial_instances):
            self._add_replica()
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        # Load-shedding mode (chaos tier): with ``max_queue`` set, a
        # request arriving at a full backlog is refused instead of
        # queued — graceful degradation while failed nodes keep the
        # autoscaler's grants short. Shed requests are counted, never
        # silently dropped.
        self.max_queue = max_queue
        self.shed_requests = 0

    def _real_replica(self) -> Replica:
        r = Replica(self.cfg, self.mesh, slots=self.slots,
                    max_len=self.max_len, params=self._params)
        if self._params is None:
            self._params = r.params       # share weights across replicas
        return r

    def _add_replica(self):
        self.replicas.append(self._factory())
        self._mk_replica_count += 1

    def submit(self, req: Request, now: Optional[float] = None) -> bool:
        """Admit a request; returns False (and counts the shed) when the
        backlog is at ``max_queue``."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.shed_requests += 1
            return False
        req.submitted = time.time() if now is None else now
        self.queue.append(req)
        return True

    @property
    def utilization(self) -> float:
        if not self.replicas:
            return 1.0
        return sum(r.n_active for r in self.replicas) / \
            sum(r.slots for r in self.replicas)

    def tick(self, now: float):
        """One scheduling tick: admit, decode, drain, autoscale."""
        old = len(self.replicas)
        # Admit queued requests to the least-loaded serving replicas
        # (draining replicas take no new traffic — that is the drain).
        serving = [r for r in self.replicas if r not in self.draining]
        still = []
        for req in self.queue:
            target = self.router.route(serving)
            if target is None or not target.admit(req):
                still.append(req)
        self.queue = still
        # Sample utilization HERE — serving slots occupied during this
        # tick, after admission and before retirement. Sampling after
        # step() would read just-finished slots as idle and sit below
        # the 80 % threshold even with an unbounded backlog; sampling
        # after admit reads a backed-up service as exactly 1.0
        # (admission only leaves a queue when every serving slot is
        # full). Draining replicas are excluded: the policy decides on
        # serving instances, so their slots would only dilute the
        # signal.
        util = (sum(r.n_active for r in serving) /
                sum(r.slots for r in serving)) if serving else 1.0
        # Decode step on every replica — draining ones included; they
        # still owe their outstanding requests.
        for r in self.replicas:
            self.completed.extend(r.step())
        self._retire_drained()
        # Autoscaling (the §6.4 policy, verbatim thresholds).
        target_n = self.manager.observe_utilization(now, util)
        if target_n is not None:
            self._apply_target(target_n)
            self._retire_drained()     # an already-idle mark goes at once
        if self.on_scale and len(self.replicas) != old:
            self.on_scale(old, len(self.replicas))

    # ------------------------------------------------------ drain machinery

    def _apply_target(self, n: int) -> None:
        """Match the number of *serving* replicas to the manager's
        target. Grow resurrects a draining replica before building a new
        one (mirroring WSManager's bookkeeping); shrink marks the
        least-loaded serving replica draining."""
        while len(self.replicas) - len(self.draining) < n:
            if self.draining:
                self.draining.pop()
            else:
                self._add_replica()
        while len(self.replicas) - len(self.draining) > n:
            serving = [r for r in self.replicas if r not in self.draining]
            self.draining.append(min(serving, key=lambda r: r.n_active))

    def _retire_drained(self) -> None:
        for r in [d for d in self.draining if d.n_active == 0]:
            self.draining.remove(r)
            self.replicas.remove(r)
            self.manager.confirm_shrink()
