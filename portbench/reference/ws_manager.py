# Frozen copy of src/repro_torch/core/ws_manager.py, imports re-pointed at this
# package: part of the benchmark's plain reference, which imports
# nothing of the program.
"""WS TRE Manager — the web-service (inference-serving) runtime environment.

Two operating modes mirror the paper's two experiment styles:

  * **Demand replay** (§6.5.1 "the resource simulator simulates the varying
    resources consumption and drives WS Manager"): the manager replays a
    resource-consumption trace (e.g. the World Cup trace of Fig. 10) and
    requests/releases nodes from the provision service to match.

  * **Instance adjustment** (§6.4): the live policy used by the real
    serving engine — if average utilization of the current ``n`` instances
    exceeds 80% over the sampling window, add one instance; if it drops
    below 80%·(n−1)/n, remove one. On the TPU adaptation "utilization" is
    decode-slot occupancy of the serving replicas.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from portbench.reference.profiles import windowed_mean


@dataclasses.dataclass(frozen=True)
class InstanceAdjustmentPolicy:
    """§6.4's policy, parameters verbatim from the paper."""

    threshold: float = 0.80      # utilization trigger
    window_seconds: float = 20.0  # averaging window
    initial_instances: int = 2
    min_instances: int = 1
    nodes_per_instance: int = 1

    def decide(self, n_instances: int, avg_utilization: float) -> int:
        """Return the instance-count delta (+1 / -1 / 0)."""
        if avg_utilization > self.threshold:
            return 1
        if (n_instances > self.min_instances
                and avg_utilization < self.threshold * (n_instances - 1) / n_instances):
            return -1
        return 0


class WSManager:
    """Manager of the web-service TRE."""

    def __init__(self, name: str = "WS",
                 policy: InstanceAdjustmentPolicy = InstanceAdjustmentPolicy()):
        self.name = name
        self.policy = policy
        self.instances = policy.initial_instances
        self.draining = 0        # instances marked for removal, not yet gone
        self.demand = 0          # nodes currently demanded (replay mode)
        self._util_samples: List[Tuple[float, float]] = []

    # ------------------------------------------------------- replay mode

    def set_demand(self, demand: int) -> int:
        """Replay-mode update; returns the delta the service must cover."""
        delta = demand - self.demand
        self.demand = demand
        return delta

    # ----------------------------------------------- live-adjustment mode

    def observe_utilization(self, t: float, utilization: float) -> Optional[int]:
        """Feed a utilization sample; returns the new *serving* target
        when the policy fires (None otherwise).

        Growth commits immediately (``instances`` rises — or a draining
        instance is resurrected). Shrink is DEFERRED: an instance still
        holds requests when the policy fires, so it is only *marked*
        draining here; ``instances`` — and therefore ``nodes_needed`` —
        drops when the caller confirms the drain completed
        (:meth:`confirm_shrink`). This is what keeps the manager's count
        and the autoscaler's replica list in lockstep: the count changes
        exactly when a replica actually appears or disappears.
        """
        self._util_samples.append((t, utilization))
        avg, self._util_samples = windowed_mean(
            self._util_samples, t, self.policy.window_seconds)
        serving = self.instances - self.draining
        delta = self.policy.decide(serving, avg)
        if delta > 0:
            if self.draining:
                self.draining -= 1      # resurrect a draining instance
            else:
                self.instances += delta
            self._util_samples.clear()  # restart the window after a change
            return self.instances - self.draining
        if delta < 0:
            self.draining += 1          # marked; confirmed when drained
            self._util_samples.clear()
            return self.instances - self.draining
        return None

    def confirm_shrink(self, n: int = 1) -> None:
        """A marked instance finished draining and is gone: the count —
        and the node lease behind it — drops now, not before."""
        assert 0 <= n <= self.draining, (n, self.draining)
        self.draining -= n
        self.instances -= n

    @property
    def nodes_needed(self) -> int:
        """Nodes the WS TRE holds: draining instances still serve their
        outstanding requests, so they keep their lease until confirmed."""
        return self.instances * self.policy.nodes_per_instance
