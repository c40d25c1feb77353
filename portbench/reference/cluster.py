# Frozen copy of src/repro_torch/core/cluster.py, imports re-pointed at this
# package: part of the benchmark's plain reference, which imports
# nothing of the program.
"""Cloud-site resource ledger and accounting.

The paper counts ``nodes``; on the TPU adaptation the unit is a chip
(slice of the production mesh). The ledger is policy-free: it enforces
conservation (allocations never exceed capacity, never go negative) and
integrates the consumption curves that §6.1 of the paper defines as the
evaluation metrics:

  * total resource consumption  — integral of allocated units (node×hour),
  * peak resource consumption   — max instantaneous allocation,
  * accumulated times of adjusting resources — count of request / release /
    provision events (the management-overhead metric of Fig. 18).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional


class LedgerError(RuntimeError):
    pass


@dataclasses.dataclass
class _RESlot:
    allocated: int = 0
    adjust_events: int = 0


class Cluster:
    """Allocation ledger for one Cloud site.

    ``capacity=None`` models the public-cloud assumption of §5.2 (the
    provider owns "enough resources", N >> 2 tenants).
    """

    def __init__(self, capacity: Optional[int], t0: float = 0.0):
        if capacity is not None and capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = capacity
        self._failed = 0
        self._res: Dict[str, _RESlot] = {}
        # Accounting state (piecewise-constant integration).
        self._t_last = t0
        self._node_seconds = 0.0
        self._peak = 0
        self._per_re_node_seconds: Dict[str, float] = {}

    # ---------------------------------------------------------------- ledger

    def register(self, re_name: str) -> None:
        if re_name in self._res:
            raise LedgerError(f"RE {re_name!r} already registered")
        self._res[re_name] = _RESlot()
        self._per_re_node_seconds[re_name] = 0.0

    def allocated(self, re_name: str) -> int:
        return self._res[re_name].allocated

    @property
    def total_allocated(self) -> int:
        return sum(s.allocated for s in self._res.values())

    @property
    def failed(self) -> int:
        """Nodes currently down (fault injection, ``repro.sim.faults``)."""
        return self._failed

    @property
    def effective_capacity(self) -> Optional[int]:
        """Surviving capacity: ``capacity - failed`` (None if unbounded)."""
        if self.capacity is None:
            return None
        return self.capacity - self._failed

    @property
    def idle(self) -> int:
        if self.capacity is None:
            raise LedgerError("idle undefined for unbounded capacity")
        # Clamped: right after a failure the site may transiently hold
        # more than the surviving capacity until the provision service's
        # on_fail handler drains the overflow.
        return max(0, self.capacity - self._failed - self.total_allocated)

    def adjust_events(self, re_name: Optional[str] = None) -> int:
        if re_name is not None:
            return self._res[re_name].adjust_events
        return sum(s.adjust_events for s in self._res.values())

    def allocate(self, t: float, re_name: str, n: int) -> None:
        """Provision ``n`` units to an RE (one adjust event if n > 0)."""
        if n < 0:
            raise LedgerError("allocate() takes n >= 0; use release()")
        if n == 0:
            return
        if (self.capacity is not None
                and self.total_allocated + n > self.capacity - self._failed):
            raise LedgerError(
                f"allocation of {n} to {re_name!r} exceeds capacity "
                f"{self.capacity} - {self._failed} failed "
                f"(allocated={self.total_allocated})")
        self._advance(t)
        slot = self._res[re_name]
        slot.allocated += n
        slot.adjust_events += 1
        self._peak = max(self._peak, self.total_allocated)

    def release(self, t: float, re_name: str, n: int) -> None:
        if n < 0:
            raise LedgerError("release() takes n >= 0")
        if n == 0:
            return
        slot = self._res[re_name]
        if slot.allocated < n:
            raise LedgerError(
                f"RE {re_name!r} releasing {n} but holds {slot.allocated}")
        self._advance(t)
        slot.allocated -= n
        slot.adjust_events += 1

    def transfer(self, t: float, src: str, dst: str, n: int) -> None:
        """Move units between coordinated REs (kill-reallocate path, §5.1)."""
        if n < 0:
            raise LedgerError("transfer() takes n >= 0")
        if n == 0:
            return
        if self._res[src].allocated < n:
            raise LedgerError(
                f"transfer {n} from {src!r} exceeds holding "
                f"{self._res[src].allocated}")
        self._advance(t)
        self._res[src].allocated -= n
        self._res[dst].allocated += n
        self._res[src].adjust_events += 1
        self._res[dst].adjust_events += 1

    # ------------------------------------------------------- fault injection

    def fail_nodes(self, t: float, n: int) -> int:
        """Mark ``n`` nodes as failed (clamped to the surviving count).
        Returns the number actually failed. The ledger itself stays
        policy-free: draining the overflow (killed jobs, shed WS
        replicas) is the provision service's job (``on_fail``)."""
        if self.capacity is None:
            raise LedgerError("fail_nodes undefined for unbounded capacity")
        if n < 0:
            raise LedgerError("fail_nodes() takes n >= 0")
        n = min(n, self.capacity - self._failed)
        if n > 0:
            self._advance(t)
            self._failed += n
        return n

    def repair_nodes(self, t: float, n: int) -> int:
        """Return ``n`` previously-failed nodes to service (clamped to
        the failed count). Returns the number actually repaired."""
        if n < 0:
            raise LedgerError("repair_nodes() takes n >= 0")
        n = min(n, self._failed)
        if n > 0:
            self._advance(t)
            self._failed -= n
        return n

    # ------------------------------------------------------------ accounting

    def _advance(self, t: float) -> None:
        if t < self._t_last - 1e-9:
            raise LedgerError(f"time went backwards: {t} < {self._t_last}")
        dt = max(0.0, t - self._t_last)
        if dt > 0:
            self._node_seconds += dt * self.total_allocated
            for name, slot in self._res.items():
                self._per_re_node_seconds[name] += dt * slot.allocated
            self._t_last = t

    def finalize(self, t_end: float) -> None:
        self._advance(t_end)

    @property
    def node_hours(self) -> float:
        return self._node_seconds / 3600.0

    def node_hours_of(self, re_name: str) -> float:
        return self._per_re_node_seconds[re_name] / 3600.0

    @property
    def peak(self) -> int:
        return self._peak


def ceil_to_lease(t: float, lease_seconds: float) -> float:
    """Next lease-tick boundary at or after ``t`` (EC2 billing rule §6.6.2)."""
    k = math.ceil((t - 1e-9) / lease_seconds)
    return max(k, 0) * lease_seconds
