# Frozen copy of src/repro_torch/core/system.py, imports re-pointed at this
# package: part of the benchmark's plain reference, which imports
# nothing of the program.
"""The shared provisioning-system abstraction.

Every system in the paper's comparison matrix (§6) — DCS, PhoenixCloud
FB, PhoenixCloud FLB-NUB, EC2+RightScale — is one concrete
``ProvisioningSystem``: a cloud-site ledger (``cluster``), one PBJ TRE
manager, one WS TRE manager, and a lease time unit, driven through five
lifecycle events:

    startup(t, ws_initial)      initial allocation of the site
    submit(t, job)              a batch job arrives
    on_finish(t, jid, epoch)    a previously-started job completes
    on_ws_demand(t, demand)     the web-service consumption changes
    on_lease_tick(t)            a lease time-unit boundary (§4: resource
                                provisioning happens in lease units)
    on_fail(t, k)               k nodes fail (chaos tier, repro.sim.faults)
    on_repair(t, k)             k previously-failed nodes return

Every handler returns the jobs it *started* as ``Started`` events — the
single return channel through which new completion events enter the
event engine (``repro.sim.engine``). The engine is therefore completely
policy-free: it never reaches into managers, and new provisioning
policies plug in by subclassing (the pluggability argument of the
RightScale-replay baselines, arXiv 1003.0958, and the provisioning
taxonomy of arXiv 1411.5077).
"""

from __future__ import annotations

import abc
from typing import List

from portbench.reference.cluster import Cluster
from portbench.reference.jobs import Job
from portbench.reference.pbj_manager import PBJManager, Started
from portbench.reference.ws_manager import WSManager

__all__ = ["ProvisioningSystem"]


class ProvisioningSystem(abc.ABC):
    """Base class of the four paper systems (and any new policy).

    Concrete subclasses must set four attributes in ``__init__``:

      * ``cluster`` — the :class:`~repro.core.cluster.Cluster` ledger,
      * ``pbj``     — the batch-queue TRE manager,
      * ``ws``      — the web-service TRE manager,
      * ``lease_seconds`` — the lease time unit L driving tick events,

    and implement the three policy hooks (``startup``, ``on_ws_demand``,
    ``on_lease_tick``). ``submit``/``on_finish`` default to delegating
    to the PBJ manager's queue + first-fit scheduler; systems where jobs
    bypass the queue (EC2's per-user leasing) override them.
    """

    cluster: Cluster
    pbj: PBJManager
    ws: WSManager
    lease_seconds: float

    # WS demand units dropped because demand exceeded surviving capacity
    # (graceful degradation under faults). The pump samples the delta
    # around every handler into the ledger's ``shed`` column.
    shed_count: int = 0

    # ------------------------------------------------------ policy hooks

    @abc.abstractmethod
    def startup(self, t: float, ws_initial: int = 0) -> List[Started]:
        """Perform the system's initial allocation (§5 rule 1/2)."""

    @abc.abstractmethod
    def on_ws_demand(self, t: float, demand: int) -> List[Started]:
        """React to a change of the WS TRE's resource consumption."""

    @abc.abstractmethod
    def on_lease_tick(self, t: float) -> List[Started]:
        """React to a lease time-unit boundary."""

    # ------------------------------------------------------- fault hooks

    def on_fail(self, t: float, k: int) -> List[Started]:
        """``k`` nodes fail at ``t``. Non-abstract on purpose: faults
        are only ever injected explicitly (``EventPump.add_faults``), so
        systems without a failure model (DCS, EC2 baselines) stay valid
        as long as no schedule targets them."""
        raise NotImplementedError(
            f"{type(self).__name__} has no failure model; only inject "
            f"fault schedules into systems implementing on_fail/on_repair")

    def on_repair(self, t: float, k: int) -> List[Started]:
        """``k`` previously-failed nodes return to service at ``t``."""
        raise NotImplementedError(
            f"{type(self).__name__} has no failure model; only inject "
            f"fault schedules into systems implementing on_fail/on_repair")

    # ----------------------------------------------- default job routing

    def submit(self, t: float, job: Job) -> List[Started]:
        """A batch job arrives: queue it and run the first-fit scan."""
        return self.pbj.submit(t, job)

    def on_finish(self, t: float, jid: int, epoch: int) -> List[Started]:
        """A job completes; stale events (killed epochs) are no-ops."""
        _, starts = self.pbj.on_finish(t, jid, epoch)
        return starts
