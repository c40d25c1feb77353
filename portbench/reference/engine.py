# Frozen copy of src/repro_torch/sim/engine.py, imports re-pointed at this
# package: part of the benchmark's plain reference, which imports
# nothing of the program.
"""Discrete-event engine driving any ``ProvisioningSystem`` (§6.3, §6.5).

The engine is a plain event heap (submit / finish / ws-demand / lease
tick) over the five-event lifecycle protocol of
:class:`repro.core.system.ProvisioningSystem` — it is policy-free and
knows nothing about any concrete system. All metrics are measured over
the trace duration, exactly as §6.1 prescribes ("all performance metrics
are obtained in the same period that is the duration of workload
traces").

The four paper systems (§6.3, §6.5, §6.6) are constructed by the
``build_*`` helpers:

  * DCS                — static partition (``core.baselines.DCSSystem``)
  * PhoenixCloud FB    — §5.1 (``core.provision.FBProvisionService``)
  * PhoenixCloud FLB-NUB — §5.2 (``core.provision.FLBNUBProvisionService``)
  * EC2+RightScale     — §6.6.1 (``core.baselines.EC2RightScaleSystem``)

Parameter *sweeps* over grids of systems live in ``repro.sim.sweep``,
which batches the stateless systems as exact vectorized JAX programs,
offers a batched ``lax.scan`` fast path (``repro.sim.scan``) for the
stateful PhoenixCloud policies, and uses this engine as the per-point
reference path (``mode="event"``) that every fast path is
cross-validated against.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from portbench.reference.baselines import DCSSystem, EC2RightScaleSystem
from portbench.reference.jobs import Job
from portbench.reference.pbj_manager import PBJManager, PBJPolicyParams, Started
from portbench.reference.provision import FBProvisionService, FLBNUBProvisionService
from portbench.reference.system import ProvisioningSystem
from portbench.reference.ws_manager import WSManager
from portbench.reference.pump import DecisionLedger, EventPump

# Relative event order for simultaneous times (ws-demand changes apply
# before lease ticks, ticks before submits). The authoritative ordering
# now lives in repro.sim.pump (which adds a CALL kind for the live
# bridge); these legacy codes are the fold-table encoding the sweep
# engine packs into its device tables, kept for that packed format.
_WS, _TICK, _SUBMIT, _FINISH = 0, 1, 2, 3

# The paper's comparison matrix (§6.3, §6.5, §6.6) — the single source of
# truth for valid system names, shared with the sweep engine's
# ``SweepPoint`` validation.
SYSTEMS = ("dcs", "fb", "flb_nub", "ec2")


@dataclasses.dataclass
class SimResult:
    system: str
    duration: float
    completed_jobs: int
    avg_turnaround: float
    avg_execution: float
    node_hours: float
    peak_nodes: int
    adjust_events: int       # all ledger events (incl. WS demand changes)
    pbj_adjust_events: int   # the paper's Fig-18 metric: PBJ TRE only
    kills: int
    jobs: List[Job]

    def row(self) -> dict:
        return {k: getattr(self, k) for k in
                ("system", "completed_jobs", "avg_turnaround",
                 "avg_execution", "node_hours", "peak_nodes",
                 "adjust_events", "pbj_adjust_events", "kills")}


def clone_jobs(jobs: Sequence[Job]) -> List[Job]:
    """Fresh copies — Job carries mutable per-run state, so each system
    must simulate its own copy of the trace."""
    return [Job(jid=j.jid, submit=j.submit, size=j.size, runtime=j.runtime,
                arch=j.arch, min_size=j.min_size) for j in jobs]


# ------------------------------------------------------------ system builders

def build_dcs(prc_pbj: int, prc_ws: int,
              lease_seconds: float = 3600.0) -> DCSSystem:
    return DCSSystem(prc_pbj, prc_ws, PBJManager(), WSManager(),
                     lease_seconds)


def build_fb(capacity: int, lease_seconds: float = 3600.0,
             params: PBJPolicyParams = PBJPolicyParams()) -> FBProvisionService:
    return FBProvisionService(capacity, PBJManager(params=params),
                              WSManager(), lease_seconds)


def build_flb_nub(lb_pbj: int, lb_ws: int, lease_seconds: float = 3600.0,
                  params: PBJPolicyParams = PBJPolicyParams()
                  ) -> FLBNUBProvisionService:
    return FLBNUBProvisionService(lb_pbj, lb_ws, PBJManager(params=params),
                                  WSManager(), lease_seconds)


def build_ec2_rightscale(lease_seconds: float = 3600.0) -> EC2RightScaleSystem:
    return EC2RightScaleSystem(PBJManager(), WSManager(), lease_seconds)


# ----------------------------------------------------------------- the engine

def default_duration(jobs: Sequence[Job],
                     ws_trace: Sequence[Tuple[float, int]]) -> float:
    """§6.1 measurement horizon when none is given: just past the last
    trace event (shared by ``run_sim`` and the sweep engine)."""
    return max([j.submit for j in jobs] + [t for t, _ in ws_trace]) + 1


def run_sim(system: ProvisioningSystem, jobs: Sequence[Job],
            ws_trace: Sequence[Tuple[float, int]],
            duration: Optional[float] = None, name: str = "",
            lease_seconds: Optional[float] = None,
            ledger: Optional[DecisionLedger] = None,
            faults=None) -> SimResult:
    """Drive ``system`` through the trace on the shared event pump.

    ``ledger``, when given, receives one :class:`~repro.sim.pump
    .LedgerEntry` per provisioning event — the structured decision
    record the live-vs-sim differential harness diffs against the live
    bridge's ledger (``CONTRACTS["live"]``).

    ``faults``, when given, is a :class:`repro.sim.faults.FaultSchedule`
    injected as FAIL/REPAIR events (the chaos tier); the system must
    implement ``on_fail``/``on_repair``. ``None`` leaves the event
    stream byte-identical to the pre-fault engine.
    """
    lease = lease_seconds if lease_seconds is not None else system.lease_seconds
    if duration is None:
        duration = default_duration(jobs, ws_trace)
    pump = EventPump(system, duration, ledger=ledger)
    # Push order (jobs, ws, ticks, faults, then startup) fixes the
    # sequence numbers that break within-kind ties — identical to the
    # old monolithic loop, so rows reproduce bit for bit.
    pump.add_jobs(jobs)
    ws_initial = pump.add_ws_trace(ws_trace)
    pump.add_lease_ticks(lease)
    if faults is not None:
        pump.add_faults(faults)
    pump.startup(ws_initial=ws_initial)
    pump.run()
    return summarize(system, jobs, duration, name)


def summarize(system: ProvisioningSystem, jobs: Sequence[Job],
              duration: float, name: str = "") -> SimResult:
    """Finalize the site ledger and measure the §6.1 metrics — shared by
    ``run_sim`` and the live replay harness (``repro.serving.replay``),
    so both paths' rows are built by the same accounting."""
    system.cluster.finalize(duration)
    done = [j for j in jobs if j.completed]
    return SimResult(
        system=name or type(system).__name__,
        duration=duration,
        completed_jobs=len(done),
        avg_turnaround=(sum(j.turnaround for j in done) / len(done)) if done else 0.0,
        avg_execution=(sum(j.execution for j in done) / len(done)) if done else 0.0,
        node_hours=system.cluster.node_hours,
        peak_nodes=system.cluster.peak,
        adjust_events=system.cluster.adjust_events(),
        pbj_adjust_events=system.cluster.adjust_events(system.pbj.name),
        kills=system.pbj.kill_count,
        jobs=list(jobs),
    )
