"""The shared event core — one pump under the simulator AND the live bridge.

``EventPump`` is the heap + tie-order + ``Started``-feedback machinery
factored out of the old monolithic ``run_sim`` loop, so the reference
simulator (``repro.sim.engine``) and the live runtime bridge
(``repro.core.runtime_bridge.LiveCloud``) drive one and the same clock
through one :class:`~repro.core.system.ProvisioningSystem` lifecycle.
The simulator drains the heap to the horizon (:meth:`EventPump.run`);
the live bridge advances incrementally (:meth:`EventPump.run_until`)
and injects its own work — training quanta, serving ticks — as CALL
events between the provisioning events.

Event kinds and their simultaneity order (the paper's §5/§6 semantics,
identical to the old engine loop: demand changes apply before lease
ticks, ticks before submits, submits before finishes; CALL slots in
after demand so an embedder's handler at time t still sees any WS
change at t already applied, and any WS event a CALL handler *pushes*
at its own time t dispatches before a tick at t — the live replay's
autoscaler feedback keeps the WS-before-tick invariant for free):

    WS < CALL < TICK < SUBMIT < FINISH < REPAIR < FAIL

Ties within one kind break by push order (a monotone sequence number),
so rebuilding ``run_sim`` on this pump reproduces the old loop's event
order — and therefore its ``SimResult`` rows — bit for bit.

REPAIR/FAIL are the chaos tier (``repro.sim.faults``): both sort after
FINISH at the same timestamp, so a job finishing exactly when its node
dies still completes (the no-lost-jobs invariant of
``CONTRACTS["faults"]`` — and the same convention the rounds engine
gets for free by folding completions before capacity stops). REPAIR
sorts before FAIL so capacity returning at t is visible to a failure
striking at the same t.

``DecisionLedger`` is the structured record both paths write through
the same dispatch site: one entry per provisioning event (startup,
ws-demand, lease-tick, submit, finish) with the handler's argument, the
jobs it started, the kills it caused, and the post-handler node counts.
Two ledgers from the same (PBJ, WS) trace — one live, one simulated —
diff under ``CONTRACTS["live"]`` (``repro.sim.contracts``).

Pure stdlib on purpose: importable with numpy alone, like the rest of
the event engine.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.pbj_manager import Started
from repro_torch.core.system import ProvisioningSystem

__all__ = ["WS", "CALL", "TICK", "SUBMIT", "FINISH", "REPAIR", "FAIL",
           "LedgerEntry", "DecisionLedger", "EventPump"]

# Simultaneity order (see module docstring). WS/TICK/SUBMIT/FINISH keep
# their relative order from the old run_sim loop; CALL is the pump's
# extension point for embedders (the live bridge's training quanta and
# serving ticks) and never occurs in pure simulation. REPAIR/FAIL are
# the fault-injection tier and sort last: finishes beat failures at the
# same instant, repairs beat failures at the same instant.
WS, CALL, TICK, SUBMIT, FINISH, REPAIR, FAIL = 0, 1, 2, 3, 4, 5, 6

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class LedgerEntry:
    """One provisioning decision, as both paths record it."""

    t: float
    kind: str          # "startup" | "ws" | "tick" | "submit" | "finish"
                       # | "fail" | "repair"
    arg: float         # ws: demand; submit/finish: jid; startup:
                       # ws_initial; fail/repair: node count
    started: int       # jobs the handler started
    killed: int        # pbj kill_count delta across the handler — a
                       # kill on a "fail" row is a failure kill, on any
                       # other row a policy kill (§5.1 WS priority)
    pbj_nodes: int     # post-handler allocation of the PBJ TRE
    ws_nodes: int      # post-handler allocation of the WS TRE
    total_nodes: int   # post-handler total allocation of the site
    shed: int = 0      # WS demand units newly shed by the handler
                       # (demand exceeded surviving capacity)


class DecisionLedger:
    """Append-only record of every provisioning decision."""

    def __init__(self) -> None:
        self.entries: List[LedgerEntry] = []

    def record(self, entry: LedgerEntry) -> None:
        self.entries.append(entry)

    # ------------------------------------------------------------ queries

    def demand_series(self) -> List[Tuple[float, int]]:
        """The WS demand step series this run actually applied: the
        startup initial plus every ws-demand event, as (t, demand)
        change points (the live side's autoscaler-derived curve)."""
        out: List[Tuple[float, int]] = []
        for e in self.entries:
            if e.kind == "startup":
                out.append((e.t, int(e.arg)))
            elif e.kind == "ws":
                out.append((e.t, int(e.arg)))
        return out

    def kills(self, kind: Optional[str] = None) -> int:
        """Total kills, optionally restricted to one event kind —
        ``kills("fail")`` counts failure kills, ``kills()`` all kills,
        and their difference the §5.1 policy kills; live-vs-sim diffs
        must not conflate the two."""
        return sum(e.killed for e in self.entries
                   if kind is None or e.kind == kind)

    def sheds(self) -> int:
        """Total WS demand units shed (demand > surviving capacity)."""
        return sum(e.shed for e in self.entries)

    def counts(self) -> dict:
        """Events by kind plus total kills/starts — the summary the
        differential harness prints next to the contract verdict."""
        by_kind: dict = {}
        for e in self.entries:
            by_kind[e.kind] = by_kind.get(e.kind, 0) + 1
        return {"events": by_kind, "kills": self.kills(),
                "failure_kills": self.kills("fail"),
                "sheds": self.sheds(),
                "starts": sum(e.started for e in self.entries)}


def _allocated(cluster, name: str) -> int:
    try:
        return cluster.allocated(name)
    except KeyError:            # a system without that ledger account
        return 0


class EventPump:
    """Heap-ordered event dispatch over one ``ProvisioningSystem``.

    Parameters
    ----------
    system:       the provisioning system whose lifecycle handlers the
                  pump drives.
    duration:     measurement horizon; events beyond ``duration`` are
                  neither scheduled nor dispatched (§6.1). ``math.inf``
                  for an open-ended live session.
    ledger:       optional :class:`DecisionLedger` written at every
                  dispatch.
    finish_gate:  optional predicate over ``Started`` — schedule the
                  job's FINISH event only when it returns True. The
                  live bridge gates out jobs bound to real payloads
                  (their completion is detected by payload progress,
                  not simulated end times); default schedules all.
    """

    def __init__(self, system: ProvisioningSystem,
                 duration: float = math.inf,
                 ledger: Optional[DecisionLedger] = None,
                 finish_gate: Optional[Callable[[Started], bool]] = None):
        self.system = system
        self.duration = duration
        self.ledger = ledger
        self.finish_gate = finish_gate
        self.now = 0.0
        self._heap: List[Tuple[float, int, int, object]] = []
        self._seq = itertools.count()
        self._past_horizon = False

    # ------------------------------------------------------- scheduling

    def push(self, t: float, kind: int, payload: object = None) -> None:
        if t <= self.duration + _EPS:
            heapq.heappush(self._heap, (t, kind, next(self._seq), payload))

    def push_starts(self, starts: List[Started]) -> None:
        for s in starts:
            if self.finish_gate is None or self.finish_gate(s):
                self.push(s.end_time, FINISH, (s.job.jid, s.epoch))

    def add_jobs(self, jobs: Sequence) -> None:
        for job in jobs:
            self.push(job.submit, SUBMIT, job)

    def add_ws_trace(self, ws_trace: Sequence[Tuple[float, int]]) -> int:
        """Schedule a WS demand step series; entries at t <= 0 collapse
        into the returned initial demand (pass it to :meth:`startup`)."""
        ws_initial = 0
        for t, d in ws_trace:
            if t <= 0:
                ws_initial = d
            else:
                self.push(t, WS, d)
        return ws_initial

    def add_faults(self, schedule) -> None:
        """Schedule a :class:`repro.sim.faults.FaultSchedule` (any object
        with an ``events()`` iterator of ``(t, delta)`` pairs — +k means
        k nodes fail at t, -k means k nodes repaired). Events at t <= 0
        are dropped: the startup allocation always sees full capacity,
        matching the rounds engine's packing."""
        for t, delta in schedule.events():
            if t <= 0:
                continue
            if delta > 0:
                self.push(t, FAIL, delta)
            else:
                self.push(t, REPAIR, -delta)

    def add_lease_ticks(self, lease_seconds: float) -> None:
        if lease_seconds <= 0:
            raise ValueError(
                f"lease_seconds must be > 0, got {lease_seconds}")
        k = 1
        while k * lease_seconds <= self.duration:
            self.push(k * lease_seconds, TICK, None)
            k += 1

    # --------------------------------------------------------- dispatch

    def startup(self, ws_initial: int = 0) -> None:
        self._dispatch("startup", 0.0, float(ws_initial),
                       lambda: self.system.startup(0.0,
                                                   ws_initial=ws_initial))

    def _dispatch(self, kind: str, t: float, arg: float,
                  handler: Callable[[], List[Started]]) -> None:
        kills0 = self.system.pbj.kill_count
        shed0 = getattr(self.system, "shed_count", 0)
        starts = handler()
        self.push_starts(starts)
        if self.ledger is not None:
            cl = self.system.cluster
            self.ledger.record(LedgerEntry(
                t=t, kind=kind, arg=arg, started=len(starts),
                killed=self.system.pbj.kill_count - kills0,
                pbj_nodes=_allocated(cl, self.system.pbj.name),
                ws_nodes=_allocated(cl, self.system.ws.name),
                total_nodes=cl.total_allocated,
                shed=getattr(self.system, "shed_count", 0) - shed0))

    def step(self) -> bool:
        """Dispatch the next event. Returns False when the heap is empty
        or every remaining event lies beyond the horizon."""
        if not self._heap or self._past_horizon:
            return False
        t, kind, _, payload = heapq.heappop(self._heap)
        if t > self.duration + _EPS:
            # The heap pops in time order: everything left is later still.
            self._past_horizon = True
            return False
        self.now = t
        sys_ = self.system
        if kind == SUBMIT:
            self._dispatch("submit", t, float(payload.jid),
                           lambda: sys_.submit(t, payload))
        elif kind == FINISH:
            jid, epoch = payload
            self._dispatch("finish", t, float(jid),
                           lambda: sys_.on_finish(t, jid, epoch))
        elif kind == WS:
            self._dispatch("ws", t, float(payload),
                           lambda: sys_.on_ws_demand(t, payload))
        elif kind == TICK:
            self._dispatch("tick", t, -1.0,
                           lambda: sys_.on_lease_tick(t))
        elif kind == FAIL:
            self._dispatch("fail", t, float(payload),
                           lambda: sys_.on_fail(t, payload))
        elif kind == REPAIR:
            self._dispatch("repair", t, float(payload),
                           lambda: sys_.on_repair(t, payload))
        else:                               # CALL — embedder extension
            # Not a provisioning decision: no ledger entry of its own,
            # but anything it starts or pushes flows through the pump
            # (and the ledger) like any other event.
            self.push_starts(payload(t) or [])
        return True

    def run(self) -> None:
        """Drain the heap to the horizon (the simulator's mode)."""
        while self.step():
            pass

    def run_until(self, t_stop: float) -> None:
        """Dispatch every pending event with t <= ``t_stop`` and advance
        the clock to ``t_stop`` (the live bridge's incremental mode)."""
        t_stop = min(t_stop, self.duration)
        while (self._heap and not self._past_horizon
               and self._heap[0][0] <= t_stop + _EPS):
            self.step()
        self.now = max(self.now, t_stop)
