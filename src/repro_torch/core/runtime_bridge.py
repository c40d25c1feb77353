"""Runtime bridge — PhoenixCloud TREs driving *real* JAX payloads.

The simulator (``repro.sim``) exercises the provisioning policies against
traces; this bridge exercises them against actual work: PBJ jobs run
``TrainJob`` steps, WS replicas run the serving engine, and the
ResourceProvisionService moves *logical chip leases* between them. On the
CPU container every logical chip maps to the same physical device — the
provisioning layer is deliberately agnostic to that mapping (it tracks
leases, not devices), exactly as the paper's provision service tracks
nodes, not their MAC addresses.

Since the event-core unification, the bridge runs on the SAME
:class:`~repro.sim.pump.EventPump` as the reference simulator: one heap,
one clock, one ``ProvisioningSystem`` lifecycle. ``set_ws_demand`` /
``lease_tick`` are ordinary pump events; ``run_quantum`` is a CALL
handler that pushes FINISH events for payloads that completed; and
checkpoint-preempt is first-class — a ``PBJManager.preempt_hooks`` entry
checkpoints the real payload at the manager's single kill site, whatever
provisioning path caused the kill. Every decision lands in the same
:class:`~repro.sim.pump.DecisionLedger` format the simulator writes, so
live and simulated runs of one trace diff directly
(``CONTRACTS["live"]``, ``tests/test_live_vs_sim.py``).

This is what ``examples/consolidation_live.py`` runs end-to-end: a live
FB-policy cloud where a serving spike force-preempts (checkpoint, not
kill — the beyond-paper mode) a training job and the job later resumes
from its checkpoint on the recovered chips.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.jobs import Job
from repro_torch.core.lifecycle import LifecycleManagementService
from repro_torch.core.pbj_manager import PBJManager, PBJPolicyParams
from repro_torch.core.provision import FBProvisionService
from repro_torch.core.spec import (CoordinationModel, Granularity,
                             Relationship, ResourceBounds,
                             RuntimeEnvironmentSpec, SetupPolicy,
                             WorkloadType)
from repro_torch.core.ws_manager import WSManager
from repro_torch.sim.pump import (CALL, FINISH, SUBMIT, TICK, WS,
                            DecisionLedger, EventPump)


@dataclasses.dataclass
class LiveJob:
    """A PBJ queue entry bound to a real TrainJob payload."""

    job: Job
    payload: "TrainJob"
    steps_per_grant: int = 10


class LiveCloud:
    """A miniature live PhoenixCloud site under the FB policy.

    Chips are logical lease tokens (capacity C); the PBJ TRE runs real
    training steps whenever it holds >= job.size chips; the WS TRE's
    demand is driven by the serving autoscaler (or a replayed trace).
    Preemption uses checkpoint-preempt: the payload checkpoints and the
    queue entry keeps its progress.

    Jobs come in two tiers sharing the one pump:

      * **live** jobs (``submit_training``) carry a real ``TrainJob``;
        their ``runtime`` is in *steps* and completion is detected by
        payload progress inside ``run_quantum``, so the pump's
        auto-FINISH scheduling is gated off for them;
      * **virtual** jobs (``submit_job`` / ``load_trace``) are plain
        trace entries in seconds; the pump schedules their FINISH from
        ``Started.end_time`` exactly as the simulator does — the replay
        tier (``repro.serving.replay``) that runs days of trace in
        seconds.
    """

    def __init__(self, capacity: int, mesh=None, *,
                 lease_seconds: float = 60.0,
                 checkpoint_root: str = "/tmp/phoenixcloud_ckpt",
                 duration: float = math.inf, ws_initial: int = 0,
                 ws: Optional[WSManager] = None,
                 ledger: Optional[DecisionLedger] = None):
        self.mesh = mesh
        self.lifecycle = LifecycleManagementService()
        params = PBJPolicyParams(checkpoint_preempt=True)
        self.pbj = PBJManager(params=params)
        self.pbj.preempt_hooks.append(self._checkpoint_victim)
        self.ws = ws if ws is not None else WSManager()
        self.service = FBProvisionService(capacity, self.pbj, self.ws,
                                          lease_seconds)
        self.checkpoint_root = checkpoint_root
        self._live: Dict[int, LiveJob] = {}
        self._register_tres(capacity)
        self.ledger = ledger if ledger is not None else DecisionLedger()
        self.pump = EventPump(
            self.service, duration, ledger=self.ledger,
            # Live payloads finish by real progress, not simulated time.
            finish_gate=lambda s: s.job.jid not in self._live)
        self.pump.startup(ws_initial=ws_initial)

    @property
    def t(self) -> float:
        """The shared clock — the pump's, not a bridge-private one."""
        return self.pump.now

    def _register_tres(self, capacity: int) -> None:
        pbj_spec = RuntimeEnvironmentSpec(
            name="pbj_tre", relationship=Relationship.AFFILIATED,
            workload=WorkloadType.PARALLEL_BATCH_JOBS,
            granularity=Granularity.CHIP_SLICE,
            coordination=CoordinationModel.FB,
            bounds=ResourceBounds(capacity, capacity),
            setup_policy=SetupPolicy.RELOAD)
        ws_spec = dataclasses.replace(
            pbj_spec, name="ws_tre", workload=WorkloadType.WEB_SERVICE)
        self.lifecycle.create(pbj_spec)
        self.lifecycle.create(ws_spec)
        self.lifecycle.activate("pbj_tre", self.pbj)
        self.lifecycle.activate("ws_tre", self.ws)
        assert self.lifecycle.tre("pbj_tre").partner == "ws_tre"

    # --------------------------------------------------------------- API

    def submit_training(self, jid: int, arch: str, chips: int,
                        steps: int = 30, batch: int = 4,
                        seq_len: int = 64) -> None:
        """Submit a live training job with a real TrainJob payload."""
        from repro_torch.configs.base import get_config, reduced_config
        from repro_torch.train.trainer import TrainJob, TrainJobConfig
        rcfg = reduced_config(get_config(arch))
        payload = TrainJob(rcfg, TrainJobConfig(
            arch=arch, steps=steps, batch=batch, seq_len=seq_len,
            checkpoint_dir=f"{self.checkpoint_root}/job{jid}",
            checkpoint_every=10), self.mesh)
        job = Job(jid=jid, submit=self.t, size=chips,
                  runtime=float(steps))   # runtime in steps (bridge units)
        self._live[jid] = LiveJob(job, payload)
        self.submit_job(job)

    def submit_job(self, job: Job) -> None:
        """Submit a virtual (trace) job — or the Job half of a live one —
        through the pump at the current time."""
        self.pump.push(max(self.t, job.submit), SUBMIT, job)
        self.pump.run_until(self.t)

    def load_trace(self, jobs: Sequence[Job],
                   ws_trace: Sequence[Tuple[float, int]] = (),
                   lease_ticks: bool = False) -> None:
        """Pre-schedule a whole trace (the replay tier): virtual jobs,
        WS demand change points, and — when the demand stream is the
        trace itself rather than a live autoscaler — the lease ticks."""
        self.pump.add_jobs(jobs)
        for t, d in ws_trace:
            if t > 0:
                self.pump.push(t, WS, d)
        if lease_ticks:
            self.pump.add_lease_ticks(self.service.lease_seconds)

    def inject_faults(self, schedule) -> None:
        """Chaos tier: schedule a :class:`repro.sim.faults.FaultSchedule`
        on the shared pump. FAIL/REPAIR events dispatch through the FB
        service's ``on_fail``/``on_repair`` exactly as in the simulator
        — the same schedule replayed here and in ``run_sim`` produces
        the same decision ledger, which is what the chaos differential
        (``benchmarks.run faults``, ``tests/test_faults.py``) diffs.
        Live payloads killed by a failure checkpoint through the same
        ``preempt_hooks`` entry as any WS-spike preemption."""
        self.pump.add_faults(schedule)

    def set_ws_demand(self, demand: int) -> None:
        self.pump.push(self.t, WS, demand)
        self.pump.run_until(self.t)

    def lease_tick(self) -> None:
        t1 = self.t + self.service.lease_seconds
        self.pump.push(t1, TICK, None)
        self.pump.run_until(t1)

    def run_until(self, t_stop: float) -> None:
        """Advance the shared clock, dispatching everything scheduled."""
        self.pump.run_until(t_stop)

    def run_quantum(self, steps: int = 10) -> List[int]:
        """Run every currently-scheduled live job for ``steps`` train
        steps (the bridge's time quantum); returns finished jids. A CALL
        event on the pump: completions it detects become FINISH events
        dispatched — and ledgered — like any simulated completion."""
        finished: List[int] = []
        self.pump.push(self.t, CALL,
                       lambda t: self._quantum(t, steps, finished))
        self.pump.run_until(self.t)
        return finished

    def _quantum(self, t: float, steps: int, finished: List[int]):
        for jid in list(self._live):
            lj = self._live[jid]
            if lj.job.jid not in self.pbj.running:
                continue   # queued or preempted
            payload = lj.payload
            target = min(payload.jc.steps, payload.step + steps)
            saved = payload.jc.steps
            payload.jc.steps = target
            payload.run()
            payload.jc.steps = saved
            lj.job.progress = float(payload.step)
            if payload.step >= saved:
                epoch = self.pbj._epochs.get(jid, -1)
                # Ungate before pushing: on_finish must see a normal job.
                del self._live[jid]
                self.pump.push(t, FINISH, (jid, epoch))
                finished.append(jid)
        return []

    def preempt_for_ws(self, demand: int) -> List[int]:
        """A WS spike. Checkpointing happens in the preempt hook at the
        manager's kill site; this helper just reports who was preempted."""
        before = {j.jid for j in self.pbj.running.jobs()}
        self.set_ws_demand(demand)
        after = {j.jid for j in self.pbj.running.jobs()}
        return sorted(before - after)

    # ---------------------------------------------------------- internals

    def _checkpoint_victim(self, t: float, job: Job) -> None:
        """preempt_hooks entry: checkpoint the real payload of a killed
        live job and pin its progress to the payload's step count (the
        bridge's time unit — overriding the manager's wall-clock
        progress formula, which is correct only for virtual jobs)."""
        lj = self._live.get(job.jid)
        if lj is None:
            return
        lj.payload.checkpoint(block=True)
        job.progress = float(lj.payload.step)
