"""PBJ TRE Manager — the batch-queue (training-job) runtime environment.

Implements the paper's resource-management policies:

  * first-fit scheduling (§6.5.2) via ``JobQueue.first_fit``;
  * the FB kill path (§5.1 rule 2): release idle first, then kill running
    jobs smallest-size-first (latest start breaks ties) and requeue them;
  * the FLB-NUB elastic policy (§5.2): on each lease tick compute the
    *ratio of adjusting resources* = queued demand / owned nodes and apply
    the U (request, DR1/DR2) and V/G (release, RSS) rules.

Beyond-paper: ``checkpoint_preempt=True`` turns the kill into a
checkpoint-preempt — killed jobs keep their completed progress and only
need the remainder re-run (quantified in EXPERIMENTS.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.jobs import Job, JobQueue, RunningSet


@dataclasses.dataclass(frozen=True)
class PBJPolicyParams:
    """§5.2 knobs. Baseline values from §6.6.3: U=1.2, V=0.2, G=0.5.

    A jax pytree (U/V/G are data leaves, the preemption mode is static
    metadata) so policy parameters flow directly into the jitted sweep
    paths — ``repro.sim.scan`` builds its vmapped U/V/G grids from these
    fields, and a batch of params can itself be ``tree_map``-ed or
    stacked for parameter studies. The registration lives in
    ``repro.sim.scan`` (the jax-side consumer): this module stays
    importable with numpy alone, like the rest of the event engine.
    """

    request_threshold: float = 1.2     # U — threshold ratio of requesting
    release_threshold: float = 0.2     # V — threshold ratio of releasing
    elastic_factor: float = 0.5        # G — fraction of idle released
    checkpoint_preempt: bool = False   # beyond-paper preemption mode


@dataclasses.dataclass(frozen=True)
class Started:
    job: Job
    end_time: float
    epoch: int


class PBJManager:
    """Manager + Scheduler of the parallel-batch-jobs TRE."""

    def __init__(self, name: str = "PBJ",
                 params: PBJPolicyParams = PBJPolicyParams()):
        self.name = name
        self.params = params
        self.owned = 0                  # nodes currently owned by this TRE
        self.queue = JobQueue()
        self.running = RunningSet()
        self._epochs: Dict[int, int] = {}
        self._next_epoch = 0
        self.completed: List[Job] = []
        self.kill_count = 0
        # Called at the single kill site as hook(t, job), after progress
        # bookkeeping and before the job re-enters the queue. The live
        # bridge registers the checkpoint-preempt of its real payloads
        # here — first-class for EVERY kill path (WS spikes, replayed
        # demand, force_release), not just an interactive helper.
        self.preempt_hooks: List[Callable[[float, Job], None]] = []

    # ------------------------------------------------------------- state

    @property
    def free(self) -> int:
        return self.owned - self.running.used()

    def _start(self, t: float, job: Job) -> Started:
        job.start = t
        end = t + job.remaining(self.params.checkpoint_preempt)
        self._next_epoch += 1
        self._epochs[job.jid] = self._next_epoch
        self.running.add(job, end)
        return Started(job, end, self._next_epoch)

    def schedule(self, t: float) -> List[Started]:
        """First-fit scan over the queue (§6.5.2)."""
        return [self._start(t, j) for j in self.queue.first_fit(self.free)]

    # ------------------------------------------------------------- events

    def submit(self, t: float, job: Job) -> List[Started]:
        self.queue.push(job)
        return self.schedule(t)

    def start_immediately(self, t: float, job: Job) -> Started:
        """Grant the job its own nodes and start it, bypassing the queue.

        The EC2 per-user leasing model (§6.6.1): each end user leases
        exactly ``job.size`` nodes at submission, so the manager's owned
        count grows by the job's size and the job runs at once. This is
        the public API for queue-less systems — completion bookkeeping
        (epochs, running set, ``on_finish``) stays consistent with the
        scheduled path.
        """
        self.owned += job.size
        return self._start(t, job)

    def on_finish(self, t: float, jid: int, epoch: int) -> Tuple[Optional[Job], List[Started]]:
        """Handle a completion event; stale events (killed job) are no-ops."""
        if jid not in self.running or self._epochs.get(jid) != epoch:
            return None, []
        job, _ = self.running.pop(jid)
        del self._epochs[jid]
        job.end = t
        job.completed = True
        job.progress = job.runtime
        self.completed.append(job)
        return job, self.schedule(t)

    def grant(self, t: float, n: int) -> List[Started]:
        """Receive provisioned resources (§5.1 rule 1 / §5.2 rule 5)."""
        assert n >= 0
        self.owned += n
        return self.schedule(t) if n > 0 else []

    # ------------------------------------------------- FB forced release

    def force_release(self, t: float, n: int) -> Tuple[int, List[Started]]:
        """FB §5.1 rule 2: give back exactly ``n`` nodes (idle, then kills).

        Returns (released, restarts): ``released == n`` whenever
        ``owned >= n``. Killed jobs are requeued and may immediately
        restart in leftover freed space.
        """
        n = min(n, self.owned)
        if n == 0:
            return 0, []
        need = n - self.free
        if need > 0:
            for victim in self.running.kill_order():
                if need <= 0:
                    break
                self._kill(t, victim)
                need -= victim.size
        assert self.free >= n, (self.free, n, self.owned)
        self.owned -= n
        # Leftover freed capacity (kill overshoot) may restart queued jobs.
        return n, self.schedule(t)

    def _kill(self, t: float, job: Job) -> None:
        self.running.pop(job.jid)
        del self._epochs[job.jid]
        job.kills += 1
        self.kill_count += 1
        if self.params.checkpoint_preempt:
            job.progress = min(job.runtime, job.progress + (t - job.start))
        for hook in self.preempt_hooks:
            hook(t, job)
        job.start = -1.0
        self.queue.push(job)   # re-enters at its arrival-order position

    # ------------------------------------------------- FLB-NUB lease tick

    def adjust(self, t: float) -> Tuple[str, int]:
        """§5.2 rules 2–4. Returns ('request'|'release'|'hold', n)."""
        demand = self.queue.accumulated_demand()
        if self.owned == 0:
            ratio = math.inf if demand > 0 else 0.0
        else:
            ratio = demand / self.owned
        p = self.params
        if ratio > p.request_threshold:
            dr1 = demand - self.owned            # §5.2 rule 2
            if dr1 > 0:
                return "request", dr1
        biggest = self.queue.biggest()
        if biggest is not None and biggest.size > self.owned:
            dr2 = biggest.size - self.free        # §5.2 rule 3
            if dr2 > 0:
                return "request", dr2
        if ratio < p.release_threshold and self.free > 0:
            rss = int(p.elastic_factor * self.free)   # §5.2 rule 4
            if rss > 0:
                return "release", rss
        return "hold", 0

    def confirm_release(self, n: int) -> None:
        assert 0 <= n <= self.free, (n, self.free)
        self.owned -= n
