# Frozen copy of src/repro_torch/core/jobs.py, imports re-pointed at this
# package: part of the benchmark's plain reference, which imports
# nothing of the program.
"""Parallel-batch-job (== training-job) primitives.

A job in the paper is a rigid parallel application: it demands ``size``
nodes for ``runtime`` seconds. In the TPU adaptation a job additionally
names the architecture config it trains (``arch``) so the runtime bridge
can launch a real ``train_step`` payload; the provisioning logic only ever
looks at ``size``/``runtime``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Job:
    jid: int
    submit: float          # submission time (s)
    size: int              # rigid node/chip demand
    runtime: float         # execution seconds needed (fresh run)
    arch: Optional[str] = None   # payload architecture (TPU adaptation)
    min_size: Optional[int] = None  # elastic floor (beyond-paper; None = rigid)

    # Mutable bookkeeping.
    start: float = -1.0
    end: float = -1.0
    kills: int = 0
    completed: bool = False
    # Beyond-paper checkpoint-preempt: completed work carried across kills.
    progress: float = 0.0

    def remaining(self, checkpoint_preempt: bool) -> float:
        if checkpoint_preempt:
            return max(0.0, self.runtime - self.progress)
        return self.runtime

    @property
    def turnaround(self) -> float:
        assert self.completed
        return self.end - self.submit

    @property
    def execution(self) -> float:
        assert self.completed
        return self.end - self.start


class JobQueue:
    """FCFS-ordered queue with the paper's first-fit scan (§6.5.2)."""

    def __init__(self) -> None:
        self._q: List[Job] = []

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return iter(self._q)

    def push(self, job: Job) -> None:
        """Insert keeping arrival order (killed jobs keep their position)."""
        # Jobs arrive mostly in order; killed jobs re-enter near the front.
        i = len(self._q)
        while i > 0 and self._q[i - 1].submit > job.submit:
            i -= 1
        self._q.insert(i, job)

    def accumulated_demand(self) -> int:
        """Sum of node demands of all queued jobs (the §5.2 numerator)."""
        return sum(j.size for j in self._q)

    def biggest(self) -> Optional[Job]:
        if not self._q:
            return None
        return max(self._q, key=lambda j: j.size)

    def first_fit(self, free: int) -> List[Job]:
        """Pop every job that fits, scanning in arrival order (§6.5.2).

        "Scans all the queued jobs in the order of job arrival and chooses
        the first job whose resources requirement can be met" — applied
        repeatedly until nothing fits.
        """
        started: List[Job] = []
        kept: List[Job] = []
        for job in self._q:
            if job.size <= free:
                free -= job.size
                started.append(job)
            else:
                kept.append(job)
        self._q = kept
        return started


class RunningSet:
    """Running jobs with completion times and the §5.1 kill ordering."""

    def __init__(self) -> None:
        self._running: Dict[int, Tuple[Job, float]] = {}
        self._epoch = itertools.count()   # disambiguates stale finish events

    def __len__(self) -> int:
        return len(self._running)

    def __contains__(self, jid: int) -> bool:
        return jid in self._running

    def jobs(self) -> List[Job]:
        return [j for j, _ in self._running.values()]

    def used(self) -> int:
        return sum(j.size for j, _ in self._running.values())

    def add(self, job: Job, end_time: float) -> int:
        epoch = next(self._epoch)
        self._running[job.jid] = (job, end_time)
        return epoch

    def pop(self, jid: int) -> Tuple[Job, float]:
        return self._running.pop(jid)

    def kill_order(self) -> List[Job]:
        """§5.1 rule 2: smallest size first; ties → latest start first."""
        return sorted(self.jobs(), key=lambda j: (j.size, -j.start))
