"""The reference's side of the check for many lanes, made in worker
processes.

Each task is one lane: it is made again from its seed by the frozen
draws and transforms, and its points run through the frozen event
engine. Lanes are independent, so the check after the window spreads
them over a few processes (``spawn``: nothing of the parent's card or
threads is inherited) and waits for every one."""

from __future__ import annotations

import multiprocessing
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# (lane seed, site, points, dtype name, the program's tables of the
# lane or None); a site is the keyword arguments of
# ``reference.scenarios.lane_tables`` with its two parameter dicts,
# ``pbj`` and ``ws``.
Task = Tuple[int, Dict, Sequence[Dict], str, Optional[Dict]]


def same_inputs(got: Dict, want: Dict) -> bool:
    """Whether two tables of a lane give the engine the same jobs and
    demands up to the last bits of the times: equal job counts, sizes
    and WS demands."""
    n = int(want["n_jobs"])
    return (int(got["n_jobs"]) == n
            and np.array_equal(got["size"][:n], want["size"][:n])
            and np.array_equal(got["ws_values"], want["ws_values"]))


def _lane(seed: int, site: Dict, dtype: str) -> Dict:
    import torch
    from portbench.reference import scenarios as ref_scen
    return ref_scen.lane_tables(seed, dtype=getattr(torch, dtype), **site)


def _rows(tabs: Dict, site: Dict, points: Sequence[Dict]) -> List[Dict]:
    from portbench.reference import rows as ref_rows
    from portbench.reference import scenarios as ref_scen
    jobs, ws = ref_scen.lane_workload(tabs)
    return [ref_rows.reference_row(p, jobs, ws, site["duration"])
            for p in points]


def made_lane(task: Task) -> Tuple[Dict, List[Dict]]:
    """The reference's tables of the lane and its rows of ``points``."""
    seed, site, points, dtype, _ = task
    tabs = _lane(seed, site, dtype)
    return tabs, _rows(tabs, site, points)


def judged_lane(task: Task) -> Tuple[Dict[str, float], Optional[List]]:
    """The table numbers of the program's tables of the lane against the
    reference's, and the reference's rows of ``points``, or None where
    the two tables give the engine other inputs."""
    from portbench.harness import tables
    seed, site, points, dtype, got = task
    want = _lane(seed, site, dtype)
    nums = tables.table_numbers([(got, want)])
    if not same_inputs(got, want):
        return nums, None
    return nums, _rows(want, site, points)


def _worker_init():
    import torch
    torch.set_num_threads(1)


def rows_of(tasks: Sequence[Task], workers: int,
            fn: Callable = judged_lane) -> List:
    """``fn`` of every task, in order, on ``workers`` processes (in this
    one where ``workers`` is 1 or less)."""
    if workers <= 1 or len(tasks) < 2:
        return [fn(t) for t in tasks]
    pool = multiprocessing.get_context("spawn").Pool(
        min(workers, len(tasks)), initializer=_worker_init)
    try:
        out = pool.map(fn, tasks, chunksize=1)
        pool.close()
    finally:
        pool.terminate()
        pool.join()
    return out
