"""The round step's work, counted from the lanes' inputs and frozen here.

A lane is one (workload, sweep point) pair: a job table, a WS demand
series and the point's policy scalars, simulated over the horizon. What
the lane needs, whatever kernel computes it:

* bytes: its inputs read once (three values a job: submit, size,
  runtime; two a WS step: time and demand; its policy scalars) and its
  row written once (``ROW_VALUES``), at ``VALUE_BYTES`` each;
* operations: ``OPS_PER_EVENT`` for each event its inputs hold: every
  arrival, every finish (one per job), every WS step and every lease
  tick of the horizon. ``OPS_PER_EVENT`` is a floor: the next-event
  minimum, the clock's advance and the row's accumulators each take at
  least one operation an event.

The count never reads how the program steps (its window, its rounds or
its outer steps), so a redesigned kernel is held to the same yardstick.
"""

from __future__ import annotations

import math

VALUE_BYTES = 4            # the float32 pack the configurations state
ROW_VALUES = 11            # rounds.ACC_KEYS: the row's accumulators
OPS_PER_EVENT = 16


def lane_work(n_jobs: int, n_ws_steps: int, duration: float,
              lease_seconds: float, n_params: int):
    """``(bytes, operations)`` one lane needs."""
    events = 2 * n_jobs + n_ws_steps + math.ceil(duration / lease_seconds)
    nbytes = VALUE_BYTES * (3 * n_jobs + 2 * n_ws_steps + n_params
                            + ROW_VALUES)
    return nbytes, OPS_PER_EVENT * events


def roofline_seconds(nbytes: float, ops: float, peak_ops: float,
                     peak_bytes_per_s: float):
    """The least time the work could take and what bounds it."""
    t_b, t_o = nbytes / peak_bytes_per_s, ops / peak_ops
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")
