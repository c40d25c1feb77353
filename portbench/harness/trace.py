"""The device trace of a traced window: device time by kernel, the busy
and idle seconds of the window, and what the host was doing in each idle
gap.

``marked_profile`` is a copy of the repository's ``chip_smoke.py``
helper: a trace on an H100 loses the device records of its first few
kernels, so the work is led by ``PROFILE_MARKS`` short spin kernels that
take that loss; while the trace keeps one mark it kept every record
after it. The reduction reads the raw kineto events, whose timestamps
are nanoseconds on the host's epoch clock (``time.time_ns``)."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.harness.stages import ANNOTATION

PROFILE_MARKS = 256
PROFILE_MARK_CYCLES = 1_000
MARK_NAME = "spin_kernel"


@contextmanager
def marked_profile():
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_MARKS):
            torch.cuda._sleep(PROFILE_MARK_CYCLES)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge ``(n, 2)`` intervals into disjoint sorted ones."""
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out, dtype=np.int64)


class DeviceTrace:
    """The reduction of one traced window ``[t0_ns, t1_ns]``."""

    def __init__(self, prof, t0_ns: int, t1_ns: int):
        from torch.autograd import DeviceType
        self.window_s = (t1_ns - t0_ns) / 1e9
        dev, marks, notes = [], 0, []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                name = e.name()
                if name.startswith(ANNOTATION):   # the stages, as mirrored
                    continue                      # on the device's line
                if MARK_NAME in name:
                    marks += 1
                    continue
                s, d = e.start_ns(), e.duration_ns()
                if s + d > t0_ns and s < t1_ns and d > 0:
                    dev.append((name, max(s, t0_ns), min(s + d, t1_ns)))
            elif e.name().startswith(ANNOTATION):
                notes.append((e.name()[len(ANNOTATION):], e.start_ns(),
                              e.end_ns()))
        self.marks_lost = PROFILE_MARKS - marks
        self.kernels = dev
        iv = np.array([(s, e) for _, s, e in dev], dtype=np.int64)
        self.busy = _union(iv.reshape(-1, 2))
        self.busy_s = float((self.busy[:, 1] - self.busy[:, 0]).sum()) / 1e9
        self._t0, self._t1 = t0_ns, t1_ns
        self._notes = notes

    def kernel_seconds(self, part: str) -> Optional[float]:
        """Device seconds of the kernels whose name holds ``part``, or
        None when the trace holds none."""
        ns = [e - s for name, s, e in self.kernels if part in name]
        return sum(ns) / 1e9 if ns else None

    def top_ops(self, n: int = 10) -> List[List]:
        per: Dict[str, int] = {}
        for name, s, e in self.kernels:
            per[name[:120]] = per.get(name[:120], 0) + (e - s)
        top = sorted(per.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle seconds of the window summed by what the host was doing
        then: the innermost stage annotation holding the gap's middle,
        ``query_other`` inside a query outside any stage, else
        ``between_queries``. The ``n`` largest."""
        edges = np.concatenate([[self._t0], self.busy.ravel(), [self._t1]])
        gaps = edges.reshape(-1, 2)
        gaps = gaps[gaps[:, 1] > gaps[:, 0]]
        stages = sorted((s, e, k) for k, s, e in self._notes
                        if k != "query")
        queries = sorted((s, e) for k, s, e in self._notes if k == "query")
        st_s = np.array([s for s, _, _ in stages], dtype=np.int64)
        q_s = np.array([s for s, _ in queries], dtype=np.int64)
        per: Dict[str, int] = {}
        for a, b in gaps:
            mid = (a + b) // 2
            label = "between_queries"
            i = int(np.searchsorted(q_s, mid, "right")) - 1
            if i >= 0 and queries[i][1] >= mid:
                label = "query_other"
            j = int(np.searchsorted(st_s, mid, "right")) - 1
            if j >= 0 and stages[j][1] >= mid:
                label = stages[j][2]
            per[label] = per.get(label, 0) + int(b - a)
        top = sorted(per.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]
