"""What the readers of the program's own spans share.

The program records a span at each stage boundary of its sweep path
while a profiler runs (``repro_torch.spans``): a dict with ``name``,
``id``, ``parent``, ``root``, ``start_ns``, ``end_ns`` (``time.time_ns``,
the clock of the device trace's events) and ``attrs``. A reader keeps
the spans that lie inside the traced window ``[run.t0_ns, run.t1_ns]``
and returns None when it finds none of its own, so the metric is left
out of the line: a program without the recorder records none."""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional

import numpy as np

from portbench.harness.trace import _union


def window_spans(run) -> List[Dict]:
    """The program's spans inside the window."""
    try:
        recorder = importlib.import_module("repro_torch.spans")
    except ModuleNotFoundError as e:
        if e.name != "repro_torch.spans":
            raise
        return []
    return [s for s in recorder.recorded()
            if s["start_ns"] >= run.t0_ns and s["end_ns"] <= run.t1_ns]


def named(spans: List[Dict], name: str, under: str = None) -> List[Dict]:
    """The spans called ``name``; with ``under``, only those with an
    enclosing span of that name."""
    by_id = {s["id"]: s for s in spans}

    def inside(s):
        p = by_id.get(s["parent"])
        while p is not None:
            if p["name"] == under:
                return True
            p = by_id.get(p["parent"])
        return False

    return [s for s in spans
            if s["name"] == name and (under is None or inside(s))]


def self_ns(span: Dict, spans: List[Dict], child: str = None) -> int:
    """``span``'s duration less the part of it that its child spans
    (those called ``child``, if given) cover."""
    kids = [(max(s["start_ns"], span["start_ns"]),
             min(s["end_ns"], span["end_ns"])) for s in spans
            if s["parent"] == span["id"]
            and (child is None or s["name"] == child)]
    covered = _union(np.array([k for k in kids if k[1] > k[0]],
                              np.int64).reshape(-1, 2))
    return (span["end_ns"] - span["start_ns"]
            - int((covered[:, 1] - covered[:, 0]).sum()))


def idle_ns(spans: List[Dict], busy: np.ndarray) -> int:
    """The ns of the spans' intervals (their union) in which the device
    was idle: ``busy`` holds the device's disjoint, sorted busy
    intervals (``DeviceTrace.busy``)."""
    iv = _union(np.array([(s["start_ns"], s["end_ns"]) for s in spans],
                         np.int64).reshape(-1, 2))
    busy = np.asarray(busy, np.int64).reshape(-1, 2)
    lens = busy[:, 1] - busy[:, 0]
    cum = np.concatenate([[0], np.cumsum(lens)])

    def busy_before(t):
        i = np.searchsorted(busy[:, 0], t, "right")     # starts <= t
        j = np.maximum(i - 1, 0)
        part = np.clip(t - busy[j, 0], 0, lens[j]) if len(busy) else 0
        return np.where(i > 0, cum[j] + part, 0)

    overlap = busy_before(iv[:, 1]) - busy_before(iv[:, 0])
    return int((iv[:, 1] - iv[:, 0]).sum() - overlap.sum())


def ms_per_query(run, ns: int) -> Optional[float]:
    return ns / 1e6 / run.queries if run.queries else None


def stage_ms(run, name: str, under: str = None) -> Optional[float]:
    """The summed duration of the spans ``name`` (inside ``under``), ms
    a query."""
    found = named(window_spans(run), name, under)
    if not found:
        return None
    return ms_per_query(run, sum(s["end_ns"] - s["start_ns"]
                                 for s in found))
