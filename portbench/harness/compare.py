"""The numbers that decide ``correct``, each beside its limit.

A row of the program is held to the reference's row of the same point
on the same trace. The numbers, each the worst over the rows compared:

* ``completed_gap``: jobs completed, absolute difference (FB and
  FLB-NUB rows), held exactly, as the rounds engine's contract that the
  configuration states (``guarantees``) says;
* ``fb_hours_gap``: FB node-hours, relative difference, held well
  inside that contract's 5 %.

Each cell lists in its traffic file the numbers it compares and their
limits (``limits``)."""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-9)


def row_numbers(pairs: Iterable[Tuple[str, Dict, Dict, str]]
                ) -> Tuple[Dict[str, float], Dict[str, str]]:
    """``pairs``: ``(system kind, program row, reference row, what the
    row is)``. Returns each number over the pairs of its kinds (a number
    with no pair of its kinds is left out), and for each number above 0
    the row that gave it, with both sides' values."""
    out: Dict[str, float] = {}
    where: Dict[str, str] = {}

    def put(name, v, tag, key, got, want):
        if float(v) > out.get(name, 0.0):
            where[name] = f"{tag}: {key} program {got[key]!r} " \
                f"reference {want[key]!r}"
        out[name] = max(out.get(name, 0.0), float(v))

    for kind, got, want, tag in pairs:
        if kind in ("fb", "flb_nub"):
            put("completed_gap", abs(got["completed_jobs"]
                                     - want["completed_jobs"]),
                tag, "completed_jobs", got, want)
        if kind == "fb":
            put("fb_hours_gap", _rel(got["node_hours"], want["node_hours"]),
                tag, "node_hours", got, want)
    return out, where


def checks(numbers: Dict[str, float], limits: Dict[str, float],
           required: Iterable[str]) -> List[Dict]:
    """One check per limit: its number (None when nothing was compared,
    which fails), its limit and whether it holds."""
    out = []
    for name in required:
        v: Optional[float] = numbers.get(name)
        ok = v is not None and math.isfinite(v) and v <= limits[name]
        out.append(dict(name=name, value=v, limit=limits[name], ok=ok))
    return out
