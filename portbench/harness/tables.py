"""Generated lanes held to the reference's: the numbers that compare a
lane's job table and WS series, each the worst over the lanes compared.

* ``tables_time``: submit times (in arrival order) and runtimes (in
  (size, runtime) order), relative difference;
* ``tables_count``: job counts and sizes: the count's difference plus
  the sizes that differ in sorted order (a multiset, so two jobs that
  arrive within rounding of each other may swap);
* ``tables_ws``: the share of WS steps whose demand differs."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np


def table_numbers(pairs: Iterable[Tuple[Dict, Dict]]) -> Dict[str, float]:
    out = {"tables_time": 0.0, "tables_count": 0.0, "tables_ws": 0.0}
    seen = False
    for got, want in pairs:
        seen = True
        n, m = int(want["n_jobs"]), int(got["n_jobs"])
        count = abs(n - m)
        k = min(n, m)
        gs, ws = np.asarray(got["submit"][:k], np.float64), \
            np.asarray(want["submit"][:k], np.float64)
        time_gap = float(np.max(np.abs(gs - ws) / np.maximum(np.abs(ws), 1.0),
                                initial=0.0))
        og = np.lexsort((got["runtime"][:k], got["size"][:k]))
        ow = np.lexsort((want["runtime"][:k], want["size"][:k]))
        count += int(np.sum(got["size"][:k][og] != want["size"][:k][ow]))
        gr = np.asarray(got["runtime"][:k][og], np.float64)
        wr = np.asarray(want["runtime"][:k][ow], np.float64)
        time_gap = max(time_gap, float(np.max(np.abs(gr - wr) / wr,
                                              initial=0.0)))
        if not (np.all(np.isinf(got["submit"][m:]))
                and np.all(got["size"][m:] == 0)):
            count += 1
        if not np.isfinite(time_gap):
            time_gap = float("inf")
        ws_share = float(np.mean(np.asarray(got["ws_values"])
                                 != np.asarray(want["ws_values"])))
        out["tables_time"] = max(out["tables_time"], time_gap)
        out["tables_count"] = max(out["tables_count"], float(count))
        out["tables_ws"] = max(out["tables_ws"], ws_share)
    return out if seen else {}
