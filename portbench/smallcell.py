"""A cell cut to a size the CPU tests can run: a short horizon with the
job count cut in proportion, a few lanes and points a query. Only the
tests use it; the benchmark runs every cell as its files state."""

from __future__ import annotations

import importlib.util
from pathlib import Path

from portbench.harness import manifest

DAY = 86400.0


def small_cell(name: str, days: float = 2.0, lanes: int = 3,
               points: int = 3) -> manifest.Cell:
    cell = manifest.Cell(manifest.load_manifest(), name)
    cfg, traffic = cell.config, cell.traffic
    scale = days * DAY / cfg["horizon_s"]
    cfg["horizon_s"] = days * DAY
    cfg["pbj"]["n_jobs"] = round(cfg["pbj"]["n_jobs"] * scale)
    traffic["seeds_per_query"] = lanes
    traffic["max_jobs"] = cfg["pbj"]["n_jobs"] + 8
    pts = traffic["points"]
    traffic["points"] = [pts[0], pts[len(pts) // 2], pts[-1]][:points]
    traffic["check"] = {"rows_per_query": 3, "workers": 1}
    return cell


def run_module():
    """``portbench/run.py`` as a module (it is a script, not part of the
    package)."""
    path = Path(__file__).resolve().parent / "run.py"
    spec = importlib.util.spec_from_file_location("portbench_run", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_small(cell, seed: int = 2 ** 31 + 11, trace: bool = False):
    """One CPU run of ``cell`` whose window holds one query:
    ``(result, checks)``."""
    import time
    result, checks, _ = run_module().run_cell(
        cell, seed, 0.0, trace, device="cpu", t_start=time.perf_counter())
    return result, checks
