"""A cell cut to a size the CPU tests can run, by its driver kind's
``small`` (for ``mc_grid``: a short horizon with the job count cut in
proportion, a few lanes and points a query). Only the tests use it; the
benchmark runs every cell as its files state. A parked cell
(``harness/manifest.py``) is found too."""

from __future__ import annotations

import importlib.util
from pathlib import Path

from portbench.harness import manifest


def small_cell(name: str, days: float = 2.0, lanes: int = 3,
               points: int = 3) -> manifest.Cell:
    cell = manifest.Cell(manifest.with_parked(manifest.load_manifest()),
                         name)
    cell.config, cell.traffic = cell.driver_module().small(
        cell.config, cell.traffic, days, lanes, points)
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
