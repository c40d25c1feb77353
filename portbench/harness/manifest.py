"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names its configuration and its
traffic. Its files are found by name alone:

* the configuration: the ``file`` of its entry in ``configs``;
* the traffic: ``workloads/<cell>.json``, which names its driver kind;
* the driver: ``drivers/<kind>.py``, which defines ``Driver``, the
  precision control ``lower`` and the CPU tests' cut ``small``;
* the driver kind's planted faults: ``faults/<kind>.py``, which defines
  ``FAULTS``;
* each per-layer metric: ``metrics/<metric>.py``, which defines ``read``.

So a later cell, configuration, driver kind or metric is new files and
a new entry, and no existing file changes.

A cell that the program fails, and that ``BENCHMARK.json`` therefore
leaves out, is parked whole in ``parked.json``: its ``workloads`` entry
and its metrics' entries, as they stood. ``with_parked`` adds them back
for the CPU tests, so its files stay tested and the cell can return as
entries alone; the benchmark's own runs never see it."""

from __future__ import annotations

import copy
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]        # portbench/
ROOT = HERE.parent                                # the checkout
MANIFEST = ROOT / "BENCHMARK.json"
PARKED = HERE / "parked.json"


def load_manifest(path: Path = MANIFEST) -> Dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def with_parked(manifest: Dict, path: Path = PARKED) -> Dict:
    """``manifest`` with the parked cells of ``path`` and their metrics
    added: a metric the manifest has already gains the parked cells in
    its ``workloads``; a cell the manifest has already is left as it is
    there."""
    out = copy.deepcopy(manifest)
    if not path.is_file():
        return out
    parked = json.loads(path.read_text())
    have = set(cell_names(out))
    out["workloads"] += [w for w in parked["workloads"]
                         if w["name"] not in have]
    for key in ("end_to_end", "per_layer"):
        live = {m["name"]: m for m in out[key]}
        for m in parked[key]:
            if m["name"] not in live:
                out[key].append(copy.deepcopy(m))
            elif "workloads" in live[m["name"]]:
                cells = live[m["name"]]["workloads"]
                cells += [c for c in m.get("workloads", []) if c not in cells]
    return out


def _load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of ``workloads`` with everything found for it."""

    def __init__(self, manifest: Dict, name: str):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads(
            (ROOT / self.config_entry["file"]).read_text())
        self.traffic = json.loads(
            (HERE / "workloads" / f"{name}.json").read_text())
        if self.traffic.get("traffic") != self.entry["traffic"]:
            raise ValueError(f"workloads/{name}.json is traffic "
                             f"{self.traffic.get('traffic')!r}, the "
                             f"manifest says {self.entry['traffic']!r}")
        self.kind = self.traffic["driver"]
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]

    def driver_module(self) -> ModuleType:
        return driver(self.kind)


def driver(kind: str) -> ModuleType:
    """``drivers/<kind>.py``: ``Driver``, ``lower`` and ``small``."""
    return _load_module(HERE / "drivers" / f"{kind}.py",
                        f"portbench_driver_{kind}")


def faults(kind: str) -> ModuleType:
    """``faults/<kind>.py``: ``FAULTS``, each fault's name to its
    ``patch(monkeypatch)``."""
    return _load_module(HERE / "faults" / f"{kind}.py",
                        f"portbench_faults_{kind}")


def cell_names(manifest: Dict) -> List[str]:
    return [w["name"] for w in manifest["workloads"]]


def metric_readers(entries: List[Dict]) -> Dict[str, ModuleType]:
    """The reader ``metrics/<name>.py`` of each metric entry."""
    return {m["name"]: _load_module(
        HERE / "metrics" / f"{m['name']}.py",
        "portbench_metric_" + m["name"].replace(".", "_"))
        for m in entries}
