"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names its configuration and its
traffic. Its files are found by name alone:

* the configuration: the ``file`` of its entry in ``configs``;
* the traffic: ``workloads/<cell>.json``, which names its driver kind;
* the driver: ``drivers/<kind>.py``, which defines ``Driver``;
* each per-layer metric: ``metrics/<metric>.py``, which defines ``read``.

So a later cell, configuration or metric is new files and a new entry,
and no existing file changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]        # portbench/
ROOT = HERE.parent                                # the checkout
MANIFEST = ROOT / "BENCHMARK.json"


def load_manifest(path: Path = MANIFEST) -> Dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


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
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]

    def driver_module(self) -> ModuleType:
        kind = self.traffic["driver"]
        return _load_module(HERE / "drivers" / f"{kind}.py",
                            f"portbench_driver_{kind}")


def cell_names(manifest: Dict) -> List[str]:
    return [w["name"] for w in manifest["workloads"]]


def metric_readers(entries: List[Dict]) -> Dict[str, ModuleType]:
    """The reader ``metrics/<name>.py`` of each metric entry."""
    return {m["name"]: _load_module(
        HERE / "metrics" / f"{m['name']}.py",
        "portbench_metric_" + m["name"].replace(".", "_"))
        for m in entries}
