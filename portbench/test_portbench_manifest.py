"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by name. The entries of parked cells (``parked.json``) are
held to the same form, and none of those cells is in BENCHMARK.json."""

import json
import re

import pytest

from portbench.harness import manifest

MAN = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = manifest.cell_names(MAN)
# With the parked cells and their metrics (``harness/manifest.py``).
WITH = manifest.with_parked(MAN)
ALL_CELLS = manifest.cell_names(WITH)
METRICS = WITH["end_to_end"] + WITH["per_layer"]


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entry(metric):
    assert NAME.match(metric["name"])
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in WITH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        limit = 0.25
        assert 0.01 <= metric["bound"] <= limit
    else:
        assert set(metric) == {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
        moved = {m["name"]: m for m in WITH["end_to_end"]}[metric["moves"]]
        for cell in metric["workloads"]:
            assert cell in moved.get("workloads", ALL_CELLS)
    for cell in metric.get("workloads", []):
        assert cell in ALL_CELLS
    reader = manifest.HERE / "metrics" / f"{metric['name']}.py"
    assert callable(manifest.metric_readers([metric])[metric["name"]].read), reader
    if "roofline" in metric["name"]:
        assert metric["unit"] == "%"


def test_names_are_unique_and_setup_bound():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    setup = {m["name"]: m for m in MAN["end_to_end"]}["setup_s"]
    assert setup["bound"] <= 0.25 and "workloads" not in setup


def test_four_chip_cells_are_few():
    four = [w["name"] for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4), four


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_cell_files_found_by_name(cell):
    entry = {w["name"]: w for w in WITH["workloads"]}[cell]
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["traffic"]) and entry["chips"] in (1, 4)
    assert 1 <= len(entry["why"]) <= 200
    c = manifest.Cell(WITH, cell)
    assert hasattr(c.driver_module(), "Driver")
    assert set(c.traffic["compared"]) <= set(c.traffic["limits"])
    reported = [m["name"] for m in c.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    assert (entry["config"], entry["traffic"]) not in [
        (w["config"], w["traffic"]) for w in WITH["workloads"]
        if w["name"] != cell]


@pytest.mark.parametrize("config", MAN["configs"],
                         ids=[c["name"] for c in MAN["configs"]])
def test_config_entry(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"]) and len(config["source"]) <= 200
    assert config["file"].startswith("portbench/")
    body = json.loads((manifest.ROOT / config["file"]).read_text())
    reduced = config["reduced"]
    assert isinstance(reduced, list) and len(reduced) <= 16
    assert len(set(reduced)) == len(reduced)
    for key in reduced:
        # A cut of scale, changed in the file or left out of it; never a
        # width.
        assert isinstance(key, str) and NAME.match(key), key
        assert not key.endswith(("_dim", "_rank")), key
    assert body["name"] == config["name"] and body["source"] == config["source"]
    assert any(w["config"] == config["name"] for w in MAN["workloads"])


def test_parked_cells_are_whole_and_out_of_the_manifest():
    parked = json.loads(manifest.PARKED.read_text())
    assert set(parked) == {"why", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(parked["why"]) and "\n" not in parked["why"]
    names = [w["name"] for w in parked["workloads"]]
    assert names and not set(names) & set(CELLS)
    configs = {c["name"] for c in MAN["configs"]}
    assert all(w["config"] in configs for w in parked["workloads"])
    for m in parked["end_to_end"] + parked["per_layer"]:
        assert m.get("workloads") and set(m["workloads"]) <= set(names), m
    live = {m["name"] for m in MAN["per_layer"]}
    assert not {m["name"] for m in parked["per_layer"]} & live


def test_files_under_paths_are_named_from_name_characters():
    root = manifest.HERE
    for f in root.rglob("*"):
        if "__pycache__" in f.parts or not f.is_file():
            continue
        rel = f.relative_to(root.parent).as_posix()
        assert PATH.match(rel), rel
