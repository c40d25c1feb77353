"""The port's span recorder (``repro_torch.spans``) on the generated
sweep's path, on the CPU.

* Without a profiler nothing is recorded; under ``torch.profiler`` one
  sweep records its span tree: every span's parent and root, each child
  inside its parent, ``rounds.steps`` carrying the host loop's outer
  steps (read from a 0-d tensor only when the spans are read).
* The rows are the same bit for bit with the profiler on and off, and
  no profiler event bears a span's name (the spans are not profiler
  ranges).
* The buffer keeps the newest spans and counts the dropped ones; self
  time (``portbench.harness.program_spans.self_ns``) is a span's
  duration less what its children cover.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.harness import program_spans
from repro_torch import spans
from repro_torch.kernels import round_step as rsk
from repro_torch.sim import scenarios as sc
from repro_torch.sim.sweep import SweepPoint, run_sweep_workloads

DAY = 86400.0
GRID = sc.ScenarioGrid(seeds=(11, 12, 13, 14),
                       pbj=sc.PBJParams(nodes=64.0, n_jobs=40.0),
                       duration=DAY, max_jobs=80)
POINTS = [SweepPoint("fb", capacity=64), SweepPoint("fb", capacity=96)]

# (name, parent's name), in the order the spans end.
TREE = [("scenarios.draws", "scenarios.synthesize"),
        ("scenarios.transforms", "scenarios.synthesize"),
        ("scenarios.synthesize", "sweep"),
        ("rounds.fold_tables", "sweep.pack"),
        ("rounds.to_device", "sweep.pack"),
        ("sweep.pack", "sweep"),
        ("rounds.startup", "sweep"),
        ("rounds.steps", "sweep"),
        ("sweep.wait", "sweep.rows"),
        ("sweep.rows", "sweep"),
        ("sweep", None)]


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.clear()
    yield
    spans.clear()


def sweep():
    return run_sweep_workloads(POINTS, GRID, mode="rounds", device="cpu")


@pytest.fixture(scope="module")
def traced():
    """One sweep without a profiler and one under it: ``(rows off, rows
    on, spans, profiler event names, host-loop steps)``."""
    spans.clear()
    off = sweep()
    assert spans.recorded() == []
    steps = []
    step = rsk.chunk_step_ref

    def counted(*args, **kwargs):
        steps.append(1)
        return step(*args, **kwargs)

    rsk.chunk_step_ref = counted
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = sweep()
    finally:
        rsk.chunk_step_ref = step
    rec = spans.recorded()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    return off, on, rec, names, len(steps)


def test_no_profiler_records_nothing():
    sweep()
    assert spans.recorded() == [] and spans.dropped() == 0


def test_profiled_sweep_records_the_span_tree(traced):
    _, _, rec, _, n_steps = traced
    by_id = {s["id"]: s for s in rec}
    got = [(s["name"], by_id[s["parent"]]["name"]
            if s["parent"] is not None else None) for s in rec]
    assert got == TREE
    root = rec[-1]
    assert root["attrs"] == {"mode": "rounds", "lanes": 8}
    assert all(s["root"] == root["id"] for s in rec)
    for s in rec:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
    attrs = {s["name"]: s["attrs"] for s in rec}
    # The host loop runs as many iterations as its busiest lane's steps:
    # a lane that stops stays stopped.
    assert attrs["rounds.steps"] == {"lanes": 8, "outer_steps": n_steps}
    assert type(attrs["rounds.steps"]["outer_steps"]) is int
    assert attrs["scenarios.synthesize"] == {"lanes": 4}
    assert attrs["sweep.pack"] == {"policy": "fb"}
    assert attrs["rounds.fold_tables"] == {"lanes": 4, "points": 2}
    assert attrs["rounds.to_device"]["bytes"] > 0
    assert attrs["sweep.rows"] == {"rows": 8}


def test_rows_are_the_same_with_the_profiler_on_and_off(traced):
    off, on, _, _, _ = traced
    assert on == off


def test_no_profiler_event_bears_a_span_name(traced):
    _, _, rec, names, _ = traced
    assert {s["name"] for s in rec} & names == set()


def test_buffer_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(spans, "_done", collections.deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with spans.span("s", i=i, at=torch.tensor(i)):
                pass
    assert [s["attrs"] for s in spans.recorded()] == [
        {"i": i, "at": i} for i in (2, 3, 4)]
    assert spans.dropped() == 2
    spans.clear()
    assert spans.recorded() == [] and spans.dropped() == 0


def test_self_time_is_the_duration_less_the_children(traced):
    _, _, rec, _, _ = traced
    by_name = {s["name"]: s for s in rec}
    dur = lambda s: s["end_ns"] - s["start_ns"]
    rows, wait = by_name["sweep.rows"], by_name["sweep.wait"]
    assert program_spans.self_ns(rows, rec, "sweep.wait") \
        == dur(rows) - dur(wait)
    root = by_name["sweep"]
    kids = [s for s in rec if s["parent"] == root["id"]]
    assert len(kids) == 5
    assert program_spans.self_ns(root, rec) == dur(root) - sum(
        dur(s) for s in kids)
    # Overlapping children count once; a part outside the span not at all.
    made = [dict(id=1, parent=None, start_ns=0, end_ns=100),
            dict(id=2, parent=1, start_ns=10, end_ns=40),
            dict(id=3, parent=1, start_ns=30, end_ns=50),
            dict(id=4, parent=1, start_ns=90, end_ns=130)]
    assert program_spans.self_ns(made[0], made) == 100 - 40 - 10
