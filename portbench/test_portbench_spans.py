"""The readers of the program's spans (``harness/program_spans.py`` and
the seven ``metrics/*.py`` that use it) on hand-made spans and a
hand-made window record: ms a query, self time, the window's clipping,
the device's idle time inside the pack spans, None where there is
nothing to read. On the card: the spans share the device trace's clock,
each ``sweep.pack`` span inside its stage's ``portbench.pack``
annotation."""

import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

import repro_torch
from portbench.harness import manifest, program_spans
from portbench.smallcell import run_module, small_cell
from repro_torch import spans as recorder

MS = 1_000_000
NEW = ["synth_draws_ms.mc", "synth_transforms_ms.mc", "pack_fold_ms.mc",
       "pack_to_device_ms.mc", "rows_ms.mc", "pack_idle_ms.mc",
       "round_step_us_per_outer_step.mc"]
READERS = manifest.metric_readers(
    [m for m in manifest.with_parked(manifest.load_manifest())["per_layer"]
     if m["name"] in NEW])


def made(i, name, parent, start, end, **attrs):
    return dict(id=i, name=name, parent=parent, root=None,
                start_ns=start * MS, end_ns=end * MS, attrs=attrs)


# Two queries in a window [1, 100] ms, and two spans across its edges.
SPANS = [
    made(3, "scenarios.draws", 2, 2, 6),
    made(4, "scenarios.transforms", 2, 6, 9),
    made(2, "scenarios.synthesize", 1, 2, 10),
    made(6, "rounds.fold_tables", 5, 10, 17),
    made(7, "rounds.to_device", 5, 17, 19),
    made(5, "sweep.pack", 1, 10, 20, policy="fb"),
    made(8, "rounds.steps", 1, 20, 30, outer_steps=800),
    made(10, "sweep.wait", 9, 30, 33),
    made(9, "sweep.rows", 1, 30, 38),
    made(1, "sweep", None, 2, 40),
    made(12, "scenarios.draws", 11, 50, 56),
    made(14, "rounds.fold_tables", 13, 60, 65),
    made(13, "sweep.pack", 11, 60, 70, policy="fb"),
    made(15, "rounds.to_device", 11, 70, 71),     # not under a pack
    made(16, "rounds.steps", 11, 71, 80, outer_steps=200),
    made(17, "sweep.rows", 11, 80, 84),
    made(11, "sweep", None, 50, 90),
    made(18, "scenarios.draws", None, 0.5, 1.5),  # across the start
    made(19, "sweep.pack", None, 95, 105),        # across the end
]
BUSY = np.array([[12, 15], [18, 25], [40, 62], [69, 69.5]]) * MS
WANT = {
    "synth_draws_ms.mc": (4 + 6) / 2,
    "synth_transforms_ms.mc": 3 / 2,
    "pack_fold_ms.mc": (7 + 5) / 2,
    "pack_to_device_ms.mc": 2 / 2,
    "rows_ms.mc": ((8 - 3) + 4) / 2,
    # [10, 20] less 3 + 2 busy, [60, 70] less 2 + 0.5 busy.
    "pack_idle_ms.mc": (5 + 7.5) / 2,
    # 0.5 s of the kernel over 800 + 200 outer steps, in us.
    "round_step_us_per_outer_step.mc": 0.5e6 / 1000,
}


def window(device_trace=True):
    dt = SimpleNamespace(
        busy=BUSY.astype(np.int64),
        kernel_seconds=lambda part: 0.5 if part == "run_kernel" else None)
    return SimpleNamespace(t0_ns=1 * MS, t1_ns=100 * MS, queries=2,
                           device_trace=dt if device_trace else None)


@pytest.mark.parametrize("name", NEW)
def test_reader_on_hand_made_spans(monkeypatch, name):
    monkeypatch.setattr(recorder, "recorded", lambda: SPANS)
    assert READERS[name].read(window()) == pytest.approx(WANT[name],
                                                         rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_none_without_spans(monkeypatch, name):
    monkeypatch.setattr(recorder, "recorded", lambda: [])
    assert READERS[name].read(window()) is None


def test_readers_read_none_where_the_program_has_no_recorder(
        monkeypatch, tmp_path):
    """A program without ``spans.py`` (the recorder's parent commit): its
    metrics are left out, no error."""
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.delitem(sys.modules, "repro_torch.spans")
    monkeypatch.setattr(repro_torch, "__path__", [str(tmp_path)])
    assert program_spans.window_spans(window()) == []
    assert all(READERS[n].read(window()) is None for n in NEW)


def test_device_metrics_need_the_device_trace(monkeypatch):
    monkeypatch.setattr(recorder, "recorded", lambda: SPANS)
    run = window(device_trace=False)
    assert READERS["pack_idle_ms.mc"].read(run) is None
    assert READERS["round_step_us_per_outer_step.mc"].read(run) is None
    assert READERS["pack_fold_ms.mc"].read(run) == WANT["pack_fold_ms.mc"]


def test_idle_is_the_union_of_the_spans_less_the_busy_time():
    two = [made(1, "a", None, 0, 10), made(2, "b", None, 5, 20)]
    assert program_spans.idle_ns(two, np.zeros((0, 2))) == 20 * MS
    busy = np.array([[-5, 1], [3, 4], [19, 30]]) * MS
    assert program_spans.idle_ns(two, busy) == (20 - 1 - 1 - 1) * MS


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_pack_spans_lie_inside_the_pack_annotations_on_the_card(card):
    """The spans' clock (``time.time_ns``) is the device trace's: every
    ``sweep.pack`` span lies inside its query's ``portbench.pack``
    annotation, as the kineto events give it, within 0.2 ms at each
    end; no span's name reaches the device's line."""
    cell = small_cell("ipsc_wc98.mc_fb", lanes=8)
    result, _, run = run_module().run_cell(
        cell, 2 ** 31 + 5, 2.0, True, device="cuda",
        t_start=time.perf_counter())
    found = program_spans.window_spans(run)
    packs = sorted((s["start_ns"], s["end_ns"]) for s in found
                   if s["name"] == "sweep.pack")
    notes = sorted((s, e) for k, s, e in run.device_trace._notes
                   if k == "pack")
    assert len(packs) == len(notes) == run.queries
    tol = 0.2 * MS
    for (s, e), (ns, ne) in zip(packs, notes):
        assert ns - tol <= s <= e <= ne + tol, (s - ns, ne - e)
    names = {s["name"] for s in found}
    shown = {n for part in result["breakdown"].values() for n, _ in part}
    assert names and not names & shown
    assert set(NEW) <= set(result["metrics"])
