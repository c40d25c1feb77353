"""The check must fail the controls and every fault a cell can have.

The controls are one precision below what the configuration states: the
plain reference in the program's place with its lanes synthesized in
bfloat16, and the program with its float32 pack. The faults are
planted in the program underneath a CPU run: a round step that returns
its state unchanged, half of a query's lanes left out (their rows copied
from the other half), and an answer altered where it is produced."""

import pytest
import torch

from portbench import control
from portbench.harness import manifest
from portbench.smallcell import run_small, small_cell

CELLS = manifest.cell_names(manifest.load_manifest())


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    checks = control.control_checks(small_cell(name), 2 ** 31 + 3, 2)
    assert not all(c["ok"] for c in checks), checks


@pytest.mark.parametrize("name", CELLS)
def test_program_control_fails(name):
    checks = control.program_control_checks(small_cell(name), 2 ** 31 + 5,
                                            0.0, device="cpu")
    assert not all(c["ok"] for c in checks), checks


def _step_unchanged(monkeypatch):
    from repro_torch.kernels import round_step as rsk
    monkeypatch.setattr(rsk, "chunk_step_ref",
                        lambda jobs, rises, wstab, prm, sc, win, **kw:
                        (sc.clone(), win.clone()))


def _half_left_out(monkeypatch):
    from repro_torch.sim import rounds
    orig = rounds._simulate_rounds

    def half(policy, prm, pk, spec):
        out = orig(policy, prm, pk, spec)
        n = next(iter(out.values())).shape[0]
        keep = torch.arange(n) % max(n // 2, 1)
        return {k: v[keep] for k, v in out.items()}

    monkeypatch.setattr(rounds, "_simulate_rounds", half)


def _answer_altered(monkeypatch):
    from repro_torch.sim import rounds
    orig = rounds._simulate_rounds

    def altered(policy, prm, pk, spec):
        out = dict(orig(policy, prm, pk, spec))
        out["completed_jobs"] = out["completed_jobs"] + 1
        return out

    monkeypatch.setattr(rounds, "_simulate_rounds", altered)


def _table_altered(monkeypatch):
    from repro_torch.sim import scenarios
    orig = scenarios._pbj_from_draws

    def altered(*args, **kwargs):
        submit, size, runtime, n = orig(*args, **kwargs)
        return submit, size, runtime * 1.001, n

    monkeypatch.setattr(scenarios, "_pbj_from_draws", altered)


FAULTS = {"step_unchanged": _step_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered,
          "table_altered": _table_altered}


CASES = [(name, fault) for name in CELLS for fault in sorted(FAULTS)]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_caught(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, checks = run_small(small_cell(name, days=1.0))
    assert result["correct"] is False, checks
