"""The check must fail the controls and every fault a cell can have.

The controls are one precision below what the configuration states: the
plain reference in the program's place (the driver's ``Driver.control``)
and the program run as the driver's ``lower`` says. The faults are
planted in the program underneath a CPU run, each driver kind's from its
``faults/<kind>.py`` (``mc_grid``: a round step that returns its state
unchanged, half of a query's lanes left out, an answer altered where it
is produced, a synthesized table altered; ``tick_study`` likewise, with
a substep that starts nothing for the step). A parked cell
(``harness/manifest.py``) is held to them too."""

import pytest

from portbench import control
from portbench.harness import manifest
from portbench.smallcell import run_small, small_cell

MAN = manifest.with_parked(manifest.load_manifest())
CELLS = manifest.cell_names(MAN)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    checks = control.control_checks(small_cell(name), 2 ** 31 + 3, 2)
    assert not all(c["ok"] for c in checks), checks


@pytest.mark.parametrize("name", CELLS)
def test_program_control_fails(name):
    checks = control.program_control_checks(small_cell(name), 2 ** 31 + 5,
                                            0.0, device="cpu")
    assert not all(c["ok"] for c in checks), checks


def _faults(name):
    """The cell's driver kind's faults; none where its faults file is
    missing, which ``test_portbench_drivers.py`` refuses by name."""
    kind = manifest.Cell(MAN, name).kind
    try:
        return manifest.faults(kind).FAULTS
    except FileNotFoundError:
        return {}


FAULTS = {name: _faults(name) for name in CELLS}
CASES = [(name, fault) for name in CELLS for fault in sorted(FAULTS[name])]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_caught(name, fault, monkeypatch):
    FAULTS[name][fault](monkeypatch)
    result, checks = run_small(small_cell(name, days=1.0))
    assert result["correct"] is False, checks
