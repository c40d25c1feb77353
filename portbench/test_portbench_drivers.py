"""Every driver kind a cell uses brings what its checks need, as files
found by name: ``faults/<kind>.py`` with at least the faults every cell
can have, and in ``drivers/<kind>.py`` the ``Driver``, the precision
control ``lower`` and the CPU tests' cut ``small``. A kind that lacks one
is refused here, by name, and not by an error deep in a run. The kinds
of parked cells (``harness/manifest.py``) are held to the same."""

import copy
import inspect

import pytest

from portbench.harness import manifest

MAN = manifest.with_parked(manifest.load_manifest())
CELLS = manifest.cell_names(MAN)


def _kinds():
    """Each driver kind the cells use, with its cells' chip counts."""
    kinds = {}
    for name in CELLS:
        cell = manifest.Cell(MAN, name)
        kinds.setdefault(cell.kind, set()).add(cell.chips)
    return kinds


KINDS = _kinds()

# The engine's step left unchanged, lanes left out, an answer altered
# where it is produced; on four chips also the exchange between chips.
EVERY_CELL = {"step_unchanged", "half_left_out", "answer_altered"}
FOUR_CHIPS = {"exchange_left_out"}
# What ``run.py`` and ``control.py`` call on a driver.
DRIVER_METHODS = ("make", "query", "before", "keep", "lanes", "failed",
                  "work", "stages", "check", "control", "__enter__",
                  "__exit__")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_driver_kind_plants_its_faults(kind):
    path = manifest.HERE / "faults" / f"{kind}.py"
    assert path.is_file(), f"faults/{kind}.py is missing"
    faults = getattr(manifest.faults(kind), "FAULTS", None)
    assert isinstance(faults, dict), f"faults/{kind}.py defines no FAULTS"
    need = EVERY_CELL | (FOUR_CHIPS if 4 in KINDS[kind] else set())
    missing = sorted(need - set(faults))
    assert not missing, f"faults/{kind}.py plants no {missing}"
    assert all(callable(f) for f in faults.values()), faults


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_driver_kind_defines_its_functions(kind):
    drv = manifest.driver(kind)
    missing = [f for f in ("Driver", "lower", "small")
               if not callable(getattr(drv, f, None))]
    assert not missing, f"drivers/{kind}.py defines no {missing}"
    inspect.signature(drv.lower).bind({}, {})
    inspect.signature(drv.small).bind({}, {}, 1.0, 1, 1)
    missing = [m for m in DRIVER_METHODS if not hasattr(drv.Driver, m)]
    assert not missing, f"drivers/{kind}.py's Driver has no {missing}"


@pytest.mark.parametrize("name", CELLS)
def test_lower_and_small_return_new_pairs(name):
    cell = manifest.Cell(MAN, name)
    drv = cell.driver_module()
    pair = (copy.deepcopy(cell.config), copy.deepcopy(cell.traffic))
    lowered = drv.lower(cell.config, cell.traffic)
    cut = drv.small(cell.config, cell.traffic, 1.0, 2, 2)
    assert (cell.config, cell.traffic) == pair, "an argument was changed"
    assert len(lowered) == 2 and tuple(lowered) != pair
    assert len(cut) == 2 and tuple(cut) != pair
