"""sim/sweep.py _pack_scenarios_grids: ms a query (wall split)."""

from portbench.harness import readers


def read(run):
    return readers.stage_ms(run, "pack")
