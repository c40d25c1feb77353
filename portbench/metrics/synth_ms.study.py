"""sim/scenarios.py synthesize: ms a query (wall split)."""

from portbench.harness import readers


def read(run):
    return readers.stage_ms(run, "synth")
