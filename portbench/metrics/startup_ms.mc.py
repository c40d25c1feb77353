"""sim/rounds.py _lane_ctx, _startup and round_step.lane_inputs: ms a query (wall split)."""

from portbench.harness import readers


def read(run):
    return readers.stage_ms(run, "startup")
