"""The round step's device time (profiler) over the lanes the window ran, in us."""

from portbench.harness import readers


def read(run):
    return readers.round_step_us_per_lane(run)
