"""The round step's least time (harness.workcount, H100 peaks) as a share of its device time, in %."""

from portbench.harness import readers


def read(run):
    return readers.round_step_roofline(run)
