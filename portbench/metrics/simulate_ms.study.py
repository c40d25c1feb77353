"""core/jaxsim.py simulate, its kernel launches with a synchronize on
both sides of each: ms a query (wall split)."""

from portbench.harness import readers


def read(run):
    return readers.stage_ms(run, "simulate")
