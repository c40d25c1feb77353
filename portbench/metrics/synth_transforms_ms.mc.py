"""sim/scenarios.py synthesize, the stack, the copy to the device, the transforms and the copy back (span ``scenarios.transforms``): ms a query."""

from portbench.harness import program_spans


def read(run):
    return program_spans.stage_ms(run, "scenarios.transforms")
