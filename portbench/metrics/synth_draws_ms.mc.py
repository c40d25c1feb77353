"""sim/scenarios.py synthesize, the lanes' CPU generator draws (span ``scenarios.draws``): ms a query."""

from portbench.harness import program_spans


def read(run):
    return program_spans.stage_ms(run, "scenarios.draws")
