"""sim/rounds.py ws_fold_tables_batch inside the sweep's pack (spans ``rounds.fold_tables`` under ``sweep.pack``): ms a query."""

from portbench.harness import program_spans


def read(run):
    return program_spans.stage_ms(run, "rounds.fold_tables", "sweep.pack")
