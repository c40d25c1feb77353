"""sim/rounds.py _to_pack, the pack's host arrays copied to the device, inside the sweep's pack (spans ``rounds.to_device`` under ``sweep.pack``): ms a query."""

from portbench.harness import program_spans


def read(run):
    return program_spans.stage_ms(run, "rounds.to_device", "sweep.pack")
