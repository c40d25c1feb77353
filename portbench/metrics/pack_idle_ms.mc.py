"""The device's idle time inside the sweep's pack (spans ``sweep.pack`` less the device trace's busy intervals), ms a query."""

from portbench.harness import program_spans as ps


def read(run):
    dt = getattr(run, "device_trace", None)
    packs = ps.named(ps.window_spans(run), "sweep.pack")
    if dt is None or not packs:
        return None
    return ps.ms_per_query(run, ps.idle_ns(packs, dt.busy))
