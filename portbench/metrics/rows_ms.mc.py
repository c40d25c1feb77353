"""sim/sweep.py row assembly: the self time of ``sweep.rows`` (its duration less its ``sweep.wait`` children, where the host waits for the device), ms a query."""

from portbench.harness import program_spans as ps


def read(run):
    spans = ps.window_spans(run)
    rows = ps.named(spans, "sweep.rows")
    if not rows:
        return None
    return ps.ms_per_query(
        run, sum(ps.self_ns(s, spans, "sweep.wait") for s in rows))
