"""The round step's device time (profiler) over the outer steps of its launches (the busiest lane's count of each, span ``rounds.steps``), in us."""

from portbench.harness import program_spans as ps
from portbench.harness import readers


def read(run):
    ks = readers.kernel_s(run)
    steps = sum(s["attrs"].get("outer_steps") or 0
                for s in ps.named(ps.window_spans(run), "rounds.steps"))
    if not ks or not steps:
        return None
    return 1e6 * ks / steps
