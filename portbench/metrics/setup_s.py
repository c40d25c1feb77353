"""Process start to the first timed query: imports, the round-step
kernel's build on a checkout's first run, and the warm-up query."""


def read(run):
    return run.setup_s
