"""Lanes simulated over the whole horizon per second of the window: the
lanes of every query the window ran, over the window's seconds."""


def read(run):
    return run.lanes / run.window_s if run.window_s > 0 else None
