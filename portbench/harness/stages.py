"""The wall split: each stage of the program timed on the host clock,
with a synchronize on both sides, and marked in a profiler trace.

A stage is a module function (``module.name``) that the program calls
through its module, so replacing the attribute for the traced run puts
the wrapper in the call path. The synchronizes take away any overlap of
host and device inside a query; in these cells the host waits for the
device at the end of each stage anyway (rows are read back), so the
traced run's query wall stays close to the untraced one's. Only the
traced run installs it; the timed run calls the program untouched."""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import torch

ANNOTATION = "portbench."


class StageClock:
    """Times ``stages``, a sequence of ``(stage, module, name)``; several
    functions may share one stage name. ``spent[stage]`` sums seconds,
    ``calls[stage]`` counts calls."""

    def __init__(self, stages: Sequence[Tuple[str, object, str]],
                 sync: bool = True):
        self.stages = list(stages)
        self.sync = sync and torch.cuda.is_available()
        self.spent: Dict[str, float] = {s: 0.0 for s, _, _ in stages}
        self.calls: Dict[str, int] = {s: 0 for s, _, _ in stages}
        self._saved: List[Tuple[object, str, object]] = []

    def _wrap(self, stage, orig):
        from torch.profiler import record_function
        clock = self

        def timed(*args, **kwargs):
            with record_function(ANNOTATION + stage):
                if clock.sync:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                if clock.sync:
                    torch.cuda.synchronize()
                clock.spent[stage] += time.perf_counter() - t0
                clock.calls[stage] += 1
            return out

        # A kernel wrapper counts launches into the attribute its module
        # name holds (``run_rounds.launches``): carry it over.
        if hasattr(orig, "launches"):
            timed.launches = orig.launches
        return timed

    def __enter__(self):
        for stage, module, name in self.stages:
            orig = getattr(module, name)
            self._saved.append((module, name, orig))
            setattr(module, name, self._wrap(stage, orig))
        return self

    def __exit__(self, *exc):
        for module, name, orig in reversed(self._saved):
            if hasattr(orig, "launches"):
                orig.launches = getattr(module, name).launches
            setattr(module, name, orig)
        self._saved.clear()
        return False
