"""Host spans of the program's stages, recorded while a profiler runs.

``span(name, **attrs)`` marks one stage: its name, an id, the id of the
span that encloses it (its parent) and of the outermost one (its root,
the request: every span of one ``run_sweep_workloads`` call shares it),
its start and end on ``time.time_ns()``'s clock, which the profiler's
device events share, and ``attrs``. An attr may be a 0-d tensor on the
card; it becomes a number only when :func:`recorded` reads it, so
recording never waits for the device.

The switch is the profiler: spans record only while a
``torch.profiler`` profile is active. Otherwise ``span`` returns one
shared context that does nothing, and costs one flag check.

Spans stay in memory and are never profiler ranges: on a CUDA trace a
``record_function`` range is mirrored onto the device's line, where it
would read as device activity. The buffer keeps the newest
``MAX_SPANS`` spans and counts the ones it dropped (:func:`dropped`).
Spans nest per thread: one opened on a worker thread starts a tree of
its own.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List

import torch

__all__ = ["span", "recorded", "dropped", "clear", "MAX_SPANS"]

MAX_SPANS = 100_000

_lock = threading.Lock()
_done: collections.deque = collections.deque(maxlen=MAX_SPANS)
_dropped = 0
_ids = itertools.count(1)
_open = threading.local()      # .stack: this thread's open spans


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns",
                 "end_ns")

    def __init__(self, name: str, attrs: Dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Attrs known only once the stage has run."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[-1].root if stack else self.id
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        self.end_ns = time.time_ns()
        _open.stack.pop()
        with _lock:
            _dropped += len(_done) == _done.maxlen
            _done.append(self)
        return False


class _Off:
    """The context ``span`` returns while no profiler runs."""

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def span(name: str, **attrs):
    """A context that records the stage ``name`` while a profiler runs;
    ``with span(...) as s: ... s.set(k=v)`` adds attrs at the end."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, attrs)


def recorded() -> List[Dict]:
    """The spans recorded so far, oldest first, as dicts (``name``,
    ``id``, ``parent``, ``root``, ``start_ns``, ``end_ns``, ``attrs``),
    tensor attrs read as numbers (which waits for their device)."""
    with _lock:
        done = list(_done)
    out = []
    for s in done:
        for k, v in s.attrs.items():
            if isinstance(v, torch.Tensor):
                s.attrs[k] = v.item()
        out.append(dict(name=s.name, id=s.id, parent=s.parent, root=s.root,
                        start_ns=s.start_ns, end_ns=s.end_ns,
                        attrs=dict(s.attrs)))
    return out


def dropped() -> int:
    """The spans the buffer dropped, oldest first, since :func:`clear`."""
    return _dropped


def clear() -> None:
    """Forget every recorded span and the dropped count."""
    global _dropped
    with _lock:
        _done.clear()
        _dropped = 0
