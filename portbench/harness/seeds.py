"""Seeds drawn from ``--seed``: every query's from the run's seed and the
query's index, so no query repeats another's inputs and a seed gives
the same inputs in every run."""

from __future__ import annotations

from typing import List

import numpy as np

WINDOW, WARMUP, SAMPLE = 0, 1, 2


def _base(seed: int) -> int:
    return int(seed) % (1 << 64)


def query_seeds(seed: int, stream: int, q: int, n: int) -> List[int]:
    """``n`` distinct 63-bit seeds of query ``q`` in ``stream``."""
    state = np.random.SeedSequence([_base(seed), stream, q]) \
        .generate_state(n, np.uint64) >> np.uint64(1)
    return [int(s) for s in state]


def sample_rng(seed: int, q: int = 0) -> np.random.Generator:
    """The draws that pick what a run checks (query ``q``'s part)."""
    return np.random.default_rng(np.random.SeedSequence(
        [_base(seed), SAMPLE, q]))
