"""Demand-profile helpers shared across layers.

A *demand profile* is a right-continuous step series — (time, value)
change points — which is how every demand signal in the reproduction is
represented: the WS resource-consumption trace (Fig. 10), the EC2
per-job allocation curve, and the serving replicas' slot-utilization
samples. This module is the single place that integrates, samples and
windows such series; it is reused by

  * ``repro.sim.sweep``     — exact WS node-hour integrals and change
                              points for the vectorized sweep,
  * ``repro.core.jaxsim``   — the per-substep WS demand profile of the
                              lax.scan tick simulator,
  * ``repro.core.ws_manager`` (and through it the serving autoscaler) —
                              the trailing-window utilization average of
                              the §6.4 instance-adjustment policy.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["step_points", "step_integral", "sample_steps",
           "per_tick_profile", "job_demand_profile", "scale_profile",
           "windowed_mean"]


def step_points(trace: Sequence[Tuple[float, float]], duration: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Normalize a change-point series to ``(times, values)`` arrays.

    Matches the event engine's reading of a WS trace exactly: entries at
    ``t <= 0`` collapse into the initial value (the last one wins), and
    entries beyond ``duration`` never fire. The returned series starts
    at ``times[0] == 0.0`` and is right-continuous.
    """
    initial = 0.0
    times: List[float] = [0.0]
    values: List[float] = [initial]
    for t, d in trace:
        if t <= 0:
            values[0] = float(d)
        elif t <= duration + 1e-9:
            times.append(float(t))
            values.append(float(d))
    t_arr = np.asarray(times, np.float64)
    v_arr = np.asarray(values, np.float64)
    # The event engine heap-orders whatever it is given (insertion order
    # breaking time ties); a stable sort reproduces that for unsorted input.
    order = np.argsort(t_arr, kind="stable")
    return t_arr[order], v_arr[order]


def step_integral(times: np.ndarray, values: np.ndarray,
                  duration: float) -> float:
    """``∫_0^duration`` of the step series (value·seconds, exact)."""
    edges = np.minimum(np.append(times[1:], duration), duration)
    widths = np.maximum(edges - np.minimum(times, duration), 0.0)
    return float(np.dot(values, widths))


def sample_steps(times: np.ndarray, values: np.ndarray,
                 at: np.ndarray) -> np.ndarray:
    """Value of the step series at each query time (right-continuous)."""
    idx = np.searchsorted(times, at, side="right") - 1
    return values[np.clip(idx, 0, len(values) - 1)]


def per_tick_profile(trace: Sequence[Tuple[float, float]], duration: float,
                     tick_seconds: float) -> np.ndarray:
    """Per-lease-tick demand profile: the series sampled at ``k·tick``."""
    times, values = step_points(trace, duration)
    n = int(np.ceil(duration / tick_seconds))
    return sample_steps(times, values, np.arange(n) * tick_seconds)


def job_demand_profile(submits: np.ndarray, sizes: np.ndarray,
                       duration: float, tick_seconds: float) -> np.ndarray:
    """Aggregate node demand *submitted* within each lease window — a
    segment-sum of job sizes over lease windows; a quick feasibility
    read on a capacity C (see examples/sweep_capacity.py)."""
    n = int(np.ceil(duration / tick_seconds))
    submits = np.asarray(submits, np.float64)
    keep = (submits >= 0) & (submits < duration)
    idx = (submits[keep] // tick_seconds).astype(np.int64)
    return np.bincount(np.minimum(idx, n - 1),
                       weights=np.asarray(sizes, np.float64)[keep],
                       minlength=n)


def scale_profile(trace: Sequence[Tuple[float, float]], factor: float
                  ) -> List[Tuple[float, int]]:
    """Scale a WS demand trace's values by ``factor`` (times unchanged).

    The multi-trace sweep studies (``run_sweep_workloads``) batch the
    same parameter grid over demand variants — e.g. the §6.2 World Cup
    profile at 0.5× / 2× its recorded intensity — and this is the
    canonical way to derive them: values round to whole VMs and never go
    negative, so a scaled trace is still a valid demand profile.
    """
    if factor < 0:
        raise ValueError(f"factor must be >= 0, got {factor}")
    return [(t, max(0, int(round(v * factor)))) for t, v in trace]


def windowed_mean(samples: Sequence[Tuple[float, float]], t: float,
                  window: float) -> Tuple[float, List[Tuple[float, float]]]:
    """Trailing-window average: prune samples older than ``t - window``
    and average the rest. Returns ``(average, pruned_samples)``."""
    kept = [(ts, u) for ts, u in samples if ts >= t - window]
    if not kept:
        return 0.0, kept
    return sum(u for _, u in kept) / len(kept), kept
