"""What the metric readers (``metrics/<name>.py``) share. A reader takes
the window's record (``run.py``'s ``window``, with the traced run's
stage seconds and device trace) and returns a number, or None when the
record holds nothing for it, so the metric is left out of the line."""

from __future__ import annotations

from typing import Optional

from portbench.harness import peaks, workcount

# The round step's kernel, as the device trace names it
# (``csrc/round_step.cu``: ``run_kernel<T>``).
ROUND_STEP_KERNEL = "run_kernel"


def stage_ms(run, stage: str) -> Optional[float]:
    spent = getattr(run, "stage_s", None)
    if not spent or stage not in spent or not run.queries:
        return None
    return 1e3 * spent[stage] / run.queries


def other_ms(run) -> Optional[float]:
    spent = getattr(run, "stage_s", None)
    if not spent or not run.queries:
        return None
    return 1e3 * (sum(run.latencies) - sum(spent.values())) / run.queries


def idle_pct(run) -> Optional[float]:
    dt = getattr(run, "device_trace", None)
    if dt is None or dt.window_s <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_s / dt.window_s)


def kernel_s(run) -> Optional[float]:
    dt = getattr(run, "device_trace", None)
    return None if dt is None else dt.kernel_seconds(ROUND_STEP_KERNEL)


def round_step_us_per_lane(run) -> Optional[float]:
    ks = kernel_s(run)
    if not ks or not run.lanes:
        return None
    return 1e6 * ks / run.lanes


def round_step_roofline(run) -> Optional[float]:
    ks = kernel_s(run)
    if not ks or not run.work_bytes:
        return None
    least, _ = workcount.roofline_seconds(
        run.work_bytes, run.work_ops, peaks.FP32_FLOPS,
        peaks.HBM_BYTES_PER_S)
    return 100.0 * least / ks
