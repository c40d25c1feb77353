"""Event-round engine for the stateful PhoenixCloud policies, in PyTorch.

Counterpart of ``repro.sim.rounds``: every step of the loop jumps each
lane straight to its next event horizon

    ``b = min(next submit, earliest completion among running lanes,
              next WS change the policy can react to,
              next lease boundary L·(⌊t/L⌋+1))``

and fires the policy tick only on a lease boundary; completions happen
at their exact times and every allocation interval integrates exactly.
The reference module's docstring sets out what counts as an event, the
contended-stretch coalescer and the tie order; the semantics here are
the same, op for op.

What differs is the form:

* Lanes are a written-out leading tensor axis. The (trace × point) grid
  flattens to ``N = W·P`` lanes, every loop scalar is an ``(N,)`` tensor
  and every window an ``(N, K)`` tensor.
* The outer loop runs through ``repro_torch.kernels.round_step``. Like
  a batched ``while_loop`` each lane stops once its own predicate ``(i
  < outer_max) & (t < duration)`` fails. ``RoundsSpec.kernel="cuda"``
  runs the whole loop in one launch of the hand-written CUDA kernel,
  each thread block looping its own lane on the device; ``"torch"``
  runs a Python loop over the plain step, which runs on every lane and
  lets only the lanes whose predicate holds take the new state.
  ``None`` picks ``"cuda"`` on a CUDA device and ``"torch"`` on the
  CPU.
* Where the reference multiplies a 0/1 mask into a difference of times
  (``cmp_f * (end_t - w_sub)``), this module selects instead: a pad
  lane's ``0 - inf`` would otherwise turn the sum into NaN. XLA rewrites
  the product into the same select, so the values agree.

The chaos tier (``faults=``, FB only, :mod:`repro_torch.sim.faults`)
adds three per-lane tables to the pack: every fault instant is a loop
stop, and the capacity the policy acts on becomes ``max(C - failed(t),
0)``. Like the reference's fused Pallas step, the CUDA round step does
not take them: ``kernel=None`` runs a fault pack on the plain step
(``"torch"``) on any device, and ``kernel="cuda"`` refuses it.

``devices`` splits the lanes across devices through the scan engine's
``sharded_grid_map``, with rows equal bit for bit; fault packs refuse
it, as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core.jobs import Job
from repro_torch.core.profiles import step_points
from repro_torch.sim.scan import (FBGrid, FLBGrid, _lane_prm_tree,
                                  _prm_tree, _size_classes, fb_actions,
                                  flb_actions, pack_job_table,
                                  resolve_pack_dtype, sharded_grid_map,
                                  stable_compact)

__all__ = [
    "PackedEventWorkloads", "RoundsSpec", "pack_event_workloads",
    "from_reference_pack", "rounds_grids", "round_budget",
    "ws_fold_tables_batch", "fb_rounds_row",
    "fold_table_cache_info", "fold_table_cache_clear",
    "FB_ROUNDS_WINDOW", "FLB_ROUNDS_WINDOW", "ROUNDS_FF_PASSES",
    "COMPACT_EVERY", "COALESCE_BATCH", "DEFAULT_BATCH",
]

# Window sizes, pass count, compaction cadence and coalescing batch are
# the reference's (see ``repro.sim.rounds`` for how each was measured).
FB_ROUNDS_WINDOW = 192
FLB_ROUNDS_WINDOW = 96
ROUNDS_FF_PASSES = 2
COMPACT_EVERY = 8
COALESCE_BATCH = 8
DEFAULT_BATCH = 1
_FAULT_FIELDS = ("fault_times", "fault_failed", "fault_wsv")


@dataclasses.dataclass(frozen=True)
class RoundsSpec:
    """Static execution parameters of one policy's event-round program:
    the measurement horizon, the safety cap on rounds, the job window,
    the first-fit passes per round, the compaction cadence and the
    contended-stretch coalescing batch (1 disables coalescing).

    ``kernel`` selects the round-step backend: ``"cuda"`` launches the
    hand-written kernel (``repro_torch.kernels.round_step``), ``"torch"``
    runs the plain version, ``None`` picks ``"cuda"`` on a CUDA device
    and ``"torch"`` on the CPU. A pack with fault tables always runs
    ``"torch"``: the kernel has no fault stops (nor has the reference's
    fused Pallas step), so ``None`` resolves to the plain step before
    any launch and ``"cuda"`` raises."""

    duration: float
    max_rounds: int
    window: int
    ff_passes: int = ROUNDS_FF_PASSES
    compact_every: int = COMPACT_EVERY
    batch: int = DEFAULT_BATCH
    kernel: Optional[str] = None

    def __post_init__(self):
        if self.kernel is not None and self.kernel not in compat.BACKENDS:
            raise ValueError(
                f"unknown rounds kernel {self.kernel!r}; expected "
                f"\"cuda\" or \"torch\"")

    def resolve_kernel(self, device: torch.device,
                       faulted: bool = False) -> str:
        """The backend this spec runs on ``device``, for a pack with
        (``faulted``) or without fault tables."""
        if faulted:
            if self.kernel == "cuda":
                raise NotImplementedError(
                    "fault injection is not supported by the fused CUDA "
                    "round step; use kernel=\"torch\"")
            return "torch"
        return compat.resolve_backend(self.kernel, device, "kernel")


@dataclasses.dataclass(frozen=True)
class PackedEventWorkloads:
    """Fixed-size event tensors for W workloads and one policy's P sweep
    points: the arrival-sorted job tables plus the WS demand change
    points and the host-precomputed WS fold tables."""

    submit: torch.Tensor       # (W, J + K) — padded past the table end
    size: torch.Tensor         # (W, J + K)
    runtime: torch.Tensor      # (W, J + K)
    ws0: torch.Tensor          # (W,) demand at t = 0
    ws_adjusts: torch.Tensor   # (W,) ledgered WS events (startup + changes)
    rise_times: torch.Tensor   # (W, NR) demand-rise times (FB stops), +inf
    rise_vals: torch.Tensor    # (W, NR) demand value after each rise
    ws_integral: torch.Tensor  # (W, P) ∫ policy's WS allocation share
    ws_winmax: torch.Tensor    # (W, P, NT) per-lease-window max of the
    #                            policy's WS share (peak folding)
    ws_at_tick: torch.Tensor   # (W, P, NT) demand at each lease boundary
    n_jobs: torch.Tensor       # (W,) real (unpadded) job counts
    # Chaos tier, FB only; None (the default) leaves the pack what it is
    # without faults.
    fault_times: Optional[torch.Tensor] = None   # (W, NF) stops, +inf
    fault_failed: Optional[torch.Tensor] = None  # (W, NF) failed count
    #                                              in effect AFTER each stop
    fault_wsv: Optional[torch.Tensor] = None     # (W, NF) raw WS demand at
    #                                              each stop (reclaim level)

    @property
    def device(self) -> torch.device:
        return self.submit.device


# The fields every pack holds; the chaos tier's _FAULT_FIELDS are optional.
_PACK_FIELDS = tuple(f.name for f in dataclasses.fields(PackedEventWorkloads)
                     if f.name not in _FAULT_FIELDS)


def _to_pack(arrays: Dict[str, np.ndarray],
             device: torch.device) -> PackedEventWorkloads:
    """The pack of the fields ``arrays`` holds (the fault tables are
    optional)."""
    return PackedEventWorkloads(**{
        k: torch.from_numpy(np.array(v, order="C")).to(device)
        for k, v in arrays.items()})


def from_reference_pack(pk: Dict[str, np.ndarray],
                        device: compat.Device = None
                        ) -> PackedEventWorkloads:
    """A :class:`PackedEventWorkloads` from the JAX package's pack, given
    as a dict of numpy arrays (field name → array). The three fault
    tables are taken when present and not ``None``."""
    return _to_pack({k: np.asarray(pk[k]) for k in _PACK_FIELDS
                     + _FAULT_FIELDS if pk.get(k) is not None},
                    compat.resolve_device(device))


# ------------------------------------------------------------------ packing

def _ws_fold_tables_ref(times: np.ndarray, values: np.ndarray,
                        duration: float, policy: str, leases: np.ndarray,
                        levels: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference fold-table build: the original per-point Python loop
    (``np.union1d`` + ``searchsorted`` + grouped max per lease window).
    Kept as the correctness oracle for :func:`ws_fold_tables_batch`
    (tests pin exact equality) — NOT called on any production path.
    """
    edges = np.minimum(np.append(times[1:], duration), duration)
    widths = np.maximum(edges - np.minimum(times, duration), 0.0)
    P = len(leases)
    if policy == "fb":
        share = np.minimum(values[None, :], levels[:, None])   # (P, NWS)
    else:
        share = np.maximum(values[None, :] - levels[:, None], 0.0)
    integral = share @ widths
    # One entry past the last full window: when the horizon is an exact
    # lease multiple a tick fires AT the horizon and probes the
    # degenerate window starting there — it must read the horizon-time
    # demand, not zero padding.
    nt = max(int(np.ceil(duration / leases.min())), 1) + 1
    winmax = np.zeros((P, nt))
    at_tick = np.zeros((P, nt))
    for p in range(P):
        n_win = max(int(np.ceil(duration / leases[p])), 1)
        # Merge the demand change points with the window edges, so each
        # merged cell lies in exactly one window and carries one share
        # value; a grouped max per window then covers segments that
        # span window boundaries.
        win_edges = np.arange(n_win) * leases[p]
        merged = np.union1d(times, win_edges)
        merged = merged[merged < duration]
        vals = share[p][np.searchsorted(times, merged, "right") - 1]
        starts = np.searchsorted(merged, win_edges, "left")
        winmax[p, :n_win] = np.maximum.reduceat(vals, starts)
        at_tick[p, :n_win] = values[
            np.searchsorted(times, win_edges, "right") - 1]
        end_idx = np.searchsorted(times, n_win * leases[p], "right") - 1
        winmax[p, n_win] = share[p][end_idx]
        at_tick[p, n_win] = values[end_idx]
    return integral, winmax, at_tick


def ws_fold_tables_batch(times: np.ndarray, values: np.ndarray,
                         duration: float, policy: str, leases: np.ndarray,
                         levels: np.ndarray,
                         failed: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized WS fold tables over all (W, P) lanes at once.

    ``times`` is ONE sorted change-point axis (N,) shared by every lane
    (each entry < ``duration``), and ``values`` the per-lane demand rows
    (W, N) — a 1-D ``values`` is treated as one lane. Returns
    ``(integral (W, P), winmax (W, P, NT), at_tick (W, P, NT))``,
    elementwise equal to :func:`_ws_fold_tables_ref`:

    * ``integral`` — exact node-second integral of the policy's WS
      allocation share (``min(ws, C)`` for FB, ``max(ws − lb_ws, 0)``
      for FLB-NUB), one stacked GEMV over the segment widths;
    * ``winmax`` — the share's max over every lease window
      ``[kL, (k+1)L)``: the max of the *boundary* value and a
      segment-max of the change points grouped by window index;
    * ``at_tick`` — the demand at every lease boundary.

    Windows past a point's horizon (``k > ceil(duration / L_p)``) are
    zero, exactly like the reference. ``failed``, when given, is the
    concurrently-failed node count on the same time axis (FB only); the
    FB share line becomes ``min(ws, max(C - failed, 0))``.
    """
    times = np.asarray(times, np.float64)
    values = np.asarray(values, np.float64)
    if values.ndim == 1:
        values = values[None]
    leases = np.asarray(leases, np.float64)
    levels = np.asarray(levels, np.float64)
    W, N = values.shape
    P = len(leases)
    edges = np.minimum(np.append(times[1:], duration), duration)
    widths = np.maximum(edges - np.minimum(times, duration), 0.0)   # (N,)
    if failed is not None and policy != "fb":
        raise ValueError("time-varying failed capacity is FB-only "
                         "(FLB-NUB's WS share is elastic)")
    if policy == "fb":
        cap = levels[None, :, None]
        if failed is not None:
            failed = np.asarray(failed, np.float64)
            cap = np.maximum(cap - failed[None, None, :], 0.0)
        share = np.minimum(values[:, None, :], cap)
    else:
        share = np.maximum(values[:, None, :] - levels[None, :, None],
                           0.0)                                 # (W, P, N)
    # (W, P, N) @ (N,) runs the same (P, N) GEMV per lane as the
    # reference loop, keeping the integral bit-identical for every W.
    integral = share @ widths
    nt = max(int(np.ceil(duration / leases.min())), 1) + 1
    n_win = np.maximum(np.ceil(duration / leases).astype(np.int64), 1)
    win_edges = np.arange(nt)[None, :] * leases[:, None]        # (P, NT)
    # The segment covering each window boundary (right-continuous).
    bidx = (np.searchsorted(times, win_edges.ravel(), "right")
            .reshape(P, nt) - 1)
    at_tick = values[:, bidx]                                   # (W, P, NT)
    winmax = np.take_along_axis(
        share, np.broadcast_to(bidx, (W, P, nt)), axis=2).copy()
    # Segment max of the interior change points, grouped by window
    # index: flattening (p, window) into one composite, strictly sorted
    # grouping makes the groups contiguous runs of the (P·N) axis, so
    # one reduceat covers all points. reduceat's empty-segment quirk (it
    # returns the start element) is masked off via the run lengths.
    interior = times < duration
    ii = np.nonzero(interior)[0]
    if ii.size:
        M = ii.size
        widx = np.minimum((times[ii][None, :]
                           // leases[:, None]).astype(np.int64),
                          nt - 1)                               # (P, M)
        flat_groups = (np.arange(P)[:, None] * nt + widx).ravel()
        starts = np.searchsorted(flat_groups, np.arange(P * nt), "left")
        counts = np.append(np.diff(starts), P * M - starts[-1])
        # A trailing -inf sentinel keeps every start index valid.
        share_flat = np.concatenate(
            [share[:, :, ii].reshape(W, P * M),
             np.full((W, 1), -np.inf)], axis=1)
        seg = np.maximum.reduceat(share_flat, starts, axis=1)
        seg = np.where(counts[None, :] > 0, seg, -np.inf)
        winmax = np.maximum(winmax, seg.reshape(W, P, nt))
    # A point's windows end at n_win = ceil(duration / L): entry n_win
    # is the degenerate horizon-boundary probe; entries past it stay
    # zero like the reference's.
    live = np.arange(nt)[None, :] <= n_win[:, None]             # (P, NT)
    winmax = np.where(live[None], winmax, 0.0)
    at_tick = np.where(live[None], at_tick, 0.0)
    return integral, winmax, at_tick


@functools.lru_cache(maxsize=256)
def _fold_tables_cached(times_b: bytes, values_b: bytes, duration: float,
                        policy: str, leases_b: bytes, levels_b: bytes,
                        failed_b: bytes = b""
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One workload's fold tables, memoized on the trace identity (the
    raw change-point bytes), the policy and the grid's (leases, levels).
    Cached arrays are marked read-only; consumers copy via ``astype``."""
    times = np.frombuffer(times_b, np.float64)
    values = np.frombuffer(values_b, np.float64)
    leases = np.frombuffer(leases_b, np.float64)
    levels = np.frombuffer(levels_b, np.float64)
    failed = np.frombuffer(failed_b, np.float64) if failed_b else None
    integral, winmax, at_tick = ws_fold_tables_batch(
        times, values, duration, policy, leases, levels, failed)
    out = (integral[0], winmax[0], at_tick[0])
    for a in out:
        a.flags.writeable = False
    return out


def fold_table_cache_info():
    """``lru_cache`` statistics of the per-workload fold-table cache."""
    return _fold_tables_cached.cache_info()


def fold_table_cache_clear() -> None:
    _fold_tables_cached.cache_clear()


def pack_event_workloads(workloads: Sequence[Tuple[Sequence[Job],
                                                   Sequence[Tuple[float,
                                                                  int]]]],
                         duration: float, window: int, policy: str,
                         leases: Sequence[float], levels: Sequence[float],
                         dtype=None, split: bool = False, faults=None,
                         device: compat.Device = None):
    """Pack ``(jobs, ws_trace)`` workloads into event-round tensors for
    one policy's sweep points, on ``device``.

    ``levels`` is the per-point WS fold level — the capacity C for FB,
    the WS lower bound for FLB-NUB. WS change points collapse to actual
    value changes within the horizon; a trailing ``+inf`` sentinel keeps
    gathers in range after the last real change. ``dtype`` defaults to
    float32. With ``split=True`` the return value is a LIST of
    single-workload packs (one per trace, identical shapes since they
    are padded together) cut on the host.

    ``faults``, when given, is a per-workload sequence of
    :class:`repro_torch.sim.faults.FaultSchedule` (or ``None`` entries)
    — FB only. Fault instants become loop stops (``fault_times`` /
    ``fault_failed`` / ``fault_wsv``), and the fold tables are rebuilt
    on the union of demand and fault change points with the FB share
    line ``min(ws, max(C - failed(t), 0))``. Demand-rise stops keep
    coming from the original demand points.
    """
    dev = compat.resolve_device(device)
    dtype = resolve_pack_dtype(dtype)
    if faults is not None and any(f is not None and len(f) for f in faults):
        if policy != "fb":
            raise ValueError(
                "fault schedules are FB-only in the rounds engine; run "
                "FLB-NUB faults through the event engine")
        if len(faults) != len(workloads):
            raise ValueError(
                f"faults ({len(faults)}) must align with workloads "
                f"({len(workloads)})")
    else:
        faults = None
    submit, size, runtime, n_jobs = pack_job_table(workloads, window, dtype)
    W = len(workloads)
    leases = np.asarray(leases, np.float64)
    levels = np.asarray(levels, np.float64)
    rises: List[Tuple[np.ndarray, np.ndarray]] = []
    fault_tabs: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    integrals, winmaxes, at_ticks = [], [], []
    ws0 = np.zeros(W, dtype)
    ws_adjusts = np.zeros(W, dtype)
    for w, (_, ws_trace) in enumerate(workloads):
        times, values = step_points(ws_trace, duration)
        keep = np.ones(len(times), bool)
        keep[1:] = values[1:] != values[:-1]   # drop no-op change points
        times, values = times[keep], values[keep]
        ws0[w] = values[0]
        ws_adjusts[w] = (len(times) - 1) + float(values[0] > 0)
        up = values[1:] > values[:-1]
        rises.append((times[1:][up], values[1:][up]))
        fs = faults[w] if faults is not None else None
        failed_b = b""
        if fs is not None and len(fs):
            # The site ledger's clamp (at most C nodes down at once) is
            # per capacity: a multi-level grid shares one fault table
            # only when the clamp never binds.
            if np.unique(levels).size == 1:
                fs = fs.clamp(int(levels[0]))
            elif fs.max_concurrent() > int(np.min(levels)):
                raise ValueError(
                    "fault schedule's concurrent failures exceed the "
                    "smallest capacity level; the ledger clamp is "
                    "per-capacity — pack one level at a time")
        if fs is not None and len(fs):
            f_t, f_n = fs.failed_series()
            # Distinct fault instants inside the horizon, the failed
            # count after all same-time events and the raw demand there.
            u_t = np.unique(f_t[f_t < duration])
            u_n = np.concatenate([[0], f_n])[
                np.searchsorted(f_t, u_t, "right")].astype(np.float64)
            u_w = values[np.searchsorted(times, u_t, "right") - 1]
            fault_tabs.append((u_t, u_n, u_w))
            # Fold axis: the union of demand and fault change points.
            m_t = np.union1d(times, u_t)
            m_v = values[np.searchsorted(times, m_t, "right") - 1]
            m_f = np.concatenate([[0.0], u_n])[
                np.searchsorted(u_t, m_t, "right")]
            fold_t, fold_v = m_t, m_v
            failed_b = np.ascontiguousarray(m_f, np.float64).tobytes()
        else:
            fault_tabs.append((np.zeros(0), np.zeros(0), np.zeros(0)))
            fold_t, fold_v = times, values
        integral, winmax, at_tick = _fold_tables_cached(
            np.ascontiguousarray(fold_t, np.float64).tobytes(),
            np.ascontiguousarray(fold_v, np.float64).tobytes(),
            float(duration), policy, leases.tobytes(), levels.tobytes(),
            failed_b)
        integrals.append(integral)
        winmaxes.append(winmax)
        at_ticks.append(at_tick)
    nr = max((len(r) for r, _ in rises), default=0) + 1   # +inf sentinel
    rise_times = np.full((W, nr), np.inf, dtype)
    rise_vals = np.zeros((W, nr), dtype)
    for w, (r_t, r_v) in enumerate(rises):
        rise_times[w, :len(r_t)] = r_t
        rise_vals[w, :len(r_v)] = r_v
    arrays = dict(
        submit=submit, size=size, runtime=runtime, ws0=ws0,
        ws_adjusts=ws_adjusts, rise_times=rise_times,
        rise_vals=rise_vals,
        ws_integral=np.stack(integrals).astype(dtype),
        ws_winmax=np.stack(winmaxes).astype(dtype),
        ws_at_tick=np.stack(at_ticks).astype(dtype), n_jobs=n_jobs)
    if faults is not None:
        nf = max(len(ft) for ft, _, _ in fault_tabs) + 1  # +inf sentinel
        fault_times = np.full((W, nf), np.inf, dtype)
        fault_failed = np.zeros((W, nf), dtype)
        fault_wsv = np.zeros((W, nf), dtype)
        for w, (f_t, f_n, f_w) in enumerate(fault_tabs):
            fault_times[w, :len(f_t)] = f_t
            fault_failed[w, :len(f_n)] = f_n
            fault_wsv[w, :len(f_w)] = f_w
        arrays.update(fault_times=fault_times, fault_failed=fault_failed,
                      fault_wsv=fault_wsv)
    if split:
        return [_to_pack({k: v[w:w + 1] for k, v in arrays.items()}, dev)
                for w in range(W)]
    return _to_pack(arrays, dev)


def round_budget(max_jobs: int, n_ws: int, duration: float,
                 min_lease: float) -> int:
    """Safety cap on rounds per lane: every submit, one completion per
    job plus generous kill-restart slack, every demand rise and every
    lease tick of the *shortest* lease in the grid. A lane that
    exhausts it reports ``truncated`` and the sweep layer warns.
    """
    ticks = int(np.ceil(duration / max(min_lease, 1.0)))
    return int(n_ws + 4 * max_jobs + ticks + 64)


# ------------------------------------------------------------- the rounds core

# The loop's metric accumulators, in the FIXED order the round-step
# kernel packs them into its scalar state vector.
ACC_KEYS = ("completed", "turn_sum", "exec_sum", "kills", "node_seconds",
            "peak", "pbj_adjusts", "adjusts", "window_overflow", "rounds",
            "coalesced")


def _lane_ctx(policy: str, prm: Dict, pk: PackedEventWorkloads) -> Dict:
    """The per-lane round-body inputs as a flat dict of lane-axis
    tensors. ``prm`` holds one entry per lane: the policy scalars plus
    ``w_idx`` (the lane's workload row) and ``p_idx`` (its sweep point's
    index into the packed WS fold tables)."""
    f = pk.submit.dtype
    w, p = prm["w_idx"], prm["p_idx"]
    ctx = {
        "L": prm["lease"].to(f),
        "tr_submit": pk.submit[w], "tr_size": pk.size[w],
        "tr_runtime": pk.runtime[w],
        "rise_times": pk.rise_times[w], "rise_vals": pk.rise_vals[w],
        "ws_winmax": pk.ws_winmax[w, p],    # (N, NT) WS-share window max
        "ws_at_tick": pk.ws_at_tick[w, p],  # (N, NT) demand at boundaries
    }
    if policy == "fb":
        ctx["C"] = prm["capacity"].to(f)
        if pk.fault_times is not None:
            # Chaos tier: the fault stops, the failed count after each
            # and the raw demand at each (the pack enforces FB-only).
            for k in _FAULT_FIELDS:
                ctx[k] = getattr(pk, k)[w]                # (N, NF)
    else:
        for k in ("B", "lb_ws", "U", "V", "G"):
            ctx[k] = prm[k].to(f)
    return ctx


def _take(table, idx):
    """``table[n, idx[n]]`` per lane with the index clamped into range,
    as a JAX gather clamps."""
    idx = torch.clamp(idx.long(), 0, table.shape[1] - 1)
    return table.gather(1, idx[:, None])[:, 0]


def _actions(policy: str, ctx: Dict, ff_passes: int, owned, pool_pbj,
             run, used, queued, wsv, is_tick, win, w_sz, szcls, acc):
    """The shared §5 policy step at one instant. The integrand it returns
    covers only the policy-owned share (the WS share integrates
    host-side) and peaks fold per lease window (see the reference)."""
    ws_winmax = _take(ctx["ws_winmax"], win)
    neg_inf = torch.full_like(owned, -np.inf)
    if policy == "fb":
        C = ctx["C"]
        owned, run, starts, killed, alloc, pbj_ev = fb_actions(
            C, owned, run, used, queued, wsv, w_sz,
            *szcls, is_tick, ff_passes)
        acc["kills"] = acc["kills"] + killed.sum(dim=-1).to(owned.dtype)
        # Window peak: the §5.1 ratchet makes the in-window alloc max
        # exactly min(owned + M, C).
        peak_cand = torch.minimum(owned + ws_winmax, C)
        integrand = owned
    else:
        owned, pool_pbj, run, starts, alloc, pbj_ev = flb_actions(
            ctx["B"], ctx["lb_ws"], ctx["U"], ctx["V"], ctx["G"],
            owned, pool_pbj, run, used, queued, wsv, w_sz, is_tick,
            ff_passes)
        leased = ctx["B"] + torch.clamp_min(owned - pool_pbj, 0.0)
        peak_cand = leased + ws_winmax
        integrand = leased
    acc["peak"] = torch.maximum(acc["peak"],
                                torch.where(is_tick, peak_cand, neg_inf))
    acc["pbj_adjusts"] = acc["pbj_adjusts"] + pbj_ev
    acc["adjusts"] = acc["adjusts"] + pbj_ev
    return owned, pool_pbj, run, starts, integrand, acc


def _round_body(policy: str, ctx: Dict, spec: RoundsSpec, carry, szcls):
    """One event round over the window lanes of every lane (see the
    reference's ``_round_body`` for the event semantics)."""
    (t, owned, pool_pbj, used, has_queue, wsv, alloc_prev, rise_i,
     row_sub, w_sub, w_sz, w_rt, run, done, start_t, end_t, acc) = carry
    acc = dict(acc)
    duration = spec.duration
    K = w_sub.shape[1]
    batch = min(spec.batch, K)      # top-k cannot exceed the window
    coalesce = batch > 1
    f = w_sub.dtype
    inf, zero = float("inf"), 0.0     # scalars take the tensor's dtype
    L = ctx["L"]
    NT = ctx["ws_winmax"].shape[1]
    tc = t[:, None]
    active = t < duration
    # --- the next event horizon: every candidate is strictly > t; a
    # finished lane pins b = t and becomes a no-op.
    mins0 = torch.where(w_sub > tc, w_sub, inf).amin(dim=-1)
    mins1 = torch.where(run, end_t, inf).amin(dim=-1)
    row_next = torch.where(row_sub > t, row_sub, inf)
    next_sub = torch.minimum(mins0, row_next)
    k_next = torch.floor(t / L) + 1.0
    t_tick = k_next * L
    b0 = torch.minimum(t_tick, torch.clamp_max(row_next, duration))
    if policy == "fb":
        b0 = torch.minimum(b0, _take(ctx["rise_times"], rise_i))
    faulted = "fault_times" in ctx
    if faulted:
        # Chaos tier: every fault instant is a stop; between stops the
        # failed count, and so the effective capacity, is constant.
        ft = ctx["fault_times"]
        fi = torch.searchsorted(ft, t[:, None].contiguous(), right=True)[:, 0]
        b0 = torch.minimum(b0, _take(ft, fi))
    if not coalesce:
        b0 = torch.minimum(b0, torch.where(has_queue, mins1, inf))
    fresh = (w_sub > tc) & (w_sub <= b0[:, None])
    sum_new = torch.where(fresh, w_sz, zero).sum(dim=-1)
    free = owned - used
    skip_ok = ~has_queue & (sum_new <= free)
    if coalesce:
        unbounded = skip_ok | has_queue
    else:
        min_new = torch.where(fresh, w_sz, inf).amin(dim=-1)
        unbounded = skip_ok | (has_queue & (min_new > free))
    b = torch.where(unbounded, b0, torch.minimum(b0, next_sub))
    b = torch.where(active, b, t)
    if coalesce:
        (b, run, done, start_t, end_t, used, acc) = _coalesce(
            batch, t, b, active, has_queue, free, used, w_sub, w_sz, w_rt,
            run, done, start_t, end_t, acc)
    # --- exact interval integration: the policy-owned share is
    # constant on (t, b].
    acc["node_seconds"] = acc["node_seconds"] \
        + alloc_prev * torch.clamp_min(b - t, 0.0)
    bc = b[:, None]
    # --- retroactive starts at exact submit times.
    starting = (w_sub > tc) & (w_sub <= bc) & ~run & ~done & skip_ok[:, None]
    run = run | starting
    start_t = torch.where(starting, w_sub, start_t)
    end_t = torch.where(starting, w_sub + w_rt, end_t)
    # --- exact completions (including flash jobs that started and
    # finished inside this very horizon).
    completing = run & (end_t <= bc)
    run = run & ~completing
    done = done | completing
    acc["completed"] = acc["completed"] + completing.to(f).sum(dim=-1)
    acc["turn_sum"] = acc["turn_sum"] + torch.where(
        completing, end_t - w_sub, zero).sum(dim=-1)
    acc["exec_sum"] = acc["exec_sum"] + torch.where(
        completing, end_t - start_t, zero).sum(dim=-1)
    used = torch.where(run, w_sz, zero).sum(dim=-1)
    # --- policy actions at b. The tick fires only on a lease boundary
    # and reads the boundary-time demand from the host table; between
    # stops the carried demand only matters to FB (rises are FB stops).
    queued = (w_sub <= bc) & ~run & ~done
    is_tick = t_tick <= b
    win = torch.clamp(torch.minimum(k_next, torch.full_like(k_next, NT - 1.0)),
                      min=0).to(torch.int32)
    if policy == "fb":
        rised = _take(ctx["rise_times"], rise_i) <= b
        wsv = torch.where(rised, _take(ctx["rise_vals"], rise_i), wsv)
        rise_i = rise_i + rised.to(torch.int32)
    if faulted:
        # Effective capacity at b: the failed count after the last fault
        # event <= b. At a fault instant the carried demand syncs to the
        # packed raw value (the event engine's on_fail sees the current
        # demand; the carried wsv tracks only rises and ticks).
        fib = torch.searchsorted(ft, b[:, None].contiguous(), right=True)[:, 0]
        fprev = torch.clamp_min(fib - 1, 0)
        hit = fib > 0
        failed_b = torch.where(hit, _take(ctx["fault_failed"], fprev), zero)
        wsv = torch.where(hit & (_take(ft, fprev) == b),
                          _take(ctx["fault_wsv"], fprev), wsv)
        ctx = dict(ctx, C=torch.clamp_min(ctx["C"] - failed_b, zero))
    wsv = torch.where(is_tick, _take(ctx["ws_at_tick"], win), wsv)
    owned, pool_pbj, run, starts, integrand, acc = _actions(
        policy, ctx, spec.ff_passes, owned, pool_pbj, run, used, queued,
        wsv, is_tick, win, w_sz, szcls, acc)
    start_t = torch.where(starts, bc, start_t)
    end_t = torch.where(starts, bc + w_rt, end_t)
    # Recompute the queue and usage from the POST-action lane state:
    # kills re-queue lanes and release their nodes.
    has_queue = ((w_sub <= bc) & ~run & ~done).to(f).sum(dim=-1) > 0
    used = torch.where(run, w_sz, zero).sum(dim=-1)
    acc["window_overflow"] = acc["window_overflow"] \
        + (active & (row_sub <= b)).to(f)
    acc["rounds"] = acc["rounds"] + active.to(f)
    return (b, owned, pool_pbj, used, has_queue, wsv, integrand,
            rise_i, row_sub, w_sub, w_sz, w_rt, run, done, start_t,
            end_t, acc)


def _coalesce(batch, t, b, active, has_queue, free0, used0, w_sub, w_sz,
              w_rt, run0, done0, start_t, end_t, acc):
    """The contended-stretch coalescer of ``_round_body`` (``batch > 1``):
    while a queue existed at the round start, replay up to ``batch``
    completion instants inside (t, b) — and the queue admissions they
    allow — in one round, ending the round exactly AT the first instant
    where the closed form could diverge from the engine's first-fit (a
    leapfrog, a chain completion or the cap). The reference's comments
    (``repro.sim.rounds``, lines 761-897) walk through each step."""
    f = w_sub.dtype
    inf, zero = float("inf"), 0.0
    engaged = (active & has_queue)[:, None]
    # (1) masked top-k completion instants inside (t, b).
    avail = engaged & run0 & (end_t < b[:, None])
    taus, freds = [], []
    for _ in range(batch):
        v = torch.where(avail, end_t, inf).amin(dim=-1)
        take = avail & (end_t <= v[:, None])
        taus.append(v)
        freds.append(torch.where(take, w_sz, zero).sum(dim=-1))
        avail = avail & ~take
    frontier = torch.where(avail, end_t, inf).amin(dim=-1)
    tau_v = torch.stack(taus, dim=1)                         # (N, k) sorted
    freedcum = torch.cumsum(torch.stack(freds, dim=1), dim=1)
    tau_pad = torch.cat([t[:, None], tau_v], dim=1)          # idx 0 → t
    # (2) prefix-sum admission in lane (= arrival) order.
    pend = engaged & ~run0 & ~done0 & (w_sub <= b[:, None])
    psz = torch.where(pend, w_sz, zero)
    need = (torch.cumsum(psz, dim=1) - psz) + w_sz - free0[:, None]
    uncov = need[:, :, None] > freedcum[:, None, :]          # (N, K, k)
    idx = uncov.to(torch.int32).sum(dim=-1)
    start_i = torch.where(need <= 0.0, torch.zeros_like(idx),
                          torch.clamp_max(idx + 1, batch))
    covered = pend & ((need <= 0.0) | (idx < batch))
    start_at = torch.where(
        covered, torch.maximum(w_sub, tau_pad.gather(1, start_i.long())),
        inf)
    # A zero-runtime job starting AT the round start is left to the
    # tail's first-fit (Θ must stay > t).
    start_at = torch.where((w_rt <= 0.0) & (start_at <= t[:, None]), inf,
                           start_at)
    # (3) divergence probes, all conservative.
    stsz = torch.where(start_at < inf, w_sz, zero)
    started_by = torch.where(start_at[:, :, None] <= tau_v[:, None, :],
                             stsz[:, :, None], zero).sum(dim=1)   # (N, k)
    free_at = free0[:, None] + freedcum - started_by
    fits = (pend[:, :, None]
            & (w_sub[:, :, None] <= tau_v[:, None, :])
            & (start_at[:, :, None] > tau_v[:, None, :])
            & (w_sz[:, :, None] <= free_at[:, None, :]))      # (N, K, k)
    leap = torch.where(fits.any(dim=1), tau_v, inf).amin(dim=-1)
    net = torch.cat([freedcum[:, :1], torch.diff(freedcum, dim=1)], dim=1) \
        - torch.cat([started_by[:, :1], torch.diff(started_by, dim=1)],
                    dim=1)
    # free0 + (tau < w_sub) @ net: integer-valued, exact in any order.
    free_arr = free0[:, None] + torch.where(
        tau_v[:, None, :] < w_sub[:, :, None], net[:, None, :],
        zero).sum(dim=-1)
    arr_leap = pend & (w_sub > t[:, None]) & (start_at > w_sub) \
        & (w_sz <= free_arr)
    leap = torch.minimum(leap,
                         torch.where(arr_leap, w_sub, inf).amin(dim=-1))
    chain = torch.where(start_at < inf, start_at + w_rt, inf).amin(dim=-1)
    chain = torch.where(chain > t, chain, inf)
    theta = torch.minimum(torch.minimum(leap, chain), frontier)
    # (4) apply everything strictly before Θ.
    lim = torch.minimum(theta, b)[:, None]
    cmp_c = engaged & run0 & (end_t < lim)
    st_c = start_at < lim
    n_c = cmp_c.to(f).sum(dim=-1)
    run = (run0 & ~cmp_c) | st_c
    done = done0 | cmp_c
    acc["completed"] = acc["completed"] + n_c
    acc["turn_sum"] = acc["turn_sum"] + torch.where(
        cmp_c, end_t - w_sub, zero).sum(dim=-1)
    acc["exec_sum"] = acc["exec_sum"] + torch.where(
        cmp_c, end_t - start_t, zero).sum(dim=-1)
    acc["coalesced"] = acc["coalesced"] + n_c
    used = used0 - torch.where(cmp_c, w_sz, zero).sum(dim=-1) \
        + torch.where(st_c, w_sz, zero).sum(dim=-1)
    start_t = torch.where(st_c, start_at, start_t)
    end_t = torch.where(st_c, start_at + w_rt, end_t)
    b = torch.minimum(b, theta)
    return b, run, done, start_t, end_t, used, acc


def _chunk_core(policy: str, ctx: Dict, spec: RoundsSpec, core):
    """One outer step of the loop for every lane: window compaction,
    job-table admission, the per-chunk size classes and
    ``compact_every`` event rounds. ``core`` is the 17-tuple loop state
    with ``next_row`` (the admission cursor) in the slot the inner
    rounds carry ``row_sub`` in."""
    (t, owned, pool_pbj, used, has_queue, wsv, alloc_prev, rise_i,
     next_row, w_sub, w_sz, w_rt, run, done, start_t, end_t, acc) = core
    tr_submit = ctx["tr_submit"]
    K = w_sub.shape[1]
    Jp = tr_submit.shape[1]        # includes >= K pad rows (submit = +inf)
    lanes = torch.arange(K, device=t.device)
    # --- compact done lanes out of the window and admit the next table
    # rows into the freed tail. The slice start clamps into [0, Jp - K]
    # as a dynamic slice does, so once the table is exhausted admitted
    # lanes read the +inf pad block — never a duplicate of a live row.
    (run, start_t, end_t, w_sub, w_sz, w_rt), n_keep = stable_compact(
        ~done, [run, start_t, end_t, w_sub, w_sz, w_rt],
        [False, 0.0, 0.0, np.inf, 0.0, 0.0])
    done = torch.zeros_like(run)
    adm_start = torch.clamp(next_row.long() - n_keep.long(), 0, Jp - K)
    rows = adm_start[:, None] + lanes[None, :]
    tail = lanes[None, :] >= n_keep[:, None]
    w_sub = torch.where(tail, tr_submit.gather(1, rows), w_sub)
    w_sz = torch.where(tail, ctx["tr_size"].gather(1, rows), w_sz)
    w_rt = torch.where(tail, ctx["tr_runtime"].gather(1, rows), w_rt)
    next_row = torch.clamp_max(next_row.long() + (K - n_keep.long()),
                               Jp).to(torch.int32)
    row_sub = _take(tr_submit, torch.clamp_max(next_row, Jp - 1))
    inner = (t, owned, pool_pbj, used, has_queue, wsv, alloc_prev,
             rise_i, row_sub, w_sub, w_sz, w_rt, run, done, start_t,
             end_t, acc)
    # The FB kill size classes depend only on the window contents,
    # which change at compactions — computed once per chunk.
    szcls = _size_classes(w_sz)
    for _ in range(spec.compact_every):
        inner = _round_body(policy, ctx, spec, inner, szcls)
    (t, owned, pool_pbj, used, has_queue, wsv, alloc_prev, rise_i,
     row_sub, w_sub, w_sz, w_rt, run, done, start_t, end_t,
     acc) = inner
    return (t, owned, pool_pbj, used, has_queue, wsv, alloc_prev,
            rise_i, next_row, w_sub, w_sz, w_rt, run, done, start_t,
            end_t, acc)


def _startup(policy: str, ctx: Dict, spec: RoundsSpec, ws0):
    """The startup round at t = 0 for every lane: the engine's startup()
    allocation followed by the t = 0 submit events (no tick fires at 0),
    plus the first lease window's peak probe. Returns the packed loop
    state ``(sc, win)``."""
    from repro_torch.kernels import round_step as rsk
    K = spec.window
    tr_submit = ctx["tr_submit"]
    N = tr_submit.shape[0]
    f = tr_submit.dtype
    dev = tr_submit.device
    zero = torch.zeros(N, dtype=f, device=dev)
    if policy == "fb":
        C = ctx["C"]
        owned0 = C - torch.minimum(ws0, C)    # startup: all idle → PBJ
        pool0 = zero
    else:
        owned0 = torch.clamp_min(ctx["B"] - ctx["lb_ws"], 1.0)   # §5.2
        pool0 = owned0
    acc = {k: zero for k in ACC_KEYS}
    w_sub = tr_submit[:, :K]
    w_sz = ctx["tr_size"][:, :K]
    w_rt = ctx["tr_runtime"][:, :K]
    queued0 = w_sub <= 0.0
    no_run = torch.zeros(N, K, dtype=torch.bool, device=dev)
    owned, pool_pbj, run, starts0, alloc0, acc = _actions(
        policy, ctx, spec.ff_passes, owned0, pool0, no_run, zero, queued0,
        ws0, torch.zeros(N, dtype=torch.bool, device=dev),
        torch.zeros(N, dtype=torch.int32, device=dev), w_sz,
        _size_classes(w_sz), acc)
    ws_winmax0 = ctx["ws_winmax"][:, 0]
    if policy == "fb":
        probe = torch.minimum(owned + ws_winmax0, ctx["C"])
    else:
        probe = ctx["B"] + torch.clamp_min(owned - pool_pbj, 0.0) \
            + ws_winmax0
    acc["peak"] = torch.maximum(acc["peak"], probe)
    start_t = torch.zeros(N, K, dtype=f, device=dev)
    end_t = torch.where(starts0, w_rt, start_t)
    used0 = torch.where(run, w_sz, 0.0).sum(dim=-1)
    has_queue0 = (queued0 & ~run).to(f).sum(dim=-1) > 0
    core0 = (zero, owned, pool_pbj, used0, has_queue0, ws0, alloc0,
             torch.zeros(N, dtype=torch.int32, device=dev),
             torch.full((N,), K, dtype=torch.int32, device=dev),
             w_sub, w_sz, w_rt, run, no_run, start_t, end_t, acc)
    return rsk.pack_carry(core0)


def _simulate_rounds(policy: str, prm: Dict, pk: PackedEventWorkloads,
                     spec: RoundsSpec) -> Dict[str, torch.Tensor]:
    """Every (point, workload) lane of ``prm`` at once (see
    :func:`_lane_ctx` for ``prm``). A lane runs outer steps while its
    own predicate ``(i < outer_max) & (t < duration)`` holds, like a
    batched ``while_loop``: with ``spec.kernel`` "cuda" the round-step
    kernel runs every lane's whole loop in one launch
    (``round_step.run_rounds``); with "torch" a host loop steps the
    plain version over the packed state and freezes each lane once its
    predicate fails."""
    from repro_torch.kernels import round_step as rsk
    kernel = spec.resolve_kernel(pk.device, pk.fault_times is not None)
    ctx = _lane_ctx(policy, prm, pk)
    f = pk.submit.dtype
    w_idx, p_idx = prm["w_idx"], prm["p_idx"]
    sc, win = _startup(policy, ctx, spec, pk.ws0[w_idx])
    ftab = rsk.fault_table(ctx)
    jobs, rises, wstab, prmv = rsk.lane_inputs(policy, ctx, ftab)
    outer_max = -(-spec.max_rounds // spec.compact_every)
    dur = torch.tensor(spec.duration, dtype=f, device=sc.device)
    if kernel == "cuda":
        sc, win, _ = rsk.run_rounds(jobs, rises, wstab, prmv, sc, win,
                                    policy=policy, spec=spec,
                                    outer_max=outer_max)
    else:
        i = torch.zeros(sc.shape[0], dtype=torch.int32, device=sc.device)
        while True:
            live = (i < outer_max) & (sc[:, rsk.SC_T] < dur)
            if not bool(live.any()):
                break
            sc_n, win_n = rsk.chunk_step_ref(jobs, rises, wstab, prmv, sc,
                                             win, policy=policy, spec=spec,
                                             ftab=ftab)
            sc = torch.where(live[:, None], sc_n, sc)
            win = torch.where(live[:, None, None], win_n, win)
            i = i + live.to(torch.int32)
    t_end = sc[:, rsk.SC_T]
    acc = {k: sc[:, rsk.SC_ACC0 + j] for j, k in enumerate(ACC_KEYS)}
    n_done = torch.clamp_min(acc["completed"], 1.0)
    return {
        "completed_jobs": acc["completed"],
        "avg_turnaround": acc["turn_sum"] / n_done,
        "avg_execution": acc["exec_sum"] / n_done,
        "node_hours": (acc["node_seconds"] + pk.ws_integral[w_idx, p_idx])
        / 3600.0,
        "peak_nodes": acc["peak"],
        "adjust_events": acc["adjusts"] + pk.ws_adjusts[w_idx],
        "pbj_adjust_events": acc["pbj_adjusts"],
        "kills": acc["kills"],
        "window_overflow": acc["window_overflow"],
        "rounds": acc["rounds"],
        "coalesced": acc["coalesced"],
        "truncated": (t_end < dur).to(f),
    }


def rounds_grids(fb: Optional[FBGrid], flb: Optional[FLBGrid],
                 fb_packed: Optional[PackedEventWorkloads],
                 flb_packed: Optional[PackedEventWorkloads], *,
                 fb_spec: Optional[RoundsSpec] = None,
                 flb_spec: Optional[RoundsSpec] = None,
                 devices=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Evaluate FB and FLB-NUB sweep grids through the event-round
    engine. Returns ``{"fb": metrics, "flb_nub": metrics}`` with ``(W,
    P_policy)`` metric tensors; a policy is skipped when its spec is
    ``None``. ``devices`` selects the backend as for
    ``scan.scan_grids``: ``None`` / one device runs every lane on the
    packs' device, two or more split the lanes across them through the
    shared ``scan.sharded_grid_map``, bit for bit the same rows.
    Fault-injected packs run on one device only, as in the reference."""
    devs = compat.resolve_devices(devices)
    if devs is not None and any(
            pk is not None and pk.fault_times is not None
            for pk in (fb_packed, flb_packed)):
        raise NotImplementedError(
            "fault-injected packs run single-device; the sharded lane "
            "splitter predates the optional fault tables")
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for policy, grid, packed, spec in (("fb", fb, fb_packed, fb_spec),
                                       ("flb_nub", flb, flb_packed,
                                        flb_spec)):
        if spec is None:
            continue
        W = int(packed.submit.shape[0])
        P = int(grid.lease.shape[0])
        if devs is not None:
            out[policy] = sharded_grid_map(
                functools.partial(_simulate_rounds, policy, spec=spec),
                _prm_tree(policy, grid), packed, W, P, devs)
            continue
        m = _simulate_rounds(policy, _lane_prm_tree(policy, grid, W),
                             packed, spec)
        out[policy] = {k: v.reshape(W, P) for k, v in m.items()}
    return out


def fb_rounds_row(jobs: Sequence[Job], ws_trace: Sequence[Tuple[float, int]],
                  capacity: int, lease_seconds: float, duration: float,
                  faults=None, kernel: Optional[str] = None,
                  batch: int = DEFAULT_BATCH, dtype=None,
                  device: compat.Device = None) -> Dict[str, float]:
    """One FB (capacity, lease) point through the rounds engine as a
    plain scalar row. With ``faults`` set, the schedule's stops fold
    into the horizon and the effective capacity becomes ``max(C -
    failed(t), 0)`` (see :func:`pack_event_workloads`); such a row runs
    the plain step (``RoundsSpec``)."""
    n_faults = len(faults) if faults is not None else 0
    spec = RoundsSpec(
        duration=float(duration),
        max_rounds=round_budget(len(jobs), len(list(ws_trace)),
                                float(duration), float(lease_seconds))
        + 8 * n_faults,   # each fault stop may kill + restart jobs
        window=FB_ROUNDS_WINDOW, kernel=kernel, batch=batch)
    pk = pack_event_workloads(
        [(jobs, ws_trace)], float(duration), spec.window, "fb",
        [float(lease_seconds)], [float(capacity)], dtype=dtype,
        faults=[faults] if faults is not None else None, device=device)
    f = pk.submit.dtype
    fb = FBGrid(capacity=torch.tensor([float(capacity)], dtype=f,
                                      device=pk.device),
                lease=torch.tensor([float(lease_seconds)], dtype=f,
                                   device=pk.device))
    out = rounds_grids(fb, None, pk, None, fb_spec=spec)["fb"]
    row = {k: float(v[0, 0]) for k, v in out.items()}
    for k in ("completed_jobs", "peak_nodes"):
        row[k] = int(round(row[k]))
    row["engine"] = "rounds"
    row["system"] = "fb"
    return row
