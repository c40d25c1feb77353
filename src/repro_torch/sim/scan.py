"""The fixed-``dt`` scan engine and the §5 policy-step helpers, in PyTorch.

Counterpart of ``repro.sim.scan``. Two halves:

* the shared policy-step helpers (the reference's lines 145-432): the
  sweep-point grids, the job-table pack, the vectorized first-fit, the
  power-of-two kill classes and the §5.1 kill selection, one instant of
  each policy's rules (``fb_actions`` / ``flb_actions``) and the stable
  window compaction. The event-rounds engine (``repro_torch.sim.rounds``)
  drives them too;
* the engine (``mode="scan"`` of the sweep): ``pack_workloads`` samples
  each workload's WS demand on a fixed substep grid, and
  :func:`scan_grids` advances every (trace × point) lane one substep at a
  time, the policy actions firing on lease boundaries, with the job
  window re-gathered once per chunk of substeps.

Lanes are a written-out leading axis instead of ``vmap``: every scalar
of the JAX helpers is an ``(N,)`` tensor here and every window an
``(N, K)`` tensor; the (trace × point) grid flattens to lane ``w·P + p``.
The reference's two nested scans (over chunks, then over a chunk's
substeps) become two Python loops that step every lane at once, with no
host synchronisation inside them. The arithmetic is the reference's, op
for op, so the decisions are equal element for element: every sum they
read is a sum of integer-valued floats, exact in any order. Only the
time integrals (turnaround, execution, node-seconds) sum in another
order.

Design notes of the encoding (status lanes, filtered-prefix first-fit,
kills as a size threshold, substep discretization) are in the reference
module's docstring.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch.compat import resolve_pack_dtype
from repro_torch.core.jobs import Job
from repro_torch.core.profiles import sample_steps, step_points

__all__ = ["FBGrid", "FLBGrid", "PackedWorkloads", "ScanSpec",
           "pack_workloads", "pack_job_table", "resolve_pack_dtype",
           "scan_grids", "sharded_grid_map", "pick_dt", "fb_actions", "flb_actions",
           "stable_compact", "compact_window", "KILL_CLASSES",
           "DEFAULT_WINDOW", "DEFAULT_SUBSTEPS", "DEFAULT_FF_PASSES",
           "FB_DT", "FLB_DT", "FLB_MIN_DT"]

# The reference's settings (see ``repro.sim.scan`` for how each was chosen).
DEFAULT_WINDOW = 192       # job-table lanes carried through the scan
FB_WINDOW = 192            # FB's backlog is capacity-bound
FLB_WINDOW = 128           # FLB-NUB leases elastically: a small backlog
DEFAULT_SUBSTEPS = 12      # substeps per chunk (one window re-gather)
DEFAULT_FF_PASSES = 2      # filtered-prefix first-fit passes per substep
FB_DT = 900.0              # FB's substep: alloc ≈ C between WS moves
FLB_DT = 300.0             # FLB-NUB's: the U/V/G feedback samples demand
FLB_MIN_DT = 60.0          # floor of the WS-spacing cap in pick_dt
KILL_CLASSES = 16          # power-of-two size classes for the FB kill order


@dataclasses.dataclass(frozen=True)
class ScanSpec:
    """Execution parameters of one policy's scan: the substep ``dt``, the
    horizon in substeps, the job-window size, the substeps per chunk
    (the window re-gather cadence) and the first-fit passes."""

    n_steps: int
    dt: float
    window: int = DEFAULT_WINDOW
    chunk_len: int = DEFAULT_SUBSTEPS
    ff_passes: int = DEFAULT_FF_PASSES


@dataclasses.dataclass(frozen=True)
class FBGrid:
    """FB sweep points (§5.1): per-point capacity C and lease unit L."""

    capacity: torch.Tensor    # (P,)
    lease: torch.Tensor       # (P,)


@dataclasses.dataclass(frozen=True)
class FLBGrid:
    """FLB-NUB sweep points (§5.2): B, lb_ws, U, V, G and lease L."""

    B: torch.Tensor           # (P,)
    lb_ws: torch.Tensor       # (P,)
    U: torch.Tensor           # (P,)
    V: torch.Tensor           # (P,)
    G: torch.Tensor           # (P,)
    lease: torch.Tensor       # (P,)


@dataclasses.dataclass(frozen=True)
class PackedWorkloads:
    """Fixed-size tensors for W workloads: arrival-sorted job tables
    padded to a common length (padding rows have ``submit = +inf``, size
    0) plus the per-substep WS demand profile and per-chunk submit
    frontiers."""

    submit: torch.Tensor      # (W, J + K) — padded past the table end too
    size: torch.Tensor        # (W, J + K)
    runtime: torch.Tensor     # (W, J + K)
    ws: torch.Tensor          # (W, S) demand sampled at each substep END
    ws0: torch.Tensor         # (W,) demand at t = 0 (startup allocation)
    ws_changed: torch.Tensor  # (W, S) bool: demand differs from prev substep
    hi_chunk: torch.Tensor    # (W, n_chunks) jobs submitted by chunk end
    n_jobs: torch.Tensor      # (W,) real (unpadded) job counts

    @property
    def device(self) -> torch.device:
        return self.submit.device


def _prm_tree(policy: str, grid) -> Dict[str, torch.Tensor]:
    if policy == "fb":
        return {"capacity": grid.capacity, "lease": grid.lease}
    return {"B": grid.B, "lb_ws": grid.lb_ws, "U": grid.U, "V": grid.V,
            "G": grid.G, "lease": grid.lease}


def _lane_prm_tree(policy: str, grid, n_workloads: int
                   ) -> Dict[str, torch.Tensor]:
    """The grid's per-point scalars broadcast over the flattened
    (trace × point) lanes, lane ``w·P + p``, with each lane's workload
    row ``w_idx`` and point index ``p_idx``."""
    P = int(grid.lease.shape[0])
    dev = grid.lease.device
    p_idx = torch.arange(P, device=dev).repeat(n_workloads)
    w_idx = torch.arange(n_workloads, device=dev).repeat_interleave(P)
    prm = {k: v[p_idx] for k, v in _prm_tree(policy, grid).items()}
    prm["p_idx"] = p_idx
    prm["w_idx"] = w_idx
    return prm


def pack_job_table(workloads: Sequence[Tuple[Sequence[Job],
                                             Sequence[Tuple[float, int]]]],
                   window: int, dtype: np.dtype
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]:
    """Arrival-sorted job tables padded to a common length plus a full
    window of trailing padding rows (``submit = +inf``, size 0) so the
    window can slide past the table end. Returns ``(submit, size,
    runtime, n_jobs)`` as numpy arrays of shape ``(W, max_jobs +
    window)`` / ``(W,)``.
    """
    max_jobs = max(len(jobs) for jobs, _ in workloads)
    J = max_jobs + window                      # window can slide past the end
    submit = np.full((len(workloads), J), np.inf, dtype)
    size = np.zeros((len(workloads), J), dtype)
    runtime = np.zeros((len(workloads), J), dtype)
    n_jobs = np.zeros(len(workloads), np.int32)
    for w, (jobs, _) in enumerate(workloads):
        order = sorted(jobs, key=lambda j: j.submit)
        n_jobs[w] = len(order)
        submit[w, :len(order)] = [j.submit for j in order]
        size[w, :len(order)] = [j.size for j in order]
        runtime[w, :len(order)] = [j.runtime for j in order]
    return submit, size, runtime, n_jobs


def pack_workloads(workloads: Sequence[Tuple[Sequence[Job],
                                             Sequence[Tuple[float, int]]]],
                   duration: float, dt: float,
                   window: int = DEFAULT_WINDOW,
                   chunk_len: int = DEFAULT_SUBSTEPS,
                   dtype=None, device: compat.Device = None
                   ) -> Tuple[PackedWorkloads, int]:
    """Pack ``(jobs, ws_trace)`` workloads into stacked scan tensors on
    ``device``. Returns ``(packed, n_steps)`` where ``n_steps =
    ceil(duration / dt)`` (the scan runs ``n_chunks * chunk_len >=
    n_steps`` substeps; the overhang is masked out). ``dtype`` defaults
    to float32."""
    dev = compat.resolve_device(device)
    dtype = resolve_pack_dtype(dtype)
    n_steps = int(np.ceil(duration / dt))
    n_chunks = -(-n_steps // chunk_len)
    s_pad = n_chunks * chunk_len
    submit, size, runtime, n_jobs = pack_job_table(workloads, window, dtype)
    ws = np.zeros((len(workloads), s_pad), dtype)
    ws0 = np.zeros(len(workloads), dtype)
    hi_chunk = np.zeros((len(workloads), n_chunks), np.int32)
    for w, (jobs, ws_trace) in enumerate(workloads):
        times, values = step_points(ws_trace, duration)
        prof = sample_steps(times, values, np.arange(1, n_steps + 1) * dt)
        ws[w, :n_steps] = prof.astype(dtype)
        ws0[w] = values[0]
        chunk_end_t = (np.arange(1, n_chunks + 1) * chunk_len) * dt
        hi_chunk[w] = np.searchsorted(submit[w, :n_jobs[w]], chunk_end_t,
                                      side="right")
    ws_changed = np.zeros(ws.shape, bool)
    ws_changed[:, 1:] = ws[:, 1:] != ws[:, :-1]
    ws_changed[:, 0] = ws[:, 0] != ws0
    arrays = dict(submit=submit, size=size, runtime=runtime, ws=ws, ws0=ws0,
                  ws_changed=ws_changed, hi_chunk=hi_chunk, n_jobs=n_jobs)
    return PackedWorkloads(**{k: torch.from_numpy(v).to(dev)
                              for k, v in arrays.items()}), n_steps


# ---------------------------------------------------------- scan primitives

def _first_fit(free, queued, size, passes: int):
    """Vectorized §6.5.2 first-fit: ``passes`` filtered-prefix rounds
    over ``(N, K)`` windows with ``(N,)`` free capacity. Each round
    admits every candidate whose exclusive prefix sum of candidate sizes
    still fits, so the admitted set never overcommits and the earliest
    schedulable job always starts."""
    started = torch.zeros_like(queued)
    zero = torch.zeros_like(size)
    for _ in range(passes):
        cand = queued & ~started & (size <= free[:, None])
        sz = torch.where(cand, size, zero)
        prefix = torch.cumsum(sz, dim=-1) - sz
        start = cand & (prefix + size <= free[:, None])
        free = free - torch.where(start, size, zero).sum(dim=-1)
        started = started | start
    return free, started


def _size_classes(size):
    """Power-of-two size classes encoding the §5.1 kill priority (small
    first): ``(cls (N, K), class_masks (N, KILL_CLASSES, K))``."""
    cls = torch.clamp(torch.ceil(torch.log2(torch.clamp_min(size, 1.0))),
                      0, KILL_CLASSES - 1).to(torch.int32)
    classes = torch.arange(KILL_CLASSES, device=size.device,
                           dtype=torch.int32)
    class_masks = cls[:, None, :] == classes[None, :, None]
    return cls, class_masks


def _kill_selection(running, size, cls, class_masks, kill_need):
    """§5.1 rule 2 kill set: smallest size class first, newest-arrival
    first inside the threshold class, until ``kill_need`` nodes free."""
    zero = torch.zeros_like(size)
    run_sz = torch.where(running, size, zero)
    class_sum = torch.where(class_masks, run_sz[:, None, :],
                            zero[:, None, :]).sum(dim=-1)     # (N, classes)
    below = torch.cat([torch.zeros_like(class_sum[:, :1]),
                       torch.cumsum(class_sum, dim=-1)[:, :-1]], dim=-1)
    # Threshold class: first class whose cumulative sum covers the need
    # (argmax of a 0/1 row is its first 1; all-zero → 0, need == 0).
    covered = below + class_sum >= kill_need[:, None]
    thresh = torch.argmax(covered.to(torch.int32), dim=-1)     # (N,)
    kill_all = running & (cls < thresh[:, None])
    below_thr = below.gather(1, thresh[:, None])[:, 0]
    rem_need = torch.clamp_min(kill_need - below_thr, 0.0)
    in_thr = running & (cls == thresh[:, None])
    thr_sz = torch.where(in_thr, size, zero)
    rev_prefix = torch.flip(torch.cumsum(torch.flip(thr_sz, [-1]), dim=-1),
                            [-1]) - thr_sz
    kill_thr = in_thr & (rev_prefix < rem_need[:, None])
    return (kill_all | kill_thr) & (kill_need > 0)[:, None]


# ------------------------------------------------ shared policy-step helpers

def fb_actions(C, owned, run, used, queued, wsv, w_sz, w_cls, w_cls_masks,
               is_tick, ff_passes: int):
    """§5.1 rules 2–4 at one instant: WS reclaim (killing smallest-first
    when idle nodes don't cover the demand rise), the on-tick grant of
    all idle resources to the PBJ TRE, and the arrival-order first-fit.

    Returns ``(owned, run, starts, killed, alloc, pbj_ev)``; ``run`` in
    the result excludes ``killed`` and includes ``starts``.
    """
    zero = torch.zeros_like(w_sz)
    ws_t = torch.minimum(wsv, C)
    need = torch.clamp_min(owned - (C - ws_t), 0.0)
    free = owned - used
    kill_need = torch.minimum(torch.clamp_min(need - free, 0.0), used)
    killed = _kill_selection(run, w_sz, w_cls, w_cls_masks, kill_need)
    run = run & ~killed          # killed lanes re-queue derived
    used = used - torch.where(killed, w_sz, zero).sum(dim=-1)
    owned = owned - need
    idle = torch.clamp_min(C - ws_t - owned, 0.0)
    grant = torch.where(is_tick, idle, torch.zeros_like(idle))
    owned = owned + grant
    f = w_sz.dtype
    pbj_ev = (grant > 0).to(f) + (need > 0).to(f)
    alloc = owned + ws_t
    free = owned - used
    _, starts = _first_fit(free, queued, w_sz, ff_passes)
    run = run | starts
    return owned, run, starts, killed, alloc, pbj_ev


def flb_actions(B, lb_ws, U, V, G, owned, pool_pbj, run, used, queued,
                wsv, w_sz, is_tick, ff_passes: int):
    """§5.2 rules 2–4 at one instant, in the event engine's tick order:
    pool grant → first-fit → U/V/G adjust on *post-start* demand and
    free → second first-fit on the request grant.

    Returns ``(owned, pool_pbj, run, starts, alloc, pbj_ev)`` where
    ``starts`` is the union of both first-fit passes.
    """
    zero = torch.zeros_like(w_sz)
    zs = torch.zeros_like(owned)
    pool_ws = torch.minimum(wsv, lb_ws)
    pool_idle = torch.clamp_min(B - pool_ws - pool_pbj, 0.0)
    grant = torch.where(is_tick, pool_idle, zs)
    owned = owned + grant
    pool_pbj = pool_pbj + grant
    free = owned - used
    _, starts = _first_fit(free, queued, w_sz, ff_passes)
    run = run | starts
    queued = queued & ~starts
    used = used + torch.where(starts, w_sz, zero).sum(dim=-1)
    demand = torch.where(queued, w_sz, zero).sum(dim=-1)
    ratio = torch.where(owned > 0, demand / torch.clamp_min(owned, 1.0),
                        torch.where(demand > 0, torch.full_like(zs, np.inf),
                                    zs))
    biggest = torch.where(queued, w_sz, zero).amax(dim=-1)
    free = owned - used
    dr1 = torch.clamp_min(demand - owned, 0.0)
    dr2 = torch.clamp_min(biggest - free, 0.0)
    req = torch.where(is_tick & (ratio > U), dr1,
                      torch.where(is_tick & (biggest > owned), dr2, zs))
    rss = torch.where(is_tick & (ratio < V) & (req == 0.0),
                      torch.floor(G * torch.clamp_min(free, 0.0)), zs)
    owned = owned + req - rss
    pool_pbj = torch.minimum(pool_pbj, owned)     # leased released first
    f = w_sz.dtype
    pbj_ev = (req > 0).to(f) + (rss > 0).to(f)
    alloc = B + torch.clamp_min(owned - pool_pbj, 0.0) \
        + torch.clamp_min(wsv - lb_ws, 0.0)
    free = owned - used
    _, starts2 = _first_fit(free, queued, w_sz, ff_passes)
    run = run | starts2
    return owned, pool_pbj, run, starts | starts2, alloc, pbj_ev


def stable_compact(keep, arrays: List[torch.Tensor], fills):
    """Stable partition of ``(N, K)`` windows: kept lanes move to the
    head in lane order, the tail reads ``fills``. One stacked gather
    moves every array at once; arrays are cast through the float dtype
    of the first float array (lane payloads are flags, times and small
    ints — all exact in it). Returns ``(compacted_arrays, n_keep)`` with
    ``n_keep`` of shape ``(N,)``."""
    N, K = keep.shape
    f = next((a.dtype for a in arrays if a.is_floating_point()),
             arrays[0].dtype)
    cs = torch.cumsum(keep.to(torch.int32), dim=-1).to(torch.int32)
    n_keep = cs[:, -1]
    # src[i] = index of the (i+1)-th kept lane (left searchsorted over
    # the monotone keep-prefix), valid for lanes < n_keep.
    want = (torch.arange(K, device=keep.device, dtype=torch.int32) + 1
            ).expand(N, K).contiguous()
    src = torch.clamp_max(torch.searchsorted(cs, want, side="left"), K - 1)
    valid = torch.arange(K, device=keep.device)[None, :] < n_keep[:, None]
    stacked = torch.stack([a.to(f) for a in arrays], dim=1)   # (N, A, K)
    moved = stacked.gather(2, src[:, None, :].expand_as(stacked))
    fill_col = torch.tensor([float(x) for x in fills], dtype=f,
                            device=keep.device)[None, :, None]
    out = torch.where(valid[:, None, :], moved, fill_col)
    return [out[:, i].to(a.dtype) if a.dtype != torch.bool else out[:, i] != 0
            for i, a in enumerate(arrays)], n_keep


def compact_window(keep, jidx, next_row, Jp: int, fields):
    """Compact kept lanes to the window head (stable, so lane order
    stays arrival order) and admit the next job-table rows into the
    freed tail, for ``(N, K)`` windows. ``fields`` is a sequence of
    ``(tensor, fill)`` pairs compacted alongside ``jidx`` (int32 rows);
    admitted lanes read ``fill`` until their table row is gathered.
    ``next_row`` is ``(N,)`` int32. Returns ``(jidx, next_row,
    compacted)``."""
    K = jidx.shape[-1]
    lanes = torch.arange(K, dtype=torch.int32, device=jidx.device)
    arrays, n_keep = stable_compact(
        keep, [jidx] + [a for a, _ in fields],
        [0] + [fill for _, fill in fields])
    fresh = torch.clamp_max(next_row[:, None] + lanes[None, :]
                            - n_keep[:, None], Jp - 1)
    jidx = torch.where(lanes[None, :] >= n_keep[:, None], fresh, arrays[0])
    next_row = torch.clamp_max(next_row + (K - n_keep), Jp - 1)
    return jidx.to(torch.int32), next_row.to(torch.int32), arrays[1:]


# ------------------------------------------------------------- the scan core

_ACC_KEYS = ("completed", "turn_sum", "exec_sum", "kills", "node_seconds",
             "peak", "pbj_adjusts", "adjusts", "window_overflow")


def _lane_ctx(policy: str, prm: Dict, pk: PackedWorkloads) -> Dict:
    """Each lane's workload tables (gathered by ``w_idx``) and policy
    scalars, cast to the pack dtype."""
    f = pk.submit.dtype
    w = prm["w_idx"]
    ctx = {"L": prm["lease"].to(f), "tr_submit": pk.submit[w],
           "tr_size": pk.size[w], "tr_runtime": pk.runtime[w],
           "tr_ws": pk.ws[w], "tr_ws0": pk.ws0[w],
           "tr_ws_changed": pk.ws_changed[w], "tr_hi": pk.hi_chunk[w]}
    keys = ("capacity",) if policy == "fb" else ("B", "lb_ws", "U", "V", "G")
    for k in keys:
        ctx[k] = prm[k].to(f)
    return ctx


def _startup(policy: str, ctx: Dict, spec: ScanSpec):
    """The loop state at t = 0 for every lane: ``(jidx, next_row, owned,
    pool_pbj, run, rem, start_t, acc)``."""
    sub = ctx["tr_submit"]
    N, K = sub.shape[0], spec.window
    f, dev = sub.dtype, sub.device
    ws0 = ctx["tr_ws0"]
    if policy == "fb":
        C = ctx["capacity"]
        owned0 = C - torch.minimum(ws0, C)     # startup: all idle → PBJ
        pool0 = torch.zeros(N, dtype=f, device=dev)
    else:
        owned0 = torch.clamp_min(ctx["B"] - ctx["lb_ws"], 1.0)   # §5.2
        pool0 = owned0
    acc = {k: torch.zeros(N, dtype=f, device=dev) for k in _ACC_KEYS}
    acc["adjusts"] = (ws0 > 0).to(f)       # startup WS allocation event
    jidx = torch.arange(K, dtype=torch.int32, device=dev).expand(N, K)
    return (jidx.contiguous(), torch.full((N,), K, dtype=torch.int32,
                                          device=dev),
            owned0, pool0, torch.zeros(N, K, dtype=torch.bool, device=dev),
            torch.zeros(N, K, dtype=f, device=dev),
            torch.zeros(N, K, dtype=f, device=dev), acc)


def _substep(policy: str, ctx: Dict, spec: ScanSpec, window, state, s_idx,
             wsv, ws_chg):
    """One substep of every lane: advance → complete → the policy's
    actions → the lazy runtime read on start → accounting, the
    reference's order. ``window`` is the chunk's ``(w_sub, w_sz, w_rt,
    cls, class_masks)``; ``state`` is ``(owned, pool_pbj, run, done,
    rem, start_t, acc)``; ``s_idx`` a 0-dim tensor of the pack dtype,
    ``wsv`` / ``ws_chg`` the lanes' (N,) demand and change flag."""
    w_sub, w_sz, w_rt, w_cls, w_masks = window
    owned, pool_pbj, run, done, rem, start_t, acc = state
    acc = dict(acc)
    dt, f = spec.dt, w_sz.dtype
    zero = torch.zeros_like(w_sz)
    L = ctx["L"]
    t = (s_idx + 1.0) * dt
    active = s_idx < spec.n_steps
    is_tick = active & (torch.floor(t / L) > torch.floor(s_idx * dt / L))

    # 1. Advance running jobs one substep; fold completions into the
    # accumulators the moment they happen.
    rem = torch.where(run & active, rem - dt, rem)
    completing = run & (rem <= 0.5 * dt) & active
    run = run & ~completing
    done = done | completing
    acc["completed"] = acc["completed"] + completing.to(f).sum(dim=-1)
    acc["turn_sum"] = acc["turn_sum"] + torch.where(
        completing, t - w_sub, zero).sum(dim=-1)
    acc["exec_sum"] = acc["exec_sum"] + torch.where(
        completing, t - start_t, zero).sum(dim=-1)

    queued = active & (w_sub <= t) & ~run & ~done
    used = torch.where(run, w_sz, zero).sum(dim=-1)

    if policy == "fb":
        # 2-4. §5.1 WS reclaim (kills) → tick grant → first-fit.
        owned, run, starts, killed, alloc, pbj_ev = fb_actions(
            ctx["capacity"], owned, run, used, queued, wsv, w_sz, w_cls,
            w_masks, is_tick, spec.ff_passes)
        acc["kills"] = acc["kills"] + killed.to(f).sum(dim=-1)
    else:
        # 2-4. §5.2 pool grant → first-fit → U/V/G on post-start state
        # → first-fit.
        owned, pool_pbj, run, starts, alloc, pbj_ev = flb_actions(
            ctx["B"], ctx["lb_ws"], ctx["U"], ctx["V"], ctx["G"], owned,
            pool_pbj, run, used, queued, wsv, w_sz, is_tick, spec.ff_passes)
    rem = torch.where(starts, w_rt, rem)       # runtime read on start —
    start_t = torch.where(starts, t, start_t)  # kills reset lazily

    # 5. Accounting (§6.1 metrics).
    zs = torch.zeros_like(alloc)
    alloc = torch.where(active, alloc, zs)
    acc["node_seconds"] = acc["node_seconds"] + alloc * dt
    acc["peak"] = torch.maximum(acc["peak"], alloc)
    acc["pbj_adjusts"] = acc["pbj_adjusts"] + torch.where(active, pbj_ev, zs)
    acc["adjusts"] = acc["adjusts"] + torch.where(
        active, pbj_ev + ws_chg.to(f), zs)
    return owned, pool_pbj, run, done, rem, start_t, acc


def _gather_window(ctx: Dict, jidx):
    """The window's job rows ``tr[jidx]`` per lane (``jidx`` clamped to
    the table, as a JAX gather clamps) and their kill size classes."""
    Jp = ctx["tr_submit"].shape[1]
    rows = torch.clamp(jidx.long(), 0, Jp - 1)
    w_sz = ctx["tr_size"].gather(1, rows)
    return (ctx["tr_submit"].gather(1, rows), w_sz,
            ctx["tr_runtime"].gather(1, rows), *_size_classes(w_sz))


def _simulate(policy: str, prm: Dict, pk: PackedWorkloads,
              spec: ScanSpec) -> Dict[str, torch.Tensor]:
    """Every (point, workload) lane of ``prm`` at once (``prm`` holds one
    entry per lane: the policy scalars, ``w_idx`` and ``p_idx``). The
    reference's scan over chunks and its inner scan over a chunk's
    substeps are two Python loops; each substep steps every lane."""
    ctx = _lane_ctx(policy, prm, pk)
    chunk_len = spec.chunk_len
    n_chunks = ctx["tr_ws"].shape[1] // chunk_len
    Jp = ctx["tr_submit"].shape[1]   # includes >= K pad rows (submit = +inf)
    f, dev = pk.submit.dtype, pk.device
    (jidx, next_row, owned, pool_pbj, run, rem, start_t,
     acc) = _startup(policy, ctx, spec)
    # Every substep index as a device scalar of the pack dtype (indexing
    # this tensor needs no host-to-device copy inside the loop).
    s_all = torch.arange(n_chunks * chunk_len, device=dev).to(f)
    tr_ws, tr_chg = ctx["tr_ws"], ctx["tr_ws_changed"]
    for c in range(n_chunks):
        window = _gather_window(ctx, jidx)
        done = torch.zeros_like(run)
        state = (owned, pool_pbj, run, done, rem, start_t, acc)
        for s in range(c * chunk_len, (c + 1) * chunk_len):
            state = _substep(policy, ctx, spec, window, state, s_all[s],
                             tr_ws[:, s], tr_chg[:, s])
        owned, pool_pbj, run, done, rem, start_t, acc = state
        # Compact finished lanes out of the window and admit the next
        # job-table rows into the freed tail (ahead of their submit
        # time, so mid-chunk arrivals are already on a lane).
        jidx, next_row, (run, rem, start_t) = compact_window(
            ~done, jidx, next_row, Jp,
            ((run, False), (rem, 0.0), (start_t, 0.0)))
        acc = dict(acc, window_overflow=acc["window_overflow"]
                   + (ctx["tr_hi"][:, c] > next_row).to(f))
    n_done = torch.clamp_min(acc["completed"], 1.0)
    return {
        "completed_jobs": acc["completed"],
        "avg_turnaround": acc["turn_sum"] / n_done,
        "avg_execution": acc["exec_sum"] / n_done,
        "node_hours": acc["node_seconds"] / 3600.0,
        "peak_nodes": acc["peak"],
        "adjust_events": acc["adjusts"],
        "pbj_adjust_events": acc["pbj_adjusts"],
        "kills": acc["kills"],
        "window_overflow": acc["window_overflow"],
    }


def _gather_pack(pk, rows: torch.Tensor, device: torch.device):
    """The pack of the lanes ``rows``: each tensor field's rows
    ``field[rows]``, on ``device`` (fields that are ``None`` stay so)."""
    return dataclasses.replace(pk, **{
        f.name: getattr(pk, f.name)[rows].to(device)
        for f in dataclasses.fields(pk)
        if getattr(pk, f.name) is not None})


def _run_shards(jobs) -> List:
    """Runs ``jobs`` (``(device, fn)`` pairs) and returns their results
    in order. Every shard is launched before any result is read back:
    one host thread per distinct device, each running its own shards in
    turn (a device named twice queues its second shard behind its
    first), so distinct cards overlap while the engines read results on
    the host as they go."""
    by_dev: Dict[torch.device, List[int]] = {}
    for i, (dev, _) in enumerate(jobs):
        by_dev.setdefault(dev, []).append(i)
    out: List = [None] * len(jobs)
    errors: List[BaseException] = []

    def work(dev, idx):
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            for i in idx:
                out[i] = jobs[i][1]()
        except BaseException as e:      # re-raised on the caller's thread
            errors.append(e)

    if len(by_dev) == 1:
        work(*next(iter(by_dev.items())))
    else:
        threads = [threading.Thread(target=work, args=item)
                   for item in by_dev.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return out


def sharded_grid_map(lane_fn, prm_tree: Dict[str, torch.Tensor], packed,
                     n_workloads: int, n_points: int,
                     devices: Sequence[torch.device]
                     ) -> Dict[str, torch.Tensor]:
    """The counterpart of ``repro.sim.scan.sharded_grid_map``: runs
    ``lane_fn(prm, pack) -> metrics`` over the flattened (trace × point)
    lanes split across ``devices`` and reshapes the metrics to ``(W,
    P)``, on the host.

    The lanes (lane ``w·P + p``) are padded with copies of lane 0 to a
    multiple of the device count and cut into one contiguous shard per
    device. Each shard gets its own pack, the workload rows its lanes
    read (gathered by ``w_idx``), and its own parameter tree (gathered
    by ``p_idx``), and runs the same per-lane program as the
    single-device path on its device. There is no collective: the lanes
    are independent, so every row equals the single-device row bit for
    bit. The pad is dropped before the metrics are reshaped."""
    d = len(devices)
    w, p = n_workloads, n_points
    n = w * p
    pad = -n % d
    src = packed.submit.device
    w_idx = torch.cat([torch.arange(w).repeat_interleave(p),
                       torch.zeros(pad, dtype=torch.long)])
    p_idx = torch.cat([torch.arange(p).repeat(w),
                       torch.zeros(pad, dtype=torch.long)])
    per = (n + pad) // d

    def shard(i: int):
        dev = devices[i]
        wl = w_idx[i * per:(i + 1) * per]
        pl = p_idx[i * per:(i + 1) * per].to(dev)
        prm = {k: v[pl.to(v.device)].to(dev) for k, v in prm_tree.items()}
        prm["p_idx"] = pl
        prm["w_idx"] = torch.arange(per, device=dev)
        pk = _gather_pack(packed, wl.to(src), dev)
        return lambda: {k: v.cpu() for k, v in lane_fn(prm, pk).items()}

    parts = _run_shards([(devices[i], shard(i)) for i in range(d)])
    return {k: torch.cat([m[k] for m in parts])[:n].reshape(w, p)
            for k in parts[0]}


def scan_grids(fb: Optional[FBGrid], flb: Optional[FLBGrid],
               fb_packed: Optional[PackedWorkloads],
               flb_packed: Optional[PackedWorkloads], *,
               fb_spec: Optional[ScanSpec] = None,
               flb_spec: Optional[ScanSpec] = None,
               devices=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Evaluate FB and FLB-NUB sweep grids over all packed workloads.
    Returns ``{"fb": metrics, "flb_nub": metrics}`` where each metric
    tensor has shape ``(W, P_policy)``; a policy is skipped when its spec
    is ``None``. Each policy runs at its own :class:`ScanSpec`.

    ``devices`` (``compat.resolve_devices``): ``None`` / one device runs
    every lane on the device the packs live on; two or more split the
    flattened (trace × point) lanes across them
    (:func:`sharded_grid_map`), with rows equal bit for bit and the
    metrics on the host."""
    devs = compat.resolve_devices(devices)
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
                functools.partial(_simulate, policy, spec=spec),
                _prm_tree(policy, grid), packed, W, P, devs)
            continue
        m = _simulate(policy, _lane_prm_tree(policy, grid, W), packed, spec)
        out[policy] = {k: v.reshape(W, P) for k, v in m.items()}
    return out


def pick_dt(policy: str, leases: Sequence[float],
            ws_traces: Optional[Sequence[Sequence[Tuple[float, int]]]] = None,
            duration: Optional[float] = None) -> float:
    """Default substep for a policy's grid: the validated granularity
    (``FB_DT`` / ``FLB_DT``), never coarser than the shortest lease in
    the grid. For FLB-NUB the substep is also capped by the shortest WS
    change-point spacing across ``ws_traces`` before ``duration``
    (floored at ``FLB_MIN_DT``), so the sampled demand does not alias
    the U/V/G feedback."""
    base = FB_DT if policy == "fb" else FLB_DT
    dt = min(base, min(leases))
    if policy == "flb_nub" and ws_traces:
        horizon = duration if duration is not None else np.inf
        spacing = min((b - a for trace in ws_traces
                       for (a, _), (b, _) in zip(trace, trace[1:])
                       if b > a and a < horizon), default=dt)
        dt = min(dt, max(spacing, FLB_MIN_DT))
    return dt
