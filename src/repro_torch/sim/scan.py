"""The shared §5 policy-step helpers of the batched engines, in PyTorch.

Counterpart of the helper half of ``repro.sim.scan`` (its lines
145-432): the sweep-point grids, the job-table pack, the vectorized
first-fit, the power-of-two kill classes and the §5.1 kill selection,
one instant of each policy's rules (``fb_actions`` / ``flb_actions``)
and the stable window compaction. The event-rounds engine
(``repro_torch.sim.rounds``) drives them; the fixed-``dt`` scan engine
of the JAX package is not ported yet.

Lanes are a written-out leading axis instead of ``vmap``: every scalar
of the JAX helpers is an ``(N,)`` tensor here and every window an
``(N, K)`` tensor. The arithmetic is the reference's, op for op, so the
results are equal element for element: every sum the decisions read is
a sum of integer-valued floats, exact in any order.

Design notes of the encoding (status lanes, filtered-prefix first-fit,
kills as a size threshold) are in the reference module's docstring.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.compat import resolve_pack_dtype
from repro_torch.core.jobs import Job

__all__ = ["FBGrid", "FLBGrid", "pack_job_table", "resolve_pack_dtype",
           "fb_actions", "flb_actions", "stable_compact", "KILL_CLASSES"]

KILL_CLASSES = 16          # power-of-two size classes for the FB kill order


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


def _prm_tree(policy: str, grid) -> Dict[str, torch.Tensor]:
    if policy == "fb":
        return {"capacity": grid.capacity, "lease": grid.lease}
    return {"B": grid.B, "lb_ws": grid.lb_ws, "U": grid.U, "V": grid.V,
            "G": grid.G, "lease": grid.lease}


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
