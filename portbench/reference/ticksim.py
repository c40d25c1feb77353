# Frozen copy of the tick dynamics of src/repro_torch/kernels/jaxsim_step.py
# (simulate_ref and first_fit), widened to a job table per lane: part of the
# benchmark's plain reference, which imports nothing of the program.
"""The §5.2 FLB-NUB tick simulator of the paper's §6.6.4 parameter
study, in plain PyTorch, every lane at once.

Time advances in substeps of ``dt = lease / substeps``. Each substep:
advance the running jobs (completion at ``remaining <= 0``, finish =
the substep's end), read the queue (demand, used, the biggest queued
job), at a lease tick grant the coordinated pool and apply §5.2's U / V /
G adjust, start queued jobs first-fit in arrival order, and account the
substep's allocation (the B pool, the leased nodes and the WS demand
beyond its lower bound).

Inputs: ``prm`` (L, 4) = B, U, V, G; ``submit``, ``size``, ``runtime``
(L, J), each lane's own job table (padding: submit ``inf``, size 0);
``ws`` (L, n_steps) each lane's WS demand a substep; all of one float
dtype. Outputs: each lane's completed jobs, average turnaround,
node-hours, peak nodes and adjust events."""

from __future__ import annotations

from typing import Dict

import torch

OUTPUTS = ("completed_jobs", "avg_turnaround", "node_hours", "peak_nodes",
           "adjust_events")


def first_fit(queued: torch.Tensor, size: torch.Tensor,
              free: torch.Tensor) -> torch.Tensor:
    """The starts of a sequential first-fit in table order, per lane:
    job i starts iff it is queued and ``size[i] <= fr``, and ``fr``
    drops by ``size[i]`` when it does. ``fr`` changes only at a start,
    so each pass finds the next start of every lane at once (the first
    queued job after the last start that fits)."""
    L, J = queued.shape
    idx = torch.arange(J, device=queued.device)
    starts = torch.zeros_like(queued)
    fr = free.clone()
    after = torch.full((L,), -1, dtype=torch.long, device=queued.device)
    while True:
        cand = queued & (size <= fr[:, None]) & (idx > after[:, None])
        lanes = cand.any(1).nonzero().squeeze(1)
        if lanes.numel() == 0:
            return starts
        j = cand[lanes].to(torch.uint8).argmax(1)
        starts[lanes, j] = True
        fr[lanes] = fr[lanes] - size[lanes, j]
        after[lanes] = j


def simulate(prm, submit, size, runtime, ws, *, n_steps: int,
             lease_seconds: float, lb_ws: float = 12.0,
             substeps: int = 12) -> Dict[str, torch.Tensor]:
    L, J = submit.shape
    dtype, dev = submit.dtype, submit.device
    B, U, V, G = prm.to(dtype).unbind(1)
    dt = torch.tensor(lease_seconds / substeps, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    owned = torch.clamp_min(B - lb_ws, 1.0)
    pool = owned.clone()
    remaining = runtime.clone()
    running = torch.zeros(L, J, dtype=torch.bool, device=dev)
    done = torch.zeros_like(running)
    finish = torch.zeros(L, J, dtype=dtype, device=dev)
    ts = (torch.arange(n_steps, dtype=dtype, device=dev) + 1.0) * dt
    pool_ws = torch.clamp_max(ws, float(lb_ws))
    ws_beyond = torch.clamp_min(ws - pool_ws, 0.0)
    alloc = torch.empty(n_steps, L, dtype=dtype, device=dev)
    events = torch.zeros(n_steps, L, dtype=dtype, device=dev)
    for s in range(n_steps):
        t = ts[s]
        remaining = torch.where(running, remaining - dt, remaining)
        completing = running & (remaining <= 0)
        finish = torch.where(completing, t, finish)
        done |= completing
        running &= ~completing
        queued = (submit <= t) & ~running & ~done
        qsize = torch.where(queued, size, zero)
        demand = qsize.sum(1)
        used = torch.where(running, size, zero).sum(1)
        if s % substeps == substeps - 1:
            grant = torch.clamp_min(B - pool_ws[:, s] - pool, 0.0)
            owned = owned + grant
            pool = pool + grant
            ratio = torch.where(owned > 0,
                                demand / torch.clamp_min(owned, 1.0),
                                torch.where(demand > 0, inf, zero))
            biggest = qsize.amax(1)
            free = owned - used
            req = torch.where(
                ratio > U, torch.clamp_min(demand - owned, 0.0),
                torch.where(biggest > owned,
                            torch.clamp_min(biggest - free, 0.0), zero))
            rss = torch.where((ratio < V) & (req == 0.0),
                              torch.floor(G * torch.clamp_min(free, 0.0)),
                              zero)
            owned = owned + req - rss
            pool = torch.minimum(pool, owned)
            events[s] = (req > 0).to(dtype) + (rss > 0).to(dtype)
        running |= first_fit(queued, size, owned - used)
        alloc[s] = B + torch.clamp_min(owned - pool, 0.0) + ws_beyond[:, s]
    n_done = done.sum(1)
    turnaround = torch.where(done, finish - submit, zero).double().sum(1)
    per_hour = torch.tensor(1.0 / 3600.0, dtype=dtype, device=dev)
    return {"completed_jobs": n_done,
            "avg_turnaround": turnaround.to(dtype)
            / torch.clamp_min(n_done, 1).to(dtype),
            "node_hours": alloc.double().sum(0).to(dtype)
            * (dt * per_hour),
            "peak_nodes": alloc.amax(0),
            "adjust_events": events.sum(0)}
