# Frozen copy of the draws and transforms of src/repro_torch/sim/scenarios.py
# (lane_keys, the per-lane CPU draws, _pbj_from_draws, _ws_from_draws) and
# of its sample_workloads: part of the benchmark's plain reference, which
# imports nothing of the program.
"""One generated scenario lane, made again from its seed on the CPU.

The program synthesizes a ``ScenarioGrid``'s lanes on the card; this
module makes the same lane's job table and WS demand series from the
same seed and parameters with plain PyTorch on the CPU: each lane's
draws come from its own pair of CPU generators seeded from
``lane_keys``, and the transforms run op for op as the program's.
``dtype`` is the precision the transforms compute in (float32, as the
program; a lower one for the control)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference.jobs import Job

_ARR_BINS = 2048
_BURST_EPISODES = 32
_BURST_TAU = 180.0
_WS_SURGES = 12

PBJ_KEYS = ("nodes", "utilization", "n_jobs", "alpha", "sigma",
            "diurnal_depth", "weekend_factor", "burst_frac", "size_probs")
WS_KEYS = ("peak", "base_mean", "diurnal_amp", "noise_std", "surge_ratio",
           "surge_hours")


def lane_keys(seeds) -> np.ndarray:
    """Per-lane (pbj, ws) generator seeds, ``(W, 2)`` uint64."""
    return np.array([[np.random.SeedSequence([int(s), stream])
                      .generate_state(1, np.uint64)[0] >> np.uint64(1)
                      for stream in (0, 1)] for s in seeds],
                    np.uint64).reshape(-1, 2)


def _arrival_cdf(duration, depth, weekend_factor, f):
    t = (torch.arange(_ARR_BINS) + 0.5).to(f) * (duration / _ARR_BINS)
    phase = 2 * np.pi * ((t % 86400.0) / 86400.0 - 0.375)
    rate = torch.clamp_min(1.0 + depth[:, None] * torch.sin(phase)[None, :],
                           0.0)
    weekend = (torch.div(t, 86400.0, rounding_mode="floor")
               .to(torch.int32) % 7) >= 5
    rate = torch.where(weekend[None, :], rate * weekend_factor[:, None],
                       rate) + 1e-9
    cdf = torch.cumsum(rate.double(), dim=-1).to(f)
    return cdf / cdf[:, -1:]


def _inv_cdf(u, cdf, duration):
    idx = torch.clamp_max(torch.searchsorted(cdf, u.contiguous(),
                                             side="left"), _ARR_BINS - 1)
    prev = cdf.gather(1, torch.clamp_min(idx - 1, 0))
    lo = torch.where(idx > 0, prev, torch.zeros_like(prev))
    frac = torch.clamp((u - lo) / torch.clamp_min(cdf.gather(1, idx) - lo,
                                                  1e-12), 0.0, 1.0)
    return (idx.to(u.dtype) + frac) * (duration / _ARR_BINS)


def _pbj_draws(gen, size_probs, max_jobs) -> Dict[str, torch.Tensor]:
    kw = dict(generator=gen)
    return {
        "u_arrival": torch.rand(max_jobs, **kw),
        "u_center": torch.rand(_BURST_EPISODES, **kw),
        "episode": torch.randint(0, _BURST_EPISODES, (max_jobs,), **kw),
        "exponential": torch.empty(max_jobs).exponential_(generator=gen),
        "u_burst": torch.rand(max_jobs, **kw),
        "size_class": torch.multinomial(size_probs, max_jobs,
                                        replacement=True, generator=gen),
        "normal": torch.randn(max_jobs, **kw),
    }


def _uniform(gen, n, lo, hi):
    u = torch.rand(n, generator=gen)
    return torch.clamp_min(u * (hi - lo) + lo, lo)


def _ws_draws(gen, n_steps, step_seconds) -> Dict[str, torch.Tensor]:
    n_days = max(int(n_steps * step_seconds // 86400.0), 2)
    return {
        "normal": torch.randn(n_steps, generator=gen),
        "day": torch.randint(1, n_days, (_WS_SURGES,), generator=gen),
        "hour": _uniform(gen, _WS_SURGES, 12.0, 20.0),
        "length": _uniform(gen, _WS_SURGES, 0.6, 1.4),
        "amp": _uniform(gen, _WS_SURGES, 0.5, 1.0),
    }


def _pbj_from_draws(d, p, max_jobs, duration, f):
    d = {k: (v.to(f) if v.is_floating_point() else v) for k, v in d.items()}
    cdf = _arrival_cdf(duration, p["diurnal_depth"], p["weekend_factor"], f)
    base_t = _inv_cdf(d["u_arrival"], cdf, duration)
    centers = _inv_cdf(d["u_center"], cdf, duration)
    delay = _BURST_TAU * d["exponential"]
    burst = d["u_burst"] < p["burst_frac"][:, None]
    submit = torch.clamp(torch.where(
        burst, centers.gather(1, d["episode"].long()) + delay, base_t),
        0.0, duration - 1.0)
    size = torch.minimum(torch.pow(2.0, d["size_class"].to(f)),
                         p["nodes"][:, None])
    mu = p["alpha"][:, None] * torch.log(size) - p["sigma"][:, None] ** 2 / 2
    rt = torch.exp((mu + p["sigma"][:, None] * d["normal"]).double()).to(f)
    valid = torch.arange(max_jobs)[None, :] < p["n_jobs"][:, None]
    target = p["utilization"] * p["nodes"] * duration
    used = torch.where(valid, size * rt, torch.zeros_like(rt)).double() \
        .sum(dim=-1).to(f)
    rt = rt * (target / used)[:, None]
    rt = torch.clamp_min(rt, 1.0)
    submit = torch.where(valid, submit, torch.full_like(submit, np.inf))
    submit, order = torch.sort(submit, dim=-1, stable=True)
    zero = torch.zeros_like(rt)
    size = torch.where(valid, size, zero).gather(1, order).to(torch.int32)
    runtime = torch.where(valid, rt, zero).gather(1, order)
    return submit, size, runtime, p["n_jobs"].to(torch.int32)


def _ws_from_draws(d, p, n_steps, step_seconds, f):
    t = torch.arange(n_steps).to(f) * step_seconds
    day = (t % 86400.0) / 86400.0
    wave = torch.sin(2 * np.pi * (day - 0.3))
    base = p["base_mean"][:, None] * (1.0 + p["diurnal_amp"][:, None]
                                      * wave[None, :])
    base = base + p["noise_std"][:, None] * d["normal"].to(f)
    start = d["day"].to(f) * 86400.0 + 3600.0 * d["hour"].to(f)
    length = (3600.0 * p["surge_hours"])[:, None] * d["length"].to(f)
    amp = (p["surge_ratio"] * p["base_mean"])[:, None] * d["amp"].to(f)
    ramp = 0.22 * length
    rel = t[None, None, :] - start[:, :, None]
    up = torch.clamp(rel / ramp[:, :, None], 0.0, 1.0)
    down = torch.clamp((length[:, :, None] - rel) / ramp[:, :, None],
                       0.0, 1.0)
    surge = (amp[:, :, None] * torch.minimum(up, down)).double() \
        .sum(dim=1).to(f)
    demand = torch.clamp_min(base + surge, 1.0)
    demand = demand * (p["peak"] / demand.amax(dim=-1))[:, None]
    return torch.clamp_min(torch.round(demand), 1.0)


def lane_tables(seed: int, pbj: Dict, ws: Dict, *, duration: float,
                max_jobs: int, ws_step: float,
                dtype: torch.dtype = torch.float32) -> Dict[str, np.ndarray]:
    """One lane's job table and WS series from ``seed``: ``submit``,
    ``size``, ``runtime`` (``max_jobs`` rows, arrival-sorted, past
    ``n_jobs`` padded with +inf / 0 / 0), ``n_jobs``, ``ws_values`` on
    the grid ``ws_times`` (``ceil(duration / ws_step)`` steps)."""
    f = dtype
    n_steps = int(np.ceil(duration / ws_step))
    s_pbj, s_ws = lane_keys([seed])[0]
    probs = torch.tensor(np.asarray(pbj["size_probs"], np.float32))
    draws_p = _pbj_draws(torch.Generator().manual_seed(int(s_pbj)), probs,
                         max_jobs)
    draws_w = _ws_draws(torch.Generator().manual_seed(int(s_ws)), n_steps,
                        ws_step)
    pp = {k: torch.tensor([float(pbj[k])], dtype=torch.float32).to(f)
          for k in PBJ_KEYS if k != "size_probs"}
    wp = {k: torch.tensor([float(ws[k])], dtype=torch.float32).to(f)
          for k in WS_KEYS}
    submit, size, runtime, n_jobs = _pbj_from_draws(
        {k: v[None] for k, v in draws_p.items()}, pp, max_jobs,
        float(duration), f)
    ws_values = _ws_from_draws({k: v[None] for k, v in draws_w.items()},
                               wp, n_steps, float(ws_step), f)
    return dict(submit=submit[0].float().numpy(),
                size=size[0].numpy(),
                runtime=runtime[0].float().numpy(),
                n_jobs=int(n_jobs[0]),
                ws_times=np.arange(n_steps, dtype=np.float64) * ws_step,
                ws_values=ws_values[0].float().numpy())


def lane_workload(tables: Dict[str, np.ndarray]
                  ) -> Tuple[List[Job], List[Tuple[float, int]]]:
    """A lane's tables as the event engine's ``(jobs, ws_trace)``."""
    n = int(tables["n_jobs"])
    jobs = [Job(jid=i, submit=float(tables["submit"][i]),
                size=int(tables["size"][i]),
                runtime=float(tables["runtime"][i])) for i in range(n)]
    vals = tables["ws_values"]
    trace: List[Tuple[float, int]] = [(0.0, int(vals[0]))]
    for i in range(1, len(vals)):
        d = int(vals[i])
        if d != trace[-1][1]:
            trace.append((float(tables["ws_times"][i]), d))
    return jobs, trace
