"""Generated scenario batches: generator families for PBJ job tables and
WS demand series, parameterized far beyond the three paper traces, in
PyTorch.

Counterpart of ``repro.sim.scenarios``:

* :func:`synth_pbj` — parallel-batch-job tables (bursty diurnal
  arrivals, power-of-two size classes, heavy-tailed lognormal runtimes,
  exact-utilization rescale);
* :func:`synth_ws` — web-server VM-demand step series (diurnal base +
  noise + flash-crowd trapezoid surges, exact integer peak);
* :class:`ScenarioGrid` names a (seeds × params) lane batch,
  :func:`synthesize` draws every lane on the CPU, turns the draws into
  tables on the device and pulls the batch host-side in one transfer,
  :func:`pack_scenarios` turns it into a
  :class:`repro_torch.sim.rounds.PackedEventWorkloads` (one
  ``ws_fold_tables_batch`` call for all (W, P) lanes), and
  :func:`sample_workloads` materializes chosen lanes as ``(List[Job],
  ws_trace)`` for the event engine.

The reference draws from ``jax.random``; PyTorch's generators give
other streams. So each generator is split in two: the *draws* (the
uniform, integer, exponential, categorical and normal arrays) and a
*deterministic transform* (:func:`_pbj_from_draws`,
:func:`_ws_from_draws`) that turns them into the job table or the demand
series op for op as the reference does, over a leading lane axis. Handed
the reference's own draws, the transforms reproduce its tables (the
tests do exactly that). :func:`synthesize` makes each lane's draws with
its own pair of CPU generators (PBJ and WS streams seeded apart from
``seeds[w]``), whatever the target device, and moves them there
together: a lane's draws depend only on its seed, never on the device,
the batch's width or the lane's position in it. The transforms then run
on the target device. Their reductions (the arrival CDF's prefix sum,
the utilization sum, the surge sum) and the lognormal ``exp`` run in
float64 and round once to float32, so a lane's values do not depend on
how the batch is laid out for a reduction. Between the CPU and the card
the transforms' float32 ``sin`` / ``log`` may differ in the last bit,
so the two devices' tables agree to that rounding (sizes and counts
exactly), not bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch.compat import resolve_pack_dtype
from repro_torch.core.jobs import Job
from repro_torch.sim.rounds import (PackedEventWorkloads, _to_pack,
                                    ws_fold_tables_batch)
from repro_torch.sim.traces import TWO_WEEKS

__all__ = [
    "PBJParams", "WSParams", "ScenarioGrid", "SynthesizedBatch",
    "NASA_IPSC_PBJ", "SDSC_BLUE_PBJ", "WORLDCUP_WS",
    "synth_pbj", "synth_ws", "lane_keys", "synthesize",
    "pack_scenarios", "sample_workloads",
]

_ARR_BINS = 2048        # arrival-intensity CDF resolution (~10 min bins)
_BURST_EPISODES = 32    # flash-burst episode pool per lane
_BURST_TAU = 180.0      # burst intra-episode spread (s)
_WS_SURGES = 12         # flash-crowd surge pool (12 matches in the paper)


@dataclasses.dataclass(frozen=True)
class PBJParams:
    """Generator parameters for one PBJ lane (scalars broadcast across a
    :class:`ScenarioGrid`, per-lane ``(W,)`` arrays sweep the axis)."""

    nodes: object = 128.0          # cluster size == size cap
    utilization: object = 0.466    # pinned exactly by the rescale
    n_jobs: object = 2603.0        # completed-job count (exact)
    alpha: object = 0.68           # mean runtime ∝ size^alpha
    sigma: object = 1.0            # lognormal runtime spread
    diurnal_depth: object = 0.95   # arrival-rate day/night swing (0..1)
    weekend_factor: object = 0.35  # weekend arrival-rate multiplier
    burst_frac: object = 0.12      # fraction of jobs arriving in bursts
    size_probs: object = (.20, .15, .13, .12, .12, .12, .13, .03)


@dataclasses.dataclass(frozen=True)
class WSParams:
    """Generator parameters for one WS demand lane."""

    peak: object = 64.0            # exact integer peak after rescale
    base_mean: object = 10.0       # diurnal base level (VMs)
    diurnal_amp: object = 0.6      # base swings base_mean·(1 ± amp)
    noise_std: object = 0.8        # per-step jitter (VMs)
    surge_ratio: object = 4.0      # surge amplitude / base_mean
    surge_hours: object = 2.5      # nominal surge length (hours)


# The paper traces as parameter points (moment targets in
# repro_torch.sim.traces: NASA_IPSC / SDSC_BLUE TraceSpecs, worldcup98).
NASA_IPSC_PBJ = PBJParams()
SDSC_BLUE_PBJ = PBJParams(nodes=144.0, utilization=0.762, n_jobs=2657.0,
                          alpha=0.15)
WORLDCUP_WS = WSParams(surge_ratio=4.0, surge_hours=2.5)


# ------------------------------------------------------------- generators

def _arrival_cdf(duration: float, depth, weekend_factor) -> torch.Tensor:
    """CDF of the binned diurnal×weekend arrival intensity per lane,
    ``(W, _ARR_BINS)`` from ``(W,)`` parameters:
    ``rate ∝ max(1 + depth·sin(work-day phase), 0)``, weekends damped."""
    dev = depth.device
    t = (torch.arange(_ARR_BINS, device=dev) + 0.5).float() \
        * (duration / _ARR_BINS)
    phase = 2 * np.pi * ((t % 86400.0) / 86400.0 - 0.375)
    rate = torch.clamp_min(1.0 + depth[:, None] * torch.sin(phase)[None, :],
                           0.0)
    weekend = (torch.div(t, 86400.0, rounding_mode="floor")
               .to(torch.int32) % 7) >= 5
    rate = torch.where(weekend[None, :], rate * weekend_factor[:, None],
                       rate) + 1e-9
    cdf = torch.cumsum(rate.double(), dim=-1).float()
    return cdf / cdf[:, -1:]


def _inv_cdf(u: torch.Tensor, cdf: torch.Tensor,
             duration: float) -> torch.Tensor:
    """Inverse-CDF sample per lane: bin by binary search, uniform within
    the bin. ``u`` (W, M), ``cdf`` (W, _ARR_BINS)."""
    idx = torch.clamp_max(torch.searchsorted(cdf, u.contiguous(),
                                             side="left"), _ARR_BINS - 1)
    prev = cdf.gather(1, torch.clamp_min(idx - 1, 0))
    lo = torch.where(idx > 0, prev, torch.zeros_like(prev))
    frac = torch.clamp((u - lo) / torch.clamp_min(cdf.gather(1, idx) - lo,
                                                  1e-12), 0.0, 1.0)
    return (idx.to(u.dtype) + frac) * (duration / _ARR_BINS)


def _pbj_draws(gen: torch.Generator, size_probs: torch.Tensor,
               max_jobs: int) -> dict:
    """One lane's PBJ draws from ``gen`` (on the generator's device):
    the reference's seven ``jax.random`` calls, in the same roles."""
    dev = gen.device
    kw = dict(generator=gen, device=dev)
    return {
        "u_arrival": torch.rand(max_jobs, **kw),
        "u_center": torch.rand(_BURST_EPISODES, **kw),
        "episode": torch.randint(0, _BURST_EPISODES, (max_jobs,), **kw),
        "exponential": torch.empty(max_jobs, device=dev).exponential_(
            generator=gen),
        "u_burst": torch.rand(max_jobs, **kw),
        "size_class": torch.multinomial(size_probs.to(dev), max_jobs,
                                        replacement=True, generator=gen),
        "normal": torch.randn(max_jobs, **kw),
    }


def _uniform(gen, n, lo, hi):
    """Uniform in [lo, hi) as ``jax.random.uniform`` scales it."""
    u = torch.rand(n, generator=gen, device=gen.device)
    return torch.clamp_min(u * (hi - lo) + lo, lo)


def _ws_draws(gen: torch.Generator, n_steps: int,
              step_seconds: float) -> dict:
    """One lane's WS draws from ``gen``: per-step noise, and per surge
    its day, start hour, length factor and amplitude factor."""
    n_days = max(int(n_steps * step_seconds // 86400.0), 2)
    return {
        "normal": torch.randn(n_steps, generator=gen, device=gen.device),
        "day": torch.randint(1, n_days, (_WS_SURGES,), generator=gen,
                             device=gen.device),
        "hour": _uniform(gen, _WS_SURGES, 12.0, 20.0),
        "length": _uniform(gen, _WS_SURGES, 0.6, 1.4),
        "amp": _uniform(gen, _WS_SURGES, 0.5, 1.0),
    }


def _pbj_from_draws(draws: dict, params: PBJParams, *, max_jobs: int,
                    duration: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """The deterministic half of :func:`synth_pbj` over W lanes: draws
    ``(W, ...)`` and ``(W,)`` float32 parameter tensors → arrival-sorted
    ``(submit, size, runtime, n_jobs)`` of shape ``(W, max_jobs)`` /
    ``(W,)``, rows past ``n_jobs`` padded with ``submit=+inf`` and size
    / runtime 0 (the reference's lines, op for op)."""
    p = params
    cdf = _arrival_cdf(duration, p.diurnal_depth, p.weekend_factor)
    base_t = _inv_cdf(draws["u_arrival"], cdf, duration)
    centers = _inv_cdf(draws["u_center"], cdf, duration)
    delay = _BURST_TAU * draws["exponential"]
    burst = draws["u_burst"] < p.burst_frac[:, None]
    submit = torch.clamp(torch.where(
        burst, centers.gather(1, draws["episode"].long()) + delay, base_t),
        0.0, duration - 1.0)
    size = torch.minimum(torch.pow(2.0, draws["size_class"].float()),
                         p.nodes[:, None])
    # Lognormal runtimes, mean ∝ size^alpha; one global rescale pins
    # utilization exactly (Σ size·rt over real jobs = util·nodes·T).
    mu = p.alpha[:, None] * torch.log(size) - p.sigma[:, None] ** 2 / 2
    rt = torch.exp((mu + p.sigma[:, None] * draws["normal"]).double()
                   ).float()
    valid = torch.arange(max_jobs, device=size.device)[None, :] \
        < p.n_jobs[:, None]
    target = p.utilization * p.nodes * duration
    used = torch.where(valid, size * rt, torch.zeros_like(rt)).double() \
        .sum(dim=-1).float()
    rt = rt * (target / used)[:, None]
    rt = torch.clamp_min(rt, 1.0)
    submit = torch.where(valid, submit, torch.full_like(submit, np.inf))
    submit, order = torch.sort(submit, dim=-1, stable=True)
    zero = torch.zeros_like(rt)
    size = torch.where(valid, size, zero).gather(1, order).to(torch.int32)
    runtime = torch.where(valid, rt, zero).gather(1, order)
    return submit, size, runtime, p.n_jobs.to(torch.int32)


def _ws_from_draws(draws: dict, params: WSParams, *, n_steps: int,
                   step_seconds: float = 300.0) -> torch.Tensor:
    """The deterministic half of :func:`synth_ws` over W lanes: draws
    and ``(W,)`` float32 parameters → ``(W, n_steps)`` integer demands
    on the grid ``t_i = i·step_seconds``, peak exactly ``params.peak``,
    floor 1 VM (the reference's lines, op for op)."""
    p = params
    dev = draws["normal"].device
    t = torch.arange(n_steps, device=dev).float() * step_seconds
    day = (t % 86400.0) / 86400.0
    wave = torch.sin(2 * np.pi * (day - 0.3))
    base = p.base_mean[:, None] * (1.0 + p.diurnal_amp[:, None]
                                   * wave[None, :])
    base = base + p.noise_std[:, None] * draws["normal"]
    start = draws["day"].float() * 86400.0 + 3600.0 * draws["hour"]
    length = (3600.0 * p.surge_hours)[:, None] * draws["length"]
    amp = (p.surge_ratio * p.base_mean)[:, None] * draws["amp"]
    ramp = 0.22 * length
    rel = t[None, None, :] - start[:, :, None]              # (W, S, T)
    up = torch.clamp(rel / ramp[:, :, None], 0.0, 1.0)
    down = torch.clamp((length[:, :, None] - rel) / ramp[:, :, None],
                       0.0, 1.0)
    surge = (amp[:, :, None] * torch.minimum(up, down)).double() \
        .sum(dim=1).float()
    demand = torch.clamp_min(base + surge, 1.0)
    # Exact integer peak: the max maps to peak·(1 ± ulp), every other
    # point strictly below, so round() pins max(demand) == peak.
    demand = demand * (p.peak / demand.amax(dim=-1))[:, None]
    return torch.clamp_min(torch.round(demand), 1.0)


def _lane_params(params, device) -> object:
    """A parameter dataclass of ``(W,)`` (``size_probs`` ``(W, 8)``)
    float32 tensors on ``device``, from broadcast numpy leaves."""
    return type(params)(**{
        f.name: torch.from_numpy(np.array(getattr(params, f.name),
                                          np.float32)).to(device)
        for f in dataclasses.fields(params)})


def synth_pbj(gen: torch.Generator, params: PBJParams, *, max_jobs: int,
              duration: float = TWO_WEEKS
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """One lane's PBJ job table, drawn from ``gen`` on its device.
    Returns arrival-sorted ``(submit, size, runtime, n_jobs)`` of fixed
    shape ``(max_jobs,)`` — rows past ``n_jobs`` carry the pack padding
    convention (``submit=+inf``, size / runtime 0)."""
    p = _lane_params(_broadcast_params(params, 1), gen.device)
    d = _pbj_draws(gen, p.size_probs[0], max_jobs)
    out = _pbj_from_draws({k: v[None] for k, v in d.items()}, p,
                          max_jobs=max_jobs, duration=duration)
    return tuple(x[0] for x in out)


def synth_ws(gen: torch.Generator, params: WSParams, *, n_steps: int,
             step_seconds: float = 300.0) -> torch.Tensor:
    """One lane's WS VM-demand series on the dense step grid ``t_i =
    i·step_seconds``, drawn from ``gen``: ``(n_steps,)`` demands."""
    p = _lane_params(_broadcast_params(params, 1), gen.device)
    d = _ws_draws(gen, n_steps, step_seconds)
    return _ws_from_draws({k: v[None] for k, v in d.items()}, p,
                          n_steps=n_steps, step_seconds=step_seconds)[0]


# ----------------------------------------------------------- batch plumbing

@dataclasses.dataclass(frozen=True)
class ScenarioGrid:
    """A (seeds × params) lane batch: lane ``w`` draws from
    ``seeds[w]`` with the ``w``-th slice of each parameter axis
    (scalar params broadcast). ``max_jobs`` fixes the job-table height;
    ``ws_step`` the WS demand grid (300 s, like worldcup98)."""

    seeds: Tuple[int, ...]
    pbj: PBJParams = NASA_IPSC_PBJ
    ws: WSParams = WORLDCUP_WS
    duration: float = TWO_WEEKS
    max_jobs: int = 3000
    ws_step: float = 300.0

    @property
    def n_lanes(self) -> int:
        return len(self.seeds)

    @property
    def n_ws_steps(self) -> int:
        return int(np.ceil(self.duration / self.ws_step))


@dataclasses.dataclass(frozen=True)
class SynthesizedBatch:
    """Host-side arrays for W generated lanes (one device transfer)."""

    submit: np.ndarray      # (W, max_jobs) arrival-sorted, +inf padded
    size: np.ndarray        # (W, max_jobs) int32
    runtime: np.ndarray     # (W, max_jobs)
    n_jobs: np.ndarray      # (W,) int32
    ws_times: np.ndarray    # (S,) dense step grid, shared by all lanes
    ws_values: np.ndarray   # (W, S) integer demands
    duration: float


_PARAM_BASE_NDIM = {"size_probs": 1}


def _broadcast_params(params, n_lanes: int):
    """Broadcast each scalar leaf to ``(W,)`` (``size_probs`` to
    ``(W, 8)``) float32; per-lane arrays pass through after a width
    check."""
    def one(name: str, leaf):
        base = _PARAM_BASE_NDIM.get(name, 0)
        a = np.asarray(leaf, np.float32)
        if a.ndim == base:
            a = np.broadcast_to(a, (n_lanes,) + a.shape)
        elif a.shape[0] != n_lanes:
            raise ValueError(
                f"param {name!r} has leading dim {a.shape[0]}, expected "
                f"scalar or {n_lanes} lanes")
        return a

    return type(params)(**{f.name: one(f.name, getattr(params, f.name))
                           for f in dataclasses.fields(params)})


def lane_keys(seeds: Sequence[int]) -> np.ndarray:
    """Per-lane (pbj, ws) generator seeds, ``(W, 2)`` uint64: lane ``w``'s
    pair comes from ``seeds[w]`` alone (two ``SeedSequence`` streams), so
    a lane draws the same values in any batch."""
    return np.array([[np.random.SeedSequence([int(s), stream])
                      .generate_state(1, np.uint64)[0] >> np.uint64(1)
                      for stream in (0, 1)] for s in seeds],
                    np.uint64).reshape(-1, 2)


def synthesize(grid: ScenarioGrid,
               device: compat.Device = None) -> SynthesizedBatch:
    """Generate every lane of ``grid`` on ``device`` (CUDA by default,
    the CPU on request) and pull the batch host-side in one transfer.
    The draws are made lane by lane from each lane's own CPU generators
    and moved to ``device``; the transforms run there over all lanes at
    once."""
    dev = compat.resolve_device(device)
    W = grid.n_lanes
    pbj = _lane_params(_broadcast_params(grid.pbj, W), dev)
    wsp = _lane_params(_broadcast_params(grid.ws, W), dev)
    probs = torch.from_numpy(np.array(
        _broadcast_params(grid.pbj, W).size_probs, np.float32))
    pbj_draws, ws_draws = [], []
    for w, (s_pbj, s_ws) in enumerate(lane_keys(grid.seeds)):
        g = torch.Generator().manual_seed(int(s_pbj))
        pbj_draws.append(_pbj_draws(g, probs[w], grid.max_jobs))
        g = torch.Generator().manual_seed(int(s_ws))
        ws_draws.append(_ws_draws(g, grid.n_ws_steps, grid.ws_step))
    stack = lambda ds: {k: torch.stack([d[k] for d in ds]).to(dev)
                        for k in ds[0]}
    submit, size, runtime, n_jobs = _pbj_from_draws(
        stack(pbj_draws), pbj, max_jobs=grid.max_jobs,
        duration=float(grid.duration))
    ws_vals = _ws_from_draws(stack(ws_draws), wsp, n_steps=grid.n_ws_steps,
                             step_seconds=float(grid.ws_step))
    ws_times = np.arange(grid.n_ws_steps, dtype=np.float64) * grid.ws_step
    return SynthesizedBatch(submit=submit.cpu().numpy(),
                            size=size.cpu().numpy(),
                            runtime=runtime.cpu().numpy(),
                            n_jobs=n_jobs.cpu().numpy(), ws_times=ws_times,
                            ws_values=ws_vals.cpu().numpy(),
                            duration=float(grid.duration))


def pack_scenarios(synth: SynthesizedBatch, window: int, policy: str,
                   leases: Sequence[float], levels: Sequence[float],
                   dtype=None, device: compat.Device = None
                   ) -> PackedEventWorkloads:
    """Pack a synthesized batch for one policy's sweep points on
    ``device`` — the generated-lane counterpart of
    :func:`repro_torch.sim.rounds.pack_event_workloads`, with every
    per-workload host loop replaced by array ops: job tables append the
    window padding block, rise stops compress by an argsort of the
    masked dense grid, and the WS fold tables build in ONE
    :func:`~repro_torch.sim.rounds.ws_fold_tables_batch` call over all
    (W, P) lanes."""
    dev = compat.resolve_device(device)
    dtype = resolve_pack_dtype(dtype)
    W, J = synth.submit.shape
    pad = np.full((W, window), np.inf, dtype)
    zpad = np.zeros((W, window), dtype)
    submit = np.concatenate([synth.submit.astype(dtype), pad], axis=1)
    size = np.concatenate([synth.size.astype(dtype), zpad], axis=1)
    runtime = np.concatenate([synth.runtime.astype(dtype), zpad], axis=1)
    times = synth.ws_times.astype(np.float64)
    vals = synth.ws_values.astype(np.float64)
    ws0 = vals[:, 0]
    changed = vals[:, 1:] != vals[:, :-1]
    ws_adjusts = changed.sum(axis=1) + (vals[:, 0] > 0)
    up = np.zeros(vals.shape, bool)
    up[:, 1:] = vals[:, 1:] > vals[:, :-1]
    nr = int(up.sum(axis=1).max()) + 1        # +inf sentinel
    masked_t = np.where(up, times[None, :], np.inf)
    order = np.argsort(masked_t, axis=1)[:, :nr]
    rise_times = np.take_along_axis(masked_t, order, axis=1)
    rise_vals = np.where(np.take_along_axis(up, order, axis=1),
                         np.take_along_axis(vals, order, axis=1), 0.0)
    # The dense grid's no-op points are value-identical for the fold
    # tables (equal adjacent segments merge in the integral, maxima and
    # boundary gathers are unchanged), so no per-lane compression pass.
    integral, winmax, at_tick = ws_fold_tables_batch(
        times, vals, synth.duration, policy,
        np.asarray(leases, np.float64), np.asarray(levels, np.float64))
    return _to_pack(dict(
        submit=submit, size=size, runtime=runtime, ws0=ws0.astype(dtype),
        ws_adjusts=ws_adjusts.astype(dtype),
        rise_times=rise_times.astype(dtype),
        rise_vals=rise_vals.astype(dtype),
        ws_integral=integral.astype(dtype), ws_winmax=winmax.astype(dtype),
        ws_at_tick=at_tick.astype(dtype),
        n_jobs=np.asarray(synth.n_jobs).astype(np.int32)), dev)


def sample_workloads(synth: SynthesizedBatch,
                     indices: Sequence[int]
                     ) -> List[Tuple[List[Job], List[Tuple[float, int]]]]:
    """Materialize chosen lanes as ``(List[Job], ws_trace)`` for the
    event-engine differential harness — float32 values round-trip
    exactly through Python floats, so the event engine sees the very
    numbers the packed batch carries."""
    out = []
    for w in indices:
        n = int(synth.n_jobs[w])
        jobs = [Job(jid=i, submit=float(synth.submit[w, i]),
                    size=int(synth.size[w, i]),
                    runtime=float(synth.runtime[w, i]))
                for i in range(n)]
        vals = synth.ws_values[w]
        trace: List[Tuple[float, int]] = [(0.0, int(vals[0]))]
        for i in range(1, len(vals)):
            d = int(vals[i])
            if d != trace[-1][1]:
                trace.append((float(synth.ws_times[i]), d))
        out.append((jobs, trace))
    return out
