"""Parameter-sweep engine — the paper's evaluation methodology at scale.

Counterpart of ``repro.sim.sweep``. Fig. 13 sweeps the private-cloud
capacity C, Fig. 14 the coordinated-pool size B and Fig. 18 the lease
unit L against EC2+RightScale; ``run_sweep`` evaluates a whole grid of
:class:`SweepPoint`s — mixing all four systems — in one call, and
``run_sweep_workloads`` adds a second batch axis over workload traces.

Execution paths, selected by ``mode``:

  * **Vectorized** DCS and EC2+RightScale (every mode except
    ``"event"``): both baselines are stateless given the trace. DCS is
    closed-form arithmetic; the EC2 allocation curve for ALL lease
    values runs as batched tensor ops in float64 (whatever the pack
    dtype), so integer metrics match the event engine exactly and
    node-hours to round-off.
  * **Event rounds** FB and FLB-NUB (modes ``"rounds"`` and ``"auto"``):
    ``repro_torch.sim.rounds`` on the device, through the hand-written
    round-step kernel on a CUDA device. ``"auto"`` sends FB points with
    ``checkpoint_preempt`` to the event engine; ``"rounds"`` refuses
    them.
  * **Fixed-dt scan** FB and FLB-NUB (mode ``"scan"``):
    ``repro_torch.sim.scan`` advances every (trace × point) lane on a
    fixed substep on the device, a host loop of small tensor ops.
    Approximate by discretization (``CONTRACTS["scan"]``); kept as the
    cross-check of the rounds engine.
  * **Event engine** (mode ``"event"``, and the fallback above): one
    ``run_sim`` per point on its own clone of the trace — the reference
    every fast path is validated against.

``workloads`` may also be a generated scenario batch
(:class:`repro_torch.sim.scenarios.ScenarioGrid`): its lanes are
synthesized on the device, packed as one batch and run through the
rounds engine as one (W × P) program per policy.

The vectorized path replicates the event engine's tie order: at a
shared timestamp WS demand changes apply before lease-tick releases,
and releases before submits.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import compat, spans
from repro_torch.core.jobs import Job
from repro_torch.core.pbj_manager import PBJPolicyParams
from repro_torch.core.profiles import step_integral, step_points
from repro_torch.sim import rounds as roundslib
from repro_torch.sim import scan as scanlib
from repro_torch.sim import scenarios as scenarioslib
from repro_torch.sim.engine import (_SUBMIT, _TICK, _WS, SYSTEMS, build_dcs,
                                    build_ec2_rightscale, build_fb,
                                    build_flb_nub, clone_jobs,
                                    default_duration, run_sim)

__all__ = ["SweepPoint", "ScanOptions", "run_sweep", "run_sweep_workloads",
           "warmup_sweep", "paper_grid"]

MODES = ("auto", "event", "scan", "rounds")

# Systems with a stateless closed-form fast path vs the stateful
# coordinated policies that take the batched rounds path.
_VECTORIZED = ("dcs", "ec2")
_SCANNABLE = ("fb", "flb_nub")

@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One (system, parameter) point of a sweep grid.

    ``system`` selects the provisioning system; the remaining fields are
    that system's knobs (unused ones are ignored): ``capacity`` is the
    Fig.-13 sweep variable C, ``lb_pbj + lb_ws`` the Fig.-14 pool size
    B, and ``lease_seconds`` the Fig.-18 lease unit L.
    """

    system: str                       # "dcs" | "fb" | "flb_nub" | "ec2"
    prc_pbj: int = 0                  # dcs: static PBJ partition
    prc_ws: int = 0                   # dcs: static WS partition
    capacity: int = 0                 # fb: private-cloud capacity C
    lb_pbj: int = 0                   # flb_nub: PBJ lower bound
    lb_ws: int = 0                    # flb_nub: WS lower bound
    lease_seconds: float = 3600.0     # all: lease time unit L
    params: PBJPolicyParams = PBJPolicyParams()
    label: str = ""

    def __post_init__(self):
        if self.system not in SYSTEMS:
            raise ValueError(
                f"unknown system {self.system!r}; expected one of "
                f"{sorted(SYSTEMS)}")
        if self.lease_seconds <= 0:
            raise ValueError(
                f"lease_seconds must be > 0, got {self.lease_seconds}")

    def name(self) -> str:
        if self.label:
            return self.label
        return {
            "dcs": f"DCS({self.prc_pbj}+{self.prc_ws})",
            "fb": f"FB(C={self.capacity})",
            "flb_nub": f"FLB-NUB(B={self.lb_pbj + self.lb_ws})",
            "ec2": f"EC2+RightScale(L={self.lease_seconds:g}s)",
        }[self.system]


@dataclasses.dataclass(frozen=True)
class ScanOptions:
    """Knobs of the batched paths (``mode="scan"``:
    ``repro_torch.sim.scan``; ``mode="rounds"``:
    ``repro_torch.sim.rounds``). The defaults are the settings the
    fidelity contracts are validated at: the policy's window
    (``window=None``), 2 first-fit passes (``ff_passes=None``) and no
    coalescing (``coalesce=None``; ``rounds.COALESCE_BATCH`` = 8 is the
    recommended opt-in). ``dt=None`` picks each policy's validated
    substep (``scan.pick_dt``) and ``chunk_len=None`` re-gathers the job
    window every hour (FB) or half hour (FLB-NUB); both only affect
    ``mode="scan"``, and ``coalesce`` / ``kernel`` only the rounds
    engine. ``dtype`` is the pack dtype (float32 by default, float64 on
    request). ``kernel`` selects the round-step backend: ``None`` picks
    the CUDA kernel on a CUDA device and the plain version on the CPU;
    ``"cuda"`` and ``"torch"`` choose. ``devices``
    (``compat.resolve_devices``: a count of cards, or a device list,
    which may repeat a device) splits the batched paths' (trace ×
    point) lanes across devices, with the rows of ``None``."""

    dt: Optional[float] = None
    window: Optional[int] = None
    chunk_len: Optional[int] = None
    ff_passes: Optional[int] = None
    coalesce: Optional[int] = None
    dtype: Optional[np.dtype] = None
    devices: Optional[Union[int, Sequence]] = None
    kernel: Optional[str] = None

    def resolve(self, policy: str, leases: Sequence[float],
                duration: float,
                ws_traces: Optional[Sequence[Sequence[Tuple[float, int]]]]
                = None) -> scanlib.ScanSpec:
        dt = self.dt if self.dt is not None else scanlib.pick_dt(
            policy, leases, ws_traces, duration)
        window = (self.window if self.window is not None else
                  (scanlib.FB_WINDOW if policy == "fb"
                   else scanlib.FLB_WINDOW))
        # Re-gather cadence: FB's window turns over slowly (its backlog
        # is bounded by C), FLB-NUB's buffers arrival bursts.
        chunk_seconds = 3600.0 if policy == "fb" else 1800.0
        chunk = (self.chunk_len if self.chunk_len is not None
                 else max(2, int(round(chunk_seconds / dt))))
        ff = (self.ff_passes if self.ff_passes is not None
              else scanlib.DEFAULT_FF_PASSES)
        return scanlib.ScanSpec(
            n_steps=int(np.ceil(duration / dt)), dt=dt, window=window,
            chunk_len=chunk, ff_passes=ff)

    def resolve_rounds(self, policy: str, leases: Sequence[float],
                       duration: float, max_jobs: int,
                       n_ws: int) -> roundslib.RoundsSpec:
        window = (self.window if self.window is not None else
                  (roundslib.FB_ROUNDS_WINDOW if policy == "fb"
                   else roundslib.FLB_ROUNDS_WINDOW))
        ff = (self.ff_passes if self.ff_passes is not None
              else roundslib.ROUNDS_FF_PASSES)
        batch = (self.coalesce if self.coalesce is not None
                 else roundslib.DEFAULT_BATCH)
        if batch < 1:
            raise ValueError(f"coalesce batch must be >= 1, got {batch}")
        return roundslib.RoundsSpec(
            duration=duration,
            max_rounds=roundslib.round_budget(max_jobs, n_ws, duration,
                                              min(leases)),
            window=window, ff_passes=ff, batch=batch,
            kernel=self.kernel)


def _build(p: SweepPoint):
    if p.system == "dcs":
        return build_dcs(p.prc_pbj, p.prc_ws, p.lease_seconds)
    if p.system == "fb":
        return build_fb(p.capacity, p.lease_seconds, p.params)
    if p.system == "flb_nub":
        return build_flb_nub(p.lb_pbj, p.lb_ws, p.lease_seconds, p.params)
    if p.system == "ec2":
        return build_ec2_rightscale(p.lease_seconds)
    raise ValueError(f"unknown system {p.system!r}")


# ------------------------------------------------------- vectorized baselines

def _sweep_dcs(points: List[SweepPoint], duration: float) -> List[Dict]:
    """All DCS points at once: the partition is static, so the cost curve
    is an affine function of the configuration size. Vectorized DCS rows
    carry the cost/peak metrics only — job metrics need the event engine
    (``mode="event"``)."""
    rows = []
    for p in points:
        size = p.prc_pbj + p.prc_ws
        rows.append({
            "system": p.name(), "system_kind": "dcs", "engine": "vectorized",
            "lease_seconds": p.lease_seconds,
            "node_hours": size * duration / 3600.0,
            "peak_nodes": size,
            "adjust_events": int(p.prc_ws > 0) + int(p.prc_pbj > 0),
            "pbj_adjust_events": int(p.prc_pbj > 0),
            "kills": 0,
        })
    return rows


def _sweep_ec2(points: List[SweepPoint], jobs: Sequence[Job],
               ws_trace: Sequence[Tuple[float, int]],
               duration: float, device: torch.device) -> List[Dict]:
    """All EC2+RightScale points (one per lease value) as batched float64
    tensor ops on ``device``.

    Per job j and lease L: the job allocates ``size_j`` on
    ``[submit_j, rel_j)`` where ``rel_j`` is the first lease tick
    *strictly after* its completion (§6.6.2 whole-hour billing plus the
    engine's tick-before-finish tie order), clipped to the trace
    duration when the tick never fires. The WS curve replays the demand
    trace verbatim and is lease-independent.
    """
    ws_t64, ws_v64 = step_points(ws_trace, duration)
    ws_node_seconds = step_integral(ws_t64, ws_v64, duration)
    ws_deltas64 = np.concatenate([ws_v64[:1], np.diff(ws_v64)])
    ws_adjusts = int(np.count_nonzero(ws_deltas64))

    f64 = dict(dtype=torch.float64, device=device)
    submit = torch.tensor([j.submit for j in jobs], **f64)
    size = torch.tensor([j.size for j in jobs], **f64)
    runtime = torch.tensor([j.runtime for j in jobs], **f64)
    end = submit + runtime
    in_trace = submit <= duration + 1e-9     # engine drops later submits
    finishes = in_trace & (end <= duration + 1e-9)

    L = torch.tensor([p.lease_seconds for p in points], **f64)[:, None]
    # First tick strictly after the finish event; a tick exists only
    # while k·L <= duration (the engine's strict scheduling comparison).
    rel = (torch.floor(end / L) + 1.0) * L                      # (P, J)
    fired = in_trace & (rel <= duration)
    rel_eff = torch.where(fired, rel, torch.full_like(rel, duration))
    pbj_ns = torch.where(in_trace, size * (rel_eff - submit),
                         torch.zeros_like(rel)).sum(dim=1)
    node_hours = (pbj_ns + ws_node_seconds) / 3600.0

    # Peak: merge WS steps, submits (+size) and releases (−size) and take
    # the running total's max. Order by time, ties by event kind (the
    # engine's: WS, tick, submit) — a stable sort by kind, then a stable
    # sort by time.
    P = len(points)
    n_ws, n_j = len(ws_t64), submit.shape[0]
    ws_t = torch.tensor(ws_t64, **f64)
    ws_d = torch.tensor(ws_deltas64, **f64)
    ev_t = torch.cat([ws_t.expand(P, n_ws), submit.expand(P, n_j), rel],
                     dim=1)
    ev_kind = torch.cat([torch.full((n_ws,), float(_WS), **f64),
                         torch.full((n_j,), float(_SUBMIT), **f64),
                         torch.full((n_j,), float(_TICK), **f64)])
    delta = torch.cat([ws_d.expand(P, n_ws),
                       torch.where(in_trace, size,
                                   torch.zeros_like(size)).expand(P, n_j),
                       torch.where(fired, -size, torch.zeros_like(rel))],
                      dim=1)
    by_kind = torch.sort(ev_kind, stable=True).indices
    ev_t, delta = ev_t[:, by_kind], delta[:, by_kind]
    by_time = torch.sort(ev_t, dim=1, stable=True).indices
    running = torch.cumsum(delta.gather(1, by_time), dim=1)
    peak = torch.clamp_min(running.amax(dim=1), 0.0).cpu().numpy()

    n_completed = int(finishes.sum())
    sum_rt = float(torch.where(finishes, runtime,
                               torch.zeros_like(runtime)).sum())
    n_released = fired.sum(dim=1).cpu().numpy()
    n_submitted = int(in_trace.sum())
    node_hours = node_hours.cpu().numpy()
    avg_rt = sum_rt / n_completed if n_completed else 0.0
    rows = []
    for i, p in enumerate(points):
        pbj_adjusts = n_submitted + int(n_released[i])
        rows.append({
            "system": p.name(), "system_kind": "ec2", "engine": "vectorized",
            "lease_seconds": p.lease_seconds,
            "node_hours": float(node_hours[i]),
            "peak_nodes": int(round(float(peak[i]))),
            "completed_jobs": n_completed,
            "avg_turnaround": avg_rt,        # EC2 never queues (§6.6.1)
            "avg_execution": avg_rt,
            "adjust_events": pbj_adjusts + ws_adjusts,
            "pbj_adjust_events": pbj_adjusts,
            "kills": 0,
        })
    return rows


# ------------------------------------------------ batched scan/rounds paths

def _reject_preempt(points: List[SweepPoint], mode: str) -> None:
    for p in points:
        # The status-lane kill encoding resets a killed lane to its full
        # runtime; the beyond-paper checkpoint-preempt mode only exists
        # on the event engine. FLB-NUB never force-releases, so the
        # guard is FB-only.
        if p.system == "fb" and p.params.checkpoint_preempt:
            raise ValueError(
                f"{p.name()}: checkpoint_preempt is not supported by "
                f"mode=\"{mode}\"; run this point with mode=\"auto\" or "
                f"mode=\"event\"")


def _fb_grid(points: List[SweepPoint], idxs: List[int], f,
             device) -> scanlib.FBGrid:
    kw = dict(dtype=f, device=device)
    return scanlib.FBGrid(
        capacity=torch.tensor([float(points[i].capacity) for i in idxs],
                              **kw),
        lease=torch.tensor([points[i].lease_seconds for i in idxs], **kw))


def _flb_grid(points: List[SweepPoint], idxs: List[int], f,
              device) -> scanlib.FLBGrid:
    kw = dict(dtype=f, device=device)

    def col(fn):
        return torch.tensor([float(fn(points[i])) for i in idxs], **kw)

    return scanlib.FLBGrid(
        B=col(lambda p: p.lb_pbj + p.lb_ws),
        lb_ws=col(lambda p: p.lb_ws),
        U=col(lambda p: p.params.request_threshold),
        V=col(lambda p: p.params.release_threshold),
        G=col(lambda p: p.params.elastic_factor),
        lease=col(lambda p: p.lease_seconds))


_DIAG_KEYS = ("window_overflow", "truncated", "rounds", "coalesced")


def _assemble_rows(points: List[SweepPoint], fb_idx: List[int],
                   flb_idx: List[int], out: Dict, n_workloads: int,
                   engine: str) -> List[List[Dict]]:
    """Metric arrays → one row list per workload, aligned with
    ``points``; diagnostics (window overflow, round truncation) ride
    along per row so callers can see them."""
    per_workload: List[List[Dict]] = []
    for w in range(n_workloads):
        rows: List[Optional[Dict]] = [None] * len(points)
        for kind, idxs in (("fb", fb_idx), ("flb_nub", flb_idx)):
            for j, i in enumerate(idxs):
                m = {k: v[w][j] for k, v in out[kind].items()}
                p = points[i]
                rows[i] = {
                    "system": p.name(), "system_kind": p.system,
                    "engine": engine, "lease_seconds": p.lease_seconds,
                    "completed_jobs": int(round(float(m["completed_jobs"]))),
                    "avg_turnaround": float(m["avg_turnaround"]),
                    "avg_execution": float(m["avg_execution"]),
                    "node_hours": float(m["node_hours"]),
                    "peak_nodes": int(round(float(m["peak_nodes"]))),
                    "adjust_events": int(round(float(m["adjust_events"]))),
                    "pbj_adjust_events": int(round(float(
                        m["pbj_adjust_events"]))),
                    "kills": int(round(float(m["kills"]))),
                    "window_overflow": int(round(float(
                        m["window_overflow"]))),
                }
                for k in _DIAG_KEYS[1:]:
                    if k in m:
                        rows[i][k] = int(round(float(m[k])))
        per_workload.append(rows)                 # type: ignore[arg-type]
    return per_workload                           # type: ignore[return-value]


def _warn_diagnostics(per_workload: List[List[Dict]], engine: str,
                      stacklevel: int = 3) -> None:
    """Surface lane diagnostics: a backlog that outgrew the job window
    (results silently degrade — jobs start late or never) or a lane
    that exhausted its round budget. ``stacklevel`` resolves to the
    frame outside the sweep library."""
    overflowed = [r["system"] for rows in per_workload for r in rows
                  if r is not None and r.get("window_overflow", 0) > 0]
    if overflowed:
        warnings.warn(
            f"{engine} sweep: job backlog outgrew the lane window on "
            f"{len(overflowed)} row(s) ({', '.join(sorted(set(overflowed)))}"
            f"); metrics under-report queued work — raise "
            f"ScanOptions.window", RuntimeWarning, stacklevel=stacklevel)
    truncated = [r["system"] for rows in per_workload for r in rows
                 if r is not None and r.get("truncated", 0) > 0]
    if truncated:
        warnings.warn(
            f"{engine} sweep: round budget exhausted before the horizon "
            f"on {len(truncated)} row(s) "
            f"({', '.join(sorted(set(truncated)))})", RuntimeWarning,
            stacklevel=stacklevel)


def _pack_scan(points: List[SweepPoint],
               workloads: Sequence[Tuple[Sequence[Job],
                                         Sequence[Tuple[float, int]]]],
               duration: float, options: ScanOptions,
               device: torch.device):
    """Host-side setup stage of the scan path: trace packing (to
    ``device``) + grid construction."""
    fb_idx = [i for i, p in enumerate(points) if p.system == "fb"]
    flb_idx = [i for i, p in enumerate(points) if p.system == "flb_nub"]
    ws_traces = [ws for _, ws in workloads]

    fb = flb = fb_packed = flb_packed = fb_spec = flb_spec = None
    if fb_idx:
        fb_spec = options.resolve(
            "fb", [points[i].lease_seconds for i in fb_idx], duration)
        fb_packed, _ = scanlib.pack_workloads(
            workloads, duration, fb_spec.dt, window=fb_spec.window,
            chunk_len=fb_spec.chunk_len, dtype=options.dtype, device=device)
        fb = _fb_grid(points, fb_idx, fb_packed.ws.dtype, device)
    if flb_idx:
        flb_spec = options.resolve(
            "flb_nub", [points[i].lease_seconds for i in flb_idx], duration,
            ws_traces=ws_traces)
        flb_packed, _ = scanlib.pack_workloads(
            workloads, duration, flb_spec.dt, window=flb_spec.window,
            chunk_len=flb_spec.chunk_len, dtype=options.dtype, device=device)
        flb = _flb_grid(points, flb_idx, flb_packed.ws.dtype, device)
    return fb_idx, flb_idx, fb, flb, fb_packed, flb_packed, fb_spec, flb_spec


def _to_numpy(out: Dict[str, Dict[str, torch.Tensor]]) -> Dict:
    return {kind: {k: v.cpu().numpy() for k, v in m.items()}
            for kind, m in out.items()}


def _sweep_scan(points: List[SweepPoint],
                workloads: Sequence[Tuple[Sequence[Job],
                                          Sequence[Tuple[float, int]]]],
                duration: float, options: ScanOptions,
                device: torch.device,
                warn_stacklevel: int = 3) -> List[List[Dict]]:
    """FB and FLB-NUB points through the fixed-dt scan engine. Returns
    one row list per workload, each aligned with ``points`` (which must
    all be scan-eligible systems); the whole (policy, point, workload)
    grid runs as one lane batch per policy."""
    assert all(p.system in _SCANNABLE for p in points)
    _reject_preempt(points, "scan")
    (fb_idx, flb_idx, fb, flb, fb_packed, flb_packed,
     fb_spec, flb_spec) = _pack_scan(points, workloads, duration, options,
                                     device)
    out = scanlib.scan_grids(fb, flb, fb_packed, flb_packed,
                             fb_spec=fb_spec, flb_spec=flb_spec,
                             devices=options.devices)
    rows = _assemble_rows(points, fb_idx, flb_idx, _to_numpy(out),
                          len(workloads), "scan")
    _warn_diagnostics(rows, "scan", stacklevel=warn_stacklevel)
    return rows


def _pack_rounds(points: List[SweepPoint],
                 workloads: Sequence[Tuple[Sequence[Job],
                                           Sequence[Tuple[float, int]]]],
                 duration: float, options: ScanOptions,
                 device: torch.device):
    """Host-side setup stage of the rounds path: event packing + fold
    tables + grid construction, one single-workload pack per trace."""
    fb_idx = [i for i, p in enumerate(points) if p.system == "fb"]
    flb_idx = [i for i, p in enumerate(points) if p.system == "flb_nub"]
    max_jobs = max(len(jobs) for jobs, _ in workloads)
    n_ws = max(len(ws) for _, ws in workloads)

    fb = flb = fb_packs = flb_packs = fb_spec = flb_spec = None
    if fb_idx:
        with spans.span("sweep.pack", policy="fb"):
            leases = [points[i].lease_seconds for i in fb_idx]
            fb_spec = options.resolve_rounds("fb", leases, duration,
                                             max_jobs, n_ws)
            fb_packs = roundslib.pack_event_workloads(
                workloads, duration, fb_spec.window, "fb", leases,
                [float(points[i].capacity) for i in fb_idx],
                dtype=options.dtype, split=True, device=device)
            fb = _fb_grid(points, fb_idx, fb_packs[0].submit.dtype, device)
    if flb_idx:
        with spans.span("sweep.pack", policy="flb_nub"):
            leases = [points[i].lease_seconds for i in flb_idx]
            flb_spec = options.resolve_rounds("flb_nub", leases, duration,
                                              max_jobs, n_ws)
            flb_packs = roundslib.pack_event_workloads(
                workloads, duration, flb_spec.window, "flb_nub", leases,
                [float(points[i].lb_ws) for i in flb_idx],
                dtype=options.dtype, split=True, device=device)
            flb = _flb_grid(points, flb_idx, flb_packs[0].submit.dtype,
                            device)
    return fb_idx, flb_idx, fb, flb, fb_packs, flb_packs, fb_spec, flb_spec


def _sweep_rounds(points: List[SweepPoint],
                  workloads: Sequence[Tuple[Sequence[Job],
                                            Sequence[Tuple[float, int]]]],
                  duration: float, options: ScanOptions,
                  device: torch.device,
                  warn_stacklevel: int = 3) -> List[List[Dict]]:
    """FB and FLB-NUB points through the event-round engine, one
    invocation per workload trace (event-round lane lengths differ per
    trace; every invocation batches the trace's sweep points)."""
    assert all(p.system in _SCANNABLE for p in points)
    _reject_preempt(points, "rounds")
    (fb_idx, flb_idx, fb, flb, fb_packs, flb_packs,
     fb_spec, flb_spec) = _pack_rounds(points, workloads, duration, options,
                                       device)
    outs = [roundslib.rounds_grids(
        fb, flb,
        fb_packs[w] if fb_packs is not None else None,
        flb_packs[w] if flb_packs is not None else None,
        fb_spec=fb_spec, flb_spec=flb_spec, devices=options.devices)
        for w in range(len(workloads))]
    with spans.span("sweep.rows", rows=len(workloads) * len(points)):
        with spans.span("sweep.wait"):
            out = {kind: {k: np.concatenate([o[kind][k].cpu().numpy()
                                             for o in outs])
                          for k in outs[0][kind]}
                   for kind in outs[0]}
        rows = _assemble_rows(points, fb_idx, flb_idx, out, len(workloads),
                              "rounds")
        _warn_diagnostics(rows, "rounds", stacklevel=warn_stacklevel)
    return rows


def _pack_scenarios_grids(points: List[SweepPoint], grid, synth,
                          options: ScanOptions, device: torch.device):
    """Setup stage of the generated-scenario path: one
    :func:`repro_torch.sim.scenarios.pack_scenarios` per policy (job
    tables, rise compression and the batched (W, P) fold tables are all
    array ops — no per-lane host loop; the fold follows the round step's
    backend, ``options.kernel``)."""
    fb_idx = [i for i, p in enumerate(points) if p.system == "fb"]
    flb_idx = [i for i, p in enumerate(points) if p.system == "flb_nub"]
    duration = float(grid.duration)
    changes = synth.ws_values[:, 1:] != synth.ws_values[:, :-1]
    n_ws = int(changes.sum(axis=1).max()) + 1

    fb = flb = fb_packed = flb_packed = fb_spec = flb_spec = None
    if fb_idx:
        with spans.span("sweep.pack", policy="fb"):
            leases = [points[i].lease_seconds for i in fb_idx]
            fb_spec = options.resolve_rounds("fb", leases, duration,
                                             grid.max_jobs, n_ws)
            fb_packed = scenarioslib.pack_scenarios(
                synth, fb_spec.window, "fb", leases,
                [float(points[i].capacity) for i in fb_idx],
                dtype=options.dtype, device=device, kernel=options.kernel)
            fb = _fb_grid(points, fb_idx, fb_packed.submit.dtype, device)
    if flb_idx:
        with spans.span("sweep.pack", policy="flb_nub"):
            leases = [points[i].lease_seconds for i in flb_idx]
            flb_spec = options.resolve_rounds("flb_nub", leases, duration,
                                              grid.max_jobs, n_ws)
            flb_packed = scenarioslib.pack_scenarios(
                synth, flb_spec.window, "flb_nub", leases,
                [float(points[i].lb_ws) for i in flb_idx],
                dtype=options.dtype, device=device, kernel=options.kernel)
            flb = _flb_grid(points, flb_idx, flb_packed.submit.dtype,
                            device)
    return (fb_idx, flb_idx, fb, flb, fb_packed, flb_packed, fb_spec,
            flb_spec)


def _sweep_rounds_generated(points: List[SweepPoint], grid,
                            options: ScanOptions, synth=None,
                            warn_stacklevel: int = 3,
                            device: compat.Device = None
                            ) -> List[List[Dict]]:
    """FB / FLB-NUB points over a generated scenario batch
    (:class:`repro_torch.sim.scenarios.ScenarioGrid`) through the
    event-round engine. Generated lanes share one dense WS grid and one
    job-table height, so the whole (W × P) batch of each policy runs as
    ONE ``rounds_grids`` call — one round-step launch per policy on a
    CUDA device. ``synth`` (a synthesized batch of ``grid``) skips the
    synthesis."""
    dev = compat.resolve_device(device)
    assert all(p.system in _SCANNABLE for p in points)
    _reject_preempt(points, "rounds")
    if synth is None:
        synth = scenarioslib.synthesize(grid, device=dev)
    (fb_idx, flb_idx, fb, flb, fb_packed, flb_packed, fb_spec,
     flb_spec) = _pack_scenarios_grids(points, grid, synth, options, dev)
    out = roundslib.rounds_grids(fb, flb, fb_packed, flb_packed,
                                 fb_spec=fb_spec, flb_spec=flb_spec,
                                 devices=options.devices)
    with spans.span("sweep.rows", rows=grid.n_lanes * len(points)):
        with spans.span("sweep.wait"):
            out = _to_numpy(out)
        rows = _assemble_rows(points, fb_idx, flb_idx, out, grid.n_lanes,
                              "rounds")
        _warn_diagnostics(rows, "rounds", stacklevel=warn_stacklevel)
    return rows


# --------------------------------------------------------------- the sweep

def _resolve_mode(mode: Optional[str], vectorize: bool) -> str:
    if mode is None:
        return "auto" if vectorize else "event"
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    return mode


def run_sweep(points: Sequence[SweepPoint], jobs: Sequence[Job],
              ws_trace: Sequence[Tuple[float, int]],
              duration: Optional[float] = None,
              vectorize: bool = True,
              mode: Optional[str] = None,
              scan_options: ScanOptions = ScanOptions(),
              devices=None, device: compat.Device = None) -> List[Dict]:
    """Evaluate every sweep point on the same (jobs, ws_trace) workload.

    Returns one row dict per point, in input order, each tagged with
    ``engine`` = ``"vectorized"``, ``"rounds"``, ``"scan"`` (mode
    ``"scan"`` only) or ``"event"``. ``mode``
    selects the paths (see the module docstring); the legacy
    ``vectorize=False`` flag equals ``mode="event"``. ``device`` is
    where the batched paths run: CUDA by default, the CPU only when
    asked for (``device="cpu"``).
    """
    return run_sweep_workloads(points, [(jobs, ws_trace)], duration,
                               vectorize=vectorize, mode=mode,
                               scan_options=scan_options, devices=devices,
                               device=device, _stack_offset=1)[0]


def run_sweep_workloads(points: Sequence[SweepPoint],
                        workloads: Sequence[Tuple[Sequence[Job],
                                                  Sequence[Tuple[float, int]]]],
                        duration: Optional[float] = None,
                        vectorize: bool = True,
                        mode: Optional[str] = None,
                        scan_options: ScanOptions = ScanOptions(),
                        devices=None, device: compat.Device = None,
                        _stack_offset: int = 0
                        ) -> List[List[Dict]]:
    """Evaluate a sweep grid over SEVERAL workload traces at once.

    Returns ``rows[w][i]`` — one row list per workload, aligned with
    ``points``. All workloads share one measurement horizon
    ``duration`` (§6.1) — the default is the latest horizon any
    workload implies. ``devices`` overrides ``scan_options.devices``.

    ``workloads`` may instead be a
    :class:`repro_torch.sim.scenarios.ScenarioGrid` — a generated
    scenario batch (per-lane seeds + parameter grids). The lanes then
    synthesize on the device, pack as ONE batch and run the event-round
    engine as one (W × P) program per policy; only FB / FLB-NUB points
    are supported, in mode ``"auto"`` or ``"rounds"``, and the grid
    fixes the horizon (``duration`` must be ``None`` or the grid's).

    ``_stack_offset`` (private) is the number of wrapper frames between
    the user's call site and this function, so diagnostic
    ``RuntimeWarning``\\ s name the caller's file.
    """
    dev = compat.resolve_device(device)
    mode = _resolve_mode(mode, vectorize)
    with spans.span("sweep", mode=mode) as sweep_span:
        # warnings.warn stack depth from inside _warn_diagnostics:
        # 1 = _warn_diagnostics, 2 = _sweep_*, 3 = this function,
        # 4 = our caller — plus any wrapper frames above us.
        warn_stacklevel = 4 + _stack_offset
        if devices is not None:
            scan_options = dataclasses.replace(scan_options, devices=devices)
        compat.resolve_devices(scan_options.devices)
        if isinstance(workloads, scenarioslib.ScenarioGrid):
            # Generated scenario batches (seeds + param grids, not
            # List[Job]) flow the event-round engine only: the lanes share
            # one dense WS grid and job-table height, so the whole (W × P)
            # batch is one program. The grid carries its own horizon.
            sweep_span.set(lanes=workloads.n_lanes * len(points))
            if mode not in ("auto", "rounds"):
                raise ValueError(
                    f"generated scenario batches run the rounds engine only "
                    f"(mode 'auto'/'rounds', got {mode!r})")
            if duration is not None and duration != workloads.duration:
                raise ValueError(
                    "duration is fixed by ScenarioGrid.duration — pass None")
            bad = sorted({p.system for p in points
                          if p.system not in _SCANNABLE})
            if bad:
                raise ValueError(
                    f"generated scenario batches support FB / FLB-NUB points "
                    f"only, got {bad}; evaluate DCS/EC2 baselines on "
                    f"sampled lanes (repro_torch.sim.scenarios."
                    f"sample_workloads)")
            return _sweep_rounds_generated(list(points), workloads,
                                           scan_options,
                                           warn_stacklevel=warn_stacklevel,
                                           device=dev)
        if not isinstance(workloads, (list, tuple)):
            raise ValueError(
                "workloads must be a list of (jobs, ws_trace) pairs or a "
                "ScenarioGrid")
        sweep_span.set(lanes=len(workloads) * len(points))
        if duration is None:
            duration = max(default_duration(jobs, ws)
                           for jobs, ws in workloads)
        rows: List[List[Optional[Dict]]] = [
            [None] * len(points) for _ in workloads]

        if mode != "event":
            dcs_idx = [i for i, p in enumerate(points) if p.system == "dcs"]
            ec2_idx = [i for i, p in enumerate(points) if p.system == "ec2"]
            for w, (jobs, ws_trace) in enumerate(workloads):
                if dcs_idx:
                    for i, row in zip(dcs_idx,
                                      _sweep_dcs([points[i] for i in dcs_idx],
                                                 duration)):
                        rows[w][i] = row
                if ec2_idx:
                    for i, row in zip(ec2_idx,
                                      _sweep_ec2([points[i] for i in ec2_idx],
                                                 jobs, ws_trace, duration,
                                                 dev)):
                        rows[w][i] = row

        if mode in ("auto", "scan", "rounds"):
            batch_idx = [i for i, p in enumerate(points)
                         if p.system in _SCANNABLE]
            if mode == "auto":
                # Points the rounds engine rejects (FB checkpoint_preempt)
                # take the per-point event path below instead of failing.
                batch_idx = [i for i in batch_idx
                             if not (points[i].system == "fb"
                                     and points[i].params.checkpoint_preempt)]
            fast = _sweep_scan if mode == "scan" else _sweep_rounds
            if batch_idx:
                fast_rows = fast([points[i] for i in batch_idx], workloads,
                                 duration, scan_options, dev,
                                 warn_stacklevel=warn_stacklevel)
                for w in range(len(workloads)):
                    for j, i in enumerate(batch_idx):
                        rows[w][i] = fast_rows[w][j]

        for w, (jobs, ws_trace) in enumerate(workloads):
            for i, p in enumerate(points):
                if rows[w][i] is not None:
                    continue
                r = run_sim(_build(p), clone_jobs(jobs), ws_trace, duration,
                            name=p.name())
                row = r.row()
                row.update(system_kind=p.system, engine="event",
                           lease_seconds=p.lease_seconds)
                rows[w][i] = row
        return rows                               # type: ignore[return-value]


def warmup_sweep(points: Sequence[SweepPoint],
                 workloads: Sequence[Tuple[Sequence[Job],
                                           Sequence[Tuple[float, int]]]],
                 duration: Optional[float] = None, *, mode: str = "rounds",
                 scan_options: ScanOptions = ScanOptions(),
                 devices=None, device: compat.Device = None) -> float:
    """Run one (grid, workloads, mode, options) configuration once and
    return its wall seconds. On a CUDA device the first call also builds
    the round-step kernel and warms PyTorch's caching allocator, which a
    steady-state call then never pays again."""
    t0 = time.time()
    run_sweep_workloads(points, workloads, duration, mode=mode,
                        scan_options=scan_options, devices=devices,
                        device=device, _stack_offset=1)
    if compat.resolve_device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.time() - t0


# ------------------------------------------------------------- paper grids

def paper_grid(prc_pbj: int, prc_ws: int = 128,
               capacity_fracs: Sequence[float] = (0.5, 0.6, 0.75, 0.9, 1.0),
               B_values: Sequence[int] = (13, 25, 51, 102, 154),
               lease_minutes: Sequence[int] = (15, 30, 60, 120, 240),
               fig18_B: int = 25, lb_ws: int = 12,
               params: PBJPolicyParams = PBJPolicyParams()
               ) -> List[SweepPoint]:
    """The Fig. 13 + Fig. 14 + Fig. 18 grids as one sweep (21 points).

    Fig. 13: FB capacity C as a fraction of the DCS configuration size
    (plus the DCS reference). Fig. 14: FLB-NUB pool size B. Fig. 18:
    lease unit L for both FLB-NUB and the EC2+RightScale baseline.
    """
    dcs_size = prc_pbj + prc_ws
    pts = [SweepPoint("dcs", prc_pbj=prc_pbj, prc_ws=prc_ws,
                      label=f"DCS({dcs_size})")]
    for f in capacity_fracs:
        c = int(round(dcs_size * f))
        pts.append(SweepPoint("fb", capacity=c, params=params,
                              label=f"FB(C={c})"))
    for B in B_values:
        w = min(lb_ws, B - 1)
        pts.append(SweepPoint("flb_nub", lb_pbj=B - w, lb_ws=w,
                              params=params, label=f"FLB-NUB(B={B})"))
    for m in lease_minutes:
        w = min(lb_ws, fig18_B - 1)
        pts.append(SweepPoint("flb_nub", lb_pbj=fig18_B - w, lb_ws=w,
                              lease_seconds=60.0 * m, params=params,
                              label=f"FLB-NUB(L={m}min)"))
        pts.append(SweepPoint("ec2", lease_seconds=60.0 * m,
                              label=f"EC2(L={m}min)"))
    return pts
