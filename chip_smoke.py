"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits nonzero):

  device           the card's name and power limit (nvidia-smi)
  build            nvcc build of the round_step kernel for sm_90a
  kernel_vs_plain  the FB and FLB-NUB lanes of paper_grid(128), packed
                   exactly as the sweep packs them (one pack per trace:
                   NASA iPSC and SDSC BLUE, each with WorldCup): the CUDA
                   round step against its plain PyTorch version from the
                   same state after EVERY chunk, float32 over two weeks
                   and float64 over a two-day slice; exact except the
                   three time integrals. Each line carries the kernel's
                   and the plain version's times at the middle chunk,
                   the bound and the kernel's serial-chain time
  sweep            run_sweep_workloads over paper_grid(128) on both
                   traces (two weeks, mode="rounds") through the kernel;
                   rows equal the plain version's on the card; the NASA
                   FB / FLB-NUB rows inside CONTRACTS["rounds"] against
                   the event engine
  headline         headline_queries() on the card: C = 135, FLB-NUB peak
                   660, EC2 peak 1075 (results/BENCH_capacity.json) and
                   the HEADLINE_CONTRACT gate
  kernels          the kernel table line (launches on the sweep, times)

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device
the script exits 1 and prints no result. It imports only ``torch``,
``numpy`` and ``repro_torch`` (from ``src/`` beside it); the CPU tests
(``tests/test_torch_*.py``) cover the plain path at small sizes.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import round_step as rsk  # noqa: E402
from repro_torch.sim import rounds as roundslib  # noqa: E402
from repro_torch.sim import traces  # noqa: E402
from repro_torch.sim.capacity import headline_queries  # noqa: E402
from repro_torch.sim.contracts import (CONTRACTS,  # noqa: E402
                                       HEADLINE_CONTRACT, check_fidelity)
from repro_torch.sim.engine import clone_jobs, run_sim  # noqa: E402
from repro_torch.sim.sweep import (ScanOptions, _build,  # noqa: E402
                                   _pack_rounds, paper_grid,
                                   run_sweep_workloads)

DAY = 24 * 3600.0
# Tolerance of the three order-dependent time integrals (turn_sum,
# exec_sum, node_seconds) by dtype; every other field is held exactly.
INTEGRAL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-6}
INTEGRAL_SC = [rsk.SC_ACC0 + roundslib.ACC_KEYS.index(k)
               for k in ("turn_sum", "exec_sum", "node_seconds")]
INTEGRAL_ROW = ("avg_turnaround", "avg_execution", "node_hours")
ROUNDS_SC = rsk.SC_ACC0 + roundslib.ACC_KEYS.index("rounds")
# H100 SXM published peaks (NVIDIA data sheet, 700 W) for the bound:
# HBM bandwidth and the non-tensor-core float32 / float64 rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}
# Table entries one active event round reads per lane: FB the rise time
# and value, the lease window's max and the tick demand; FLB-NUB the two
# fold-table entries.
TABLE_READS_PER_ROUND = {"fb": 4, "flb_nub": 2}
# aten ops the operation count takes: elementwise arithmetic, compares,
# logic and selects count their output elements; reductions and scans
# count their input elements. Copies, casts, views, gathers and stacks
# move data and count nothing.
ELEMENTWISE_OPS = {"add", "sub", "rsub", "mul", "div", "minimum", "maximum",
                   "clamp", "clamp_min", "clamp_max", "floor", "ceil",
                   "log2", "lt", "le", "gt", "ge", "eq", "ne", "bitwise_and",
                   "bitwise_or", "bitwise_not", "logical_and", "logical_or",
                   "logical_not", "where", "searchsorted"}
REDUCTION_OPS = {"sum", "amin", "amax", "min", "max", "argmax", "cumsum"}
# Barrier counts of the chain-cost probe; both timings are device-bound.
PROBE_STEPS = (1024, 5120)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cut(workloads, horizon):
    return [([j for j in jobs if j.submit < horizon],
             [(t, d) for t, d in ws if t < horizon]) for jobs, ws in workloads]


class OpCount(TorchDispatchMode):
    """Counts the operations of the PyTorch calls made under it (see
    ``ELEMENTWISE_OPS`` / ``REDUCTION_OPS``)."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in REDUCTION_OPS:
            self.ops += args[0].numel()
        elif name in ELEMENTWISE_OPS:
            self.ops += out.numel()
        return out


def launch_bound(policy, inputs, sc, win, spec, lane_rounds):
    """Least time one launch could take on these inputs: the larger of
    its bytes over HBM bandwidth and its operations over the dtype's peak
    rate. Bytes: the state in and out, the policy scalars, the job rows
    admitted into the slots that are not kept (plus the next row's submit
    per lane) and the table entries the ``lane_rounds`` active event
    rounds read. Operations: the plain version's own count for this
    launch (``OpCount``), which evaluates every round of every lane,
    scaled to the lane-rounds that were active. Returns ``(ms, bound_by,
    bytes, ops)``."""
    jobs, rises, wstab, prm = inputs
    e = sc.element_size()
    n_lanes, K = win.shape[0], win.shape[-1]
    admitted = n_lanes * K - int((win[:, rsk.WIN_DONE] == 0).sum())
    nbytes = e * (2 * sc.numel() + 2 * win.numel() + prm.numel()
                  + 3 * admitted + n_lanes
                  + TABLE_READS_PER_ROUND[policy] * lane_rounds)
    with OpCount() as count:
        rsk.chunk_step_ref(*inputs, sc, win, policy=policy, spec=spec)
    ops = count.ops * lane_rounds / (n_lanes * spec.compact_every)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[sc.dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def barrier_us(n_blocks, threads, dtype):
    """Measured cost of one barrier of the kernel's serial chain: the
    chain probe at the lanes' block shape, timed at two step counts."""
    out = torch.empty(n_blocks, threads, dtype=dtype, device="cuda")
    lo, hi = (time_calls(lambda: rsk.chain_probe(out, steps), 10)[0]
              for steps in PROBE_STEPS)
    return 1e3 * (hi - lo) / (2 * (PROBE_STEPS[1] - PROBE_STEPS[0]))


def compare_states(got, want, dtype, label):
    """Exact on every field but the three integrals (rtol by dtype).
    Returns the largest absolute difference seen."""
    (sc_k, win_k), (sc_p, win_p) = got, want
    exact = [i for i in range(rsk.SC_SIZE) if i not in INTEGRAL_SC]
    if not torch.equal(win_k, win_p):
        bad = (win_k != win_p).nonzero()[:4].tolist()
        raise AssertionError(f"{label}: window differs at {bad}")
    if not torch.equal(sc_k[:, exact], sc_p[:, exact]):
        bad = (sc_k[:, exact] != sc_p[:, exact]).nonzero()[:4].tolist()
        raise AssertionError(f"{label}: scalar state differs at {bad}: "
                             f"{sc_k[:, exact]} vs {sc_p[:, exact]}")
    torch.testing.assert_close(sc_k[:, INTEGRAL_SC], sc_p[:, INTEGRAL_SC],
                               rtol=INTEGRAL_RTOL[dtype], atol=0.0,
                               msg=label)
    return float((sc_k - sc_p).abs().max())


def time_calls(fn, n):
    """``(device ms, host ms)`` per call of ``fn`` over ``n`` back-to-back
    calls after one warm-up: CUDA events around the run (device time as
    long as the host enqueues faster than the device runs) and the host
    clock around the enqueue."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n, 1e3 * host_s / n


def kernel_device_ms(fn, n):
    """Mean device time of the round_step kernel per call of ``fn`` from
    a ``torch.profiler`` trace of ``n`` calls, or None when the trace
    holds no device time for it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if "chunk_kernel" in ev.key and ev.count and dev_us:
            return dev_us / 1e3 / ev.count
    return None


def sweep_lanes(workloads, horizon, dtype, device):
    """The FB and FLB-NUB lanes of paper_grid(128) as the sweep packs
    them: ``[(policy, trace index, grid, pack, spec), ...]``."""
    points = [p for p in paper_grid(128) if p.system in ("fb", "flb_nub")]
    opts = ScanOptions(dtype=np.float64 if dtype == torch.float64 else None)
    (_, _, fb, flb, fb_packs, flb_packs, fb_spec,
     flb_spec) = _pack_rounds(points, workloads, horizon, opts, device)
    return [(policy, w, grid, packs[w], spec)
            for policy, grid, packs, spec in (("fb", fb, fb_packs, fb_spec),
                                              ("flb_nub", flb, flb_packs,
                                               flb_spec))
            for w in range(len(workloads))]


def kernel_vs_plain(policy, trace, grid, pk, spec, horizon):
    """Run one trace's lanes of one policy chunk by chunk, as the sweep
    does: at every chunk the kernel and the plain version start from the
    same state; the plain result carries on for the live lanes. Then
    time both, and take the bound, at the state of the middle chunk."""
    prm = roundslib._rounds_prm_tree(policy, grid, 1)
    ctx = roundslib._lane_ctx(policy, prm, pk)
    sc, win = roundslib._startup(policy, ctx, spec, pk.ws0[prm["w_idx"]])
    inputs = rsk.lane_inputs(policy, ctx)
    outer_max = -(-spec.max_rounds // spec.compact_every)
    dur = torch.tensor(spec.duration, dtype=sc.dtype, device=sc.device)
    states, rounds_run = [], []
    max_err = 0.0
    label = f"{policy} {trace} {str(sc.dtype)[6:]}"
    for i in range(outer_max):
        live = sc[:, rsk.SC_T] < dur
        if not bool(live.any()):
            break
        states.append((sc, win))
        got = rsk.chunk_step(*inputs, sc, win, policy=policy, spec=spec)
        want = rsk.chunk_step_ref(*inputs, sc, win, policy=policy,
                                  spec=spec)
        max_err = max(max_err, compare_states(got, want, sc.dtype,
                                              f"{label} chunk {i}"))
        sc_n, win_n = want
        rounds_run.append(int((sc_n[:, ROUNDS_SC] - sc[:, ROUNDS_SC]).sum()))
        sc = torch.where(live[:, None], sc_n, sc)
        win = torch.where(live[:, None, None], win_n, win)
    mid = len(states) // 2
    mid_sc, mid_win = states[mid]

    def kernel():
        return rsk.chunk_step(*inputs, mid_sc, mid_win, policy=policy,
                              spec=spec)

    def plain():
        return rsk.chunk_step_ref(*inputs, mid_sc, mid_win, policy=policy,
                                  spec=spec)

    kernel_event_ms, kernel_host_ms = time_calls(kernel, 50)
    plain_ms, plain_host_ms = time_calls(plain, 5)
    # Back-to-back launches are host-bound (the wrapper enqueues no
    # faster than the kernel runs), so the kernel's own time comes from
    # the profiler; the event time is its upper bound.
    kernel_ms, kernel_ms_from = kernel_device_ms(kernel, 50), "profiler"
    if kernel_ms is None:
        kernel_ms, kernel_ms_from = kernel_event_ms, "events"
    bound_ms, bound_by, nbytes, ops = launch_bound(
        policy, inputs, mid_sc, mid_win, spec, rounds_run[mid])
    barriers = rsk.chain_barriers(policy, spec)
    threads = -(-win.shape[-1] // 32) * 32
    b_us = barrier_us(win.shape[0], threads, sc.dtype)
    return dict(policy=policy, trace=trace, dtype=str(sc.dtype)[6:],
                horizon_days=horizon / DAY, lanes=int(sc.shape[0]),
                window=int(win.shape[-1]), job_table=int(inputs[0].shape[-1]),
                chunks=len(states), lane_rounds=sum(rounds_run),
                kernel_ms_per_launch=kernel_ms, kernel_ms_from=kernel_ms_from,
                kernel_event_ms=kernel_event_ms,
                kernel_host_ms=kernel_host_ms, plain_ms_per_chunk=plain_ms,
                plain_host_ms=plain_host_ms, max_abs_err=max_err,
                mid_chunk=mid, mid_lane_rounds=rounds_run[mid],
                bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes,
                bound_ops=ops, chain_barriers=barriers, barrier_us=b_us,
                chain_ms=barriers * b_us / 1e3)


def rows_equal(a, b, rtol, label):
    for i, (ra, rb) in enumerate(zip(a, b)):
        for k in ra:
            if k in INTEGRAL_ROW:
                if not np.isclose(ra[k], rb[k], rtol=rtol, atol=0.0):
                    raise AssertionError(f"{label} row {i} {k}: {ra[k]} vs "
                                         f"{rb[k]}")
            elif ra[k] != rb[k]:
                raise AssertionError(f"{label} row {i} {k}: {ra[k]} vs "
                                     f"{rb[k]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    big, small = traces.TWO_WEEKS, 2 * DAY
    t_all = time.time()

    # --- device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())

    # --- build
    t0 = time.time()
    lib = rsk.build(verbose=True)
    emit("build", seconds=time.time() - t0, library=lib.name,
         flags=" ".join(rsk.NVCC_FLAGS))

    # --- kernel vs plain, chunk by chunk, on the sweep's own packs
    wc = traces.worldcup98(seed=0, peak_vms=128)
    workloads = [(traces.nasa_ipsc(seed=0), wc), (traces.sdsc_blue(seed=0),
                                                  wc)]
    trace_names = ("nasa_ipsc", "sdsc_blue")
    runs = []
    for wl, horizon, dtype in ((workloads, big, torch.float32),
                               (cut(workloads, small), small,
                                torch.float64)):
        for policy, w, grid, pk, spec in sweep_lanes(wl, horizon, dtype,
                                                     device):
            r = kernel_vs_plain(policy, trace_names[w], grid, pk, spec,
                                horizon)
            runs.append(r)
            emit("kernel_vs_plain", **r)

    # --- the main path: the paper-grid sweep through the kernel
    grid = paper_grid(128)
    rsk.chunk_step.launches = 0
    t0 = time.time()
    rows = run_sweep_workloads(grid, workloads, big, mode="rounds",
                               device=device)
    torch.cuda.synchronize()
    sweep_s = time.time() - t0
    launches = rsk.chunk_step.launches
    if launches == 0:
        raise AssertionError("the sweep launched no round_step kernel")
    # kernel_vs_plain stepped the same packs the same way.
    f32 = [r for r in runs if r["dtype"] == "float32"]
    if launches != sum(r["chunks"] for r in f32):
        raise AssertionError(f"the sweep made {launches} launches, the "
                             f"chunk-by-chunk check "
                             f"{sum(r['chunks'] for r in f32)}")
    t0 = time.time()
    plain = run_sweep_workloads(grid, workloads, big, mode="rounds",
                                device=device,
                                scan_options=ScanOptions(kernel="torch"))
    plain_s = time.time() - t0
    for w in range(len(workloads)):
        rows_equal(rows[w], plain[w], INTEGRAL_RTOL[torch.float32],
                   f"sweep workload {w}")
    t0 = time.time()
    nasa = workloads[0][0]
    event = [None if p.system not in ("fb", "flb_nub") else
             run_sim(_build(p), clone_jobs(nasa), wc, big,
                     name=p.name()).row() for p in grid]
    event_s = time.time() - t0
    violations = check_fidelity(
        [r if r["system_kind"] in ("fb", "flb_nub") else None
         for r in rows[0]], event)
    if violations:
        raise AssertionError(f"rounds contract violated: {violations}")
    emit("sweep", points=len(grid), workloads=len(workloads),
         horizon_days=big / DAY, kernel_launches=launches,
         wall_s=sweep_s, plain_wall_s=plain_s, event_wall_s=event_s,
         max_rounds=max(r.get("rounds", 0) for rs in rows for r in rs),
         contract=CONTRACTS["rounds"].__dict__, rows_nasa=rows[0])

    # --- headline queries
    t0 = time.time()
    hl = headline_queries(device=device)
    torch.cuda.synchronize()
    headline_s = time.time() - t0
    ref = json.loads((ROOT / "results" / "BENCH_capacity.json"
                      ).read_text())["headline"]
    for part, key in (("private", "min_fb_capacity"),
                      ("private", "dcs_size"), ("public", "flb_peak"),
                      ("public", "ec2_peak")):
        if hl[part][key] != ref[part][key]:
            raise AssertionError(f"headline {key}: {hl[part][key]} != "
                                 f"{ref[part][key]}")
    gate = HEADLINE_CONTRACT.check(hl["private"]["config_reduction"],
                                   hl["public"]["peak_reduction"])
    if gate or not hl["gate"]["ok"]:
        raise AssertionError(f"HEADLINE_CONTRACT: {gate}")
    emit("headline", wall_s=headline_s, **hl)

    # --- the kernel table line
    # Times and bounds at the main path's shapes: the float32 two-week
    # packs of both traces and policies, weighted by their launches.
    def per_launch(key):
        return sum(r[key] * r["chunks"] for r in f32) / launches

    bound_ms = per_launch("bound_ms")
    line = {"kernels": [{
        "name": "round_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/round_step.cu",
        "replaces": "src/repro/kernels/round_step.py:165",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in f32),
        "ms": per_launch("kernel_ms_per_launch"),
        "plain_ms": per_launch("plain_ms_per_chunk"),
        "bound_ms": bound_ms,
        # the term that bounds the larger share of the launches
        "bound_by": "bytes" if 2 * sum(
            r["chunks"] for r in f32 if r["bound_by"] == "bytes")
        >= launches else "operations",
        "library_ms": None,
    }]}
    emit("chain", chain_ms=per_launch("chain_ms"), bound_ms=bound_ms,
         note="serial chain of block barriers per launch x measured "
              "barrier cost, beside the bytes/operations bound")
    emit("done", wall_s=time.time() - t_all)
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
