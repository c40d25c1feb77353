"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits nonzero):

  device           the card's name and power limit (nvidia-smi)
  build            nvcc builds of the four kernels for sm_90a
                   (round_step, flash_attention, flash_decode, ssd_scan),
                   started together
  kernel_vs_plain  the FB and FLB-NUB lanes of paper_grid(128), packed
                   exactly as the sweep packs them (one pack per trace:
                   NASA iPSC and SDSC BLUE, each with WorldCup): the CUDA
                   round step against its plain PyTorch version from the
                   same state after EVERY chunk, float32 over two weeks
                   and float64 over a two-day slice; exact except the
                   three time integrals. First with coalescing off (batch
                   1), then with the contended-stretch coalescer on
                   (batch 8), where every pack must coalesce. Then the
                   engine's one-launch run of the same lanes
                   (round_step.run_rounds) against the per-chunk kernel
                   path: final states equal bit for bit, integrals too,
                   and each lane's outer steps equal. Each line carries
                   the one-step kernel's (CUDA events, calls queued
                   behind a spin) and the plain version's times at the
                   middle chunk, its bound and serial-chain time, and the
                   run's device time, bound and plain host-loop time
  sweep            run_sweep_workloads over paper_grid(128) on both
                   traces (two weeks, mode="rounds") through the kernel:
                   one launch per trace and policy, whose outer steps
                   equal the chunk-by-chunk check's; rows equal the plain
                   version's on the card; the NASA FB / FLB-NUB rows
                   inside CONTRACTS["rounds"] against the event engine;
                   the wall split into pack, startup and kernel (a call
                   of its own, each stage synchronized)
  sweep_coalesced  the same sweep with ScanOptions(coalesce=8) through
                   the kernel: launches and outer steps as the coalesced
                   chunk-by-chunk check's, completed jobs equal the
                   uncoalesced rows', the NASA rows inside
                   CONTRACTS["rounds"] against the same event rows;
                   launches, outer steps, max rounds, wall and its split
                   beside the uncoalesced sweep's (both walls timed again
                   after, in the other order)
  headline         headline_queries() on the card: C = 135, DCS 256,
                   FLB-NUB peak 660, EC2 peak 1075
                   (results/BENCH_capacity.json) and the
                   HEADLINE_CONTRACT gate; launches, outer steps and the
                   wall's split
  headline_coalesced
                   the same queries with ScanOptions(coalesce=8): the
                   same four answers and gate, its wall beside headline's
  attn_kernel_vs_plain, decode_kernel_vs_plain
                   gemma2-2b's attention at full width (8 / 4 heads of
                   256, softcap 50): flash attention at S 8192 and 4600,
                   flash decode at batch 8 over an 8192 cache at four
                   positions; window 4096 and none, float32 and bfloat16,
                   plus one case each whose scores reach the softcap, and
                   bfloat16 attention at the generate phase's prefill
                   shape (batch 8, S 4600); each against its plain
                   version on the same inputs (elementwise atol + rtol,
                   stated per dtype), with its device time (CUDA events
                   around calls queued behind a spin), the achieved
                   TFLOP/s (attention) or GB/s (decode) and the share of
                   the bound (float32 attention: of the 3 x TF32
                   tensor-core bound and of the CUDA cores'), the plain
                   version's time, one SDPA call's (softcap off; with a
                   window an explicit mask) and the bound
  serve            gemma2-2b at full width, float32: AutoscaledService of
                   Replicas sharing one Model, 8 requests of 500-6000
                   prompt tokens; all complete, 26 flash-attention
                   launches per admission, each admission's logits equal
                   a plain prefill's; a profile of one prefill and one
                   decode step
  generate         gemma2-2b, bfloat16: batch-8 prefill of 4600 tokens,
                   32 decode steps at one position through flash decode
                   (26 launches a step), teacher-forced against the
                   plain route (logits within 0.25, argmax agreement at
                   least 0.9); a profile of the prefill and of one step,
                   with the flash-attention (prefill) and flash-decode
                   (step) device ms as fields
  ssd_kernel_vs_plain
                   mamba2-130m's SSD scan at full width (24 heads, P 64,
                   N 128, chunk 128): batch 1 and 8 at L 4096, L 2048
                   with a nonzero start state, and the strongest decay
                   (a = -16 dt), float32 and bfloat16 x / B / C, each
                   against its plain version (elementwise atol + rtol,
                   stated per dtype); at L 512 also against the
                   token-by-token recurrence; device times of both
                   (CUDA events, calls queued behind a spin), the kernel
                   launches per call (a profiler trace; must be 1), the
                   bound (tensor cores: float32 at the 3 x TF32 rate,
                   with the CUDA cores' beside it) and, without a start
                   state, the chain's cost: the call's time less that of
                   the same chunks as rows of one chunk each
  serve_mamba      mamba2-130m at full width, float32: AutoscaledService
                   of Replicas sharing one Model, 8 requests of
                   512-4096 prompt tokens; all complete, 24 SSD launches
                   per admission, each admission's logits and SSM state
                   equal a plain prefill's; the longest prefill's device
                   split (SSD kernel ms)
  generate_mamba   mamba2-130m, bfloat16: batch-8 prefill of 4096 tokens
                   (24 SSD launches), 32 decode steps (plain tensor code,
                   as in the reference), teacher-forced against the plain
                   route (logits within 0.25, argmax agreement at least
                   0.9); the prefill's device split (SSD kernel ms)
  kernels          the kernel table line: each kernel's launches on its
                   path (sweep, serve, generate, generate_mamba), times,
                   bound; attention and decode one row per dtype on its
                   path (flash_attention_f32: serve, flash_attention_bf16
                   and flash_decode_bf16: generate; ssd_scan_bf16:
                   generate_mamba, ssd_scan_f32: serve_mamba); round_step per
                   one-launch run of the sweep, with its outer steps, the
                   one-step entry's time per launch and the same for the
                   coalesced sweep

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fak  # noqa: E402
from repro_torch.kernels import flash_decode as fdk  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import round_step as rsk  # noqa: E402
from repro_torch.kernels import ssd_scan as ssk  # noqa: E402
from repro_torch.models.mamba2 import dims as ssm_dims  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.autoscaler import AutoscaledService  # noqa: E402
from repro_torch.serving.engine import Request  # noqa: E402
from repro_torch.sim import rounds as roundslib  # noqa: E402
from repro_torch.sim import sweep as sweeplib  # noqa: E402
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
COALESCED_SC = rsk.SC_ACC0 + roundslib.ACC_KEYS.index("coalesced")
# The coalescing batch of the coalesced phases: the engine's recommended
# opt-in (the default stays 1, as in the JAX package).
COALESCE = roundslib.COALESCE_BATCH
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
# Clock cycles of the spin queued ahead of a timed run (about 25 ms on an
# H100): the host enqueues the timed calls while the device spins.
SPIN_CYCLES = 50_000_000


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


def run_bound(policy, inputs, sc0, win0, sc_end, spec, lane_rounds, ops):
    """Least time a one-launch run could take: the larger of its bytes
    over HBM bandwidth and its operations over the dtype's peak rate.
    Bytes: the state in and out once, the policy scalars, the job rows
    the run admitted (each read once) and the table entries its
    ``lane_rounds`` active event rounds read. Operations: ``ops``, the
    plain version's count per active lane-round (``launch_bound``) times
    the run's active lane-rounds. Returns ``(ms, bound_by)``."""
    e = sc0.element_size()
    K = win0.shape[-1]
    admitted = int((sc_end[:, rsk.SC_NEXT_ROW] - K).clamp_min(0).sum())
    nbytes = e * (2 * sc0.numel() + 2 * win0.numel() + inputs[3].numel()
                  + 3 * admitted + TABLE_READS_PER_ROUND[policy] * lane_rounds)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops * lane_rounds / PEAK_OPS_PER_S[sc0.dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


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


def queued_ms(fn, n):
    """Device ms per call of ``fn`` over ``n`` back-to-back calls: CUDA
    events around calls that the host enqueued while a spin kernel held
    the device, so the host's launch overhead does not count. Returns
    ``(ms, device_bound)``: ``device_bound`` is False when the spin ended
    before the host had enqueued every call, even at 16 times the spin;
    the time is then an upper bound."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for spin in (SPIN_CYCLES, 4 * SPIN_CYCLES, 16 * SPIN_CYCLES):
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        device_bound = not start.query()
        torch.cuda.synchronize()
        if device_bound:
            break
    return start.elapsed_time(stop) / n, device_bound


def sweep_lanes(workloads, horizon, dtype, device, coalesce=None):
    """The FB and FLB-NUB lanes of paper_grid(128) as the sweep packs
    them: ``[(policy, trace index, grid, pack, spec), ...]``."""
    points = [p for p in paper_grid(128) if p.system in ("fb", "flb_nub")]
    opts = ScanOptions(dtype=np.float64 if dtype == torch.float64 else None,
                       coalesce=coalesce)
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
    sc0, win0 = sc, win
    states, rounds_run = [], []
    max_err, plain_run_s = 0.0, 0.0
    label = f"{policy} {trace} {str(sc.dtype)[6:]} batch {spec.batch}"
    for i in range(outer_max):
        live = sc[:, rsk.SC_T] < dur
        if not bool(live.any()):
            break
        states.append((sc, win))
        got = rsk.chunk_step(*inputs, sc, win, policy=policy, spec=spec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = rsk.chunk_step_ref(*inputs, sc, win, policy=policy,
                                  spec=spec)
        torch.cuda.synchronize()
        plain_run_s += time.perf_counter() - t0
        max_err = max(max_err, compare_states(got, want, sc.dtype,
                                              f"{label} chunk {i}"))
        sc_n, win_n = want
        rounds_run.append(int((sc_n[:, ROUNDS_SC] - sc[:, ROUNDS_SC]).sum()))
        sc = torch.where(live[:, None], sc_n, sc)
        win = torch.where(live[:, None, None], win_n, win)
    lane_rounds = sum(rounds_run)
    sc_plain, win_plain = sc, win
    # The engine's path: the whole loop in one launch, from the same
    # startup state, against the per-chunk kernel path (the kernel's own
    # state carried, lanes frozen as the engine freezes them): equal bit
    # for bit, integrals too, with the same step count per lane.
    sc, win = sc0, win0
    steps = torch.zeros(sc.shape[0], dtype=torch.int32, device=sc.device)
    while True:
        live = (steps < outer_max) & (sc[:, rsk.SC_T] < dur)
        if not bool(live.any()):
            break
        sc_n, win_n = rsk.chunk_step(*inputs, sc, win, policy=policy,
                                     spec=spec)
        sc = torch.where(live[:, None], sc_n, sc)
        win = torch.where(live[:, None, None], win_n, win)
        steps = steps + live.to(torch.int32)

    def run():
        return rsk.run_rounds(*inputs, sc0, win0, policy=policy, spec=spec,
                              outer_max=outer_max)

    sc_r, win_r, steps_r = run()
    if not (torch.equal(sc_r, sc) and torch.equal(win_r, win)
            and torch.equal(steps_r, steps)):
        raise AssertionError(f"{label}: the one-launch run differs from the "
                             f"per-chunk kernel path")
    if int(steps.max()) != len(states):
        raise AssertionError(f"{label}: {int(steps.max())} outer steps, "
                             f"{len(states)} chunks")
    compare_states((sc_r, win_r), (sc_plain, win_plain), sc.dtype,
                   f"{label} run vs plain")
    run_ms, run_device_bound = queued_ms(run, 3)
    mid = len(states) // 2
    mid_sc, mid_win = states[mid]

    def kernel():
        return rsk.chunk_step(*inputs, mid_sc, mid_win, policy=policy,
                              spec=spec)

    def plain():
        return rsk.chunk_step_ref(*inputs, mid_sc, mid_win, policy=policy,
                                  spec=spec)

    # Back-to-back launches are host-bound (the wrapper enqueues no
    # faster than the kernel runs), so the kernel's own time is taken
    # with the calls queued behind a spin.
    kernel_ms, device_bound = queued_ms(kernel, 50)
    kernel_host_ms = time_calls(kernel, 50)[1]
    plain_ms, plain_host_ms = time_calls(plain, 5)
    bound_ms, bound_by, nbytes, ops = launch_bound(
        policy, inputs, mid_sc, mid_win, spec, rounds_run[mid])
    ops_per_lane_round = ops / max(rounds_run[mid], 1)
    run_bound_ms, run_bound_by = run_bound(policy, inputs, sc0, win0, sc_r,
                                           spec, lane_rounds,
                                           ops_per_lane_round)
    barriers = rsk.chain_barriers(policy, spec)
    threads = -(-win.shape[-1] // 32) * 32
    b_us = barrier_us(win.shape[0], threads, sc.dtype)
    return dict(policy=policy, trace=trace, dtype=str(sc.dtype)[6:],
                batch=spec.batch, coalesced=float(sc[:, COALESCED_SC].sum()),
                horizon_days=horizon / DAY, lanes=int(sc.shape[0]),
                window=int(win.shape[-1]), job_table=int(inputs[0].shape[-1]),
                chunks=len(states), lane_rounds=lane_rounds,
                kernel_ms_per_launch=kernel_ms, ms_device_bound=device_bound,
                kernel_host_ms=kernel_host_ms, plain_ms_per_chunk=plain_ms,
                plain_host_ms=plain_host_ms, max_abs_err=max_err,
                mid_chunk=mid, mid_lane_rounds=rounds_run[mid],
                bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes,
                bound_ops=ops, chain_barriers=barriers, barrier_us=b_us,
                chain_ms=barriers * b_us / 1e3,
                run_equals_chunks=True, run_ms=run_ms,
                run_ms_device_bound=run_device_bound,
                run_ms_per_step=run_ms / len(states),
                plain_run_ms=1e3 * plain_run_s, run_bound_ms=run_bound_ms,
                run_bound_by=run_bound_by)


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


# ------------------------------------------------ the serving slice (LM)

# gemma2-2b at full width: 26 layers (local window 4096 / global
# alternating), d 2304, 8 q heads / 4 kv heads of 256, vocab 256000.
LM_ARCH = "gemma2_2b"
LM_SEED = 0
# Kernel vs plain version on the same CUDA inputs, elementwise
# |got - want| <= atol + rtol * |want|, as (atol, rtol). float32: the
# kernels sum in another order than the plain einsums, over up to 8192
# keys; against a float64 version the plain one is off by about 1e-6 on
# unit-scale scores and 2.5e-5 on the softcap case (CPU check at S 4600).
# bfloat16: both compute in float32 and round the output once, so they
# can differ only where the two roundings fall on either side of a
# boundary: one bfloat16 ulp, at most 2^-7 of the value (two ulps fail).
KERNEL_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-5, 1e-2)}
# The softcap case: q scaled so the scores (else about N(0, 1)) reach
# the cap of 50, about N(0, 40^2) before it. Without the cap the softmax
# is nearly one-hot; with it the few keys that saturate near 50 share
# it. The plain version without the cap must fail the tolerance there,
# so a kernel that skipped the cap would too.
CAP_Q_SCALE = 40.0
# Peak rates for the bound (H100 SXM data sheet, 700 W). Attention and
# the SSD scan run on the tensor cores: bfloat16 at the dense rate (989
# TFLOP/s), float32 as three TF32 products per float32 product at the
# dense TF32 rate (495 TFLOP/s), a third of that in counted work; their
# float32 cases also report the CUDA cores' float32 rate (67 TFLOP/s),
# the bound of the port's first kernels. Decode computes float32 on the
# CUDA cores.
CUDA_CORE_FLOPS = 67e12
TENSOR_PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
CORE_PEAK_FLOPS = {torch.float32: CUDA_CORE_FLOPS, torch.bfloat16: 989e12}
ATTN_SEQS = (8192, 4600)          # 4600: ragged (not a multiple of 64)
ATTN_WINDOWS = (4096, None)       # gemma2's local and global layers
DECODE_BATCH, DECODE_CACHE = 8, 8192
DECODE_POSITIONS = (1000, 4616, 6000, 8191)   # 4616: the generate phase's
DECODE_CAP_POS = 6000
# Serving: float32 weights and compute (the Replica default).
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW = 4, 8192, 16
SERVE_PROMPTS = tuple(int(x) for x in np.linspace(500, 6000, 8))
# An admission's prefill logits, kernel path vs plain path, float32:
# logits are O(1) (unit-rms hidden state against a d^-1/2 embedding);
# 26 layers of float32 arithmetic summed in two orders differ by about
# 1e-5 (measured on one H100).
SERVE_TOL = 1e-4
# Generate: bfloat16 weights and compute, as the serving cells build them.
GEN_BATCH, GEN_PROMPT, GEN_STEPS = 8, 4600, 32
# Per-step logits, kernel route vs plain route, bfloat16: the plain path
# rounds scores and probabilities to bfloat16 in every layer (the kernel
# keeps them in float32), so the routes drift apart by bf16 noise, about
# 0.1 on logits of unit scale on one H100. The greedy token must agree
# on at least GEN_MIN_AGREEMENT of the (row, step) pairs.
GEN_TOL = 0.25
GEN_MIN_AGREEMENT = 0.9

# The Mamba2 slice: mamba2-130m at full width (24 layers, d 768, 24 SSM
# heads of 64, state 128, vocab 50280), chunk 128.
SSM_ARCH = "mamba2_130m"
SSD_CHUNK = 128
# SSD kernel vs plain version, elementwise |got - want| <= atol + rtol *
# |want| as (atol, rtol). float32: the reference's own tolerance for its
# largest SSD case (tests/test_kernels.py); the kernel sums in another
# order (up to 7.4e-5 apart at batch 8, L 4096 on one H100). bfloat16 x
# / B / C: both compute y in float32 and round it once, so the float32
# atol (near y = 0 the two float32 sums differ by more than a bfloat16
# ulp of y) plus one bfloat16 ulp (rtol 2^-7 < 1e-2); the final state is
# float32 in both cases.
SSD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-4, 1e-2)}
SSD_STATE_TOL = (1e-4, 1e-4)
# (batch, L, nonzero start state, strongest decay); cases up to
# SSD_SEQ_MAX tokens are also held against the token-by-token ssd_ref.
SSD_CASES = ((1, 4096, False, False), (8, 4096, False, False),
             (1, 2048, True, False), (1, 2048, False, True),
             (1, 512, False, False))
SSD_SEQ_MAX = 512
# serve_mamba: prompts of 512-4096 tokens (multiples of the chunk). An
# admission's SSM states (float32, entries of O(10) after 24 layers)
# against a plain prefill's, elementwise atol + rtol * |want|: the SSD
# state tolerance, since the kernel and the plain scan sum in two orders.
SSM_PROMPTS = tuple(int(x) for x in np.linspace(512, 4096, 8))
# generate_mamba: bfloat16, batch 8, a 4096-token prefill.
GEN_SSM_BATCH, GEN_SSM_PROMPT = 8, 4096


def visible_pairs(s, window):
    """(query, key) pairs causal attention with ``window`` evaluates."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def bound(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def compare(got, want, dtype):
    """The kernel's output against the plain version's under
    ``KERNEL_TOL``."""
    return errors(got, want, *KERNEL_TOL[dtype])


def errors(got, want, atol, rtol):
    """Max abs and relative (Frobenius) error of ``got`` against
    ``want``, and whether every element lies within atol + rtol *
    |want|."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return dict(max_abs_err=float(d.max()),
                rel_err=float(d.norm() / w.norm()),
                within_tol=bool((d <= atol + rtol * w.abs()).all()),
                tol={"atol": atol, "rtol": rtol})


def attn_case(cfg, s, window, dtype, device, gen, q_scale=1.0, batch=1):
    """flash_attention_bkv vs flash_attention_ref at ``batch``, causal;
    q scaled by ``q_scale``."""
    h, kv, hd = (batch * cfg.n_heads, batch * cfg.n_kv_heads,
                 cfg.head_dim_)
    q, k, v = ((torch.randn(n, s, hd, generator=gen, device=device) * f)
               .to(dtype) for n, f in ((h, q_scale), (kv, 1.0), (kv, 1.0)))
    cap = cfg.attn_softcap

    def kernel():
        return fak.flash_attention_bkv(q, k, v, window=window, softcap=cap)

    def plain():
        return kref.flash_attention_ref(q, k, v, window=window, softcap=cap)

    got, want = kernel(), plain()
    check = compare(got, want, dtype)
    if q_scale != 1.0:
        check["no_cap_within_tol"] = compare(got, kref.flash_attention_ref(
            q, k, v, window=window), dtype)["within_tol"]
    # library: one SDPA call, softcap off (no PyTorch call computes the
    # softcapped function), model layout (b, heads, s, hd). With a window
    # SDPA takes an explicit mask, which rules out its flash backend: a
    # weaker yardstick than its is_causal time without one.
    ql, kl, vl = (x.reshape(batch, -1, s, hd) for x in (q, k, v))
    mask = None if window is None else \
        window_mask(s, window, device)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)

    ms, device_bound = queued_ms(kernel, 3)
    pairs = visible_pairs(s, window)
    nbytes = q.element_size() * 2 * (q.numel() + k.numel())
    flops = 4 * hd * pairs * h
    bound_ms, bound_by = bound(nbytes, flops, TENSOR_PEAK_FLOPS[dtype])
    if dtype == torch.float32:
        core_ms = 1e3 * flops / CUDA_CORE_FLOPS
        check.update(cuda_core_bound_ms=core_ms,
                     cuda_core_bound_fraction=core_ms / ms)
    out = dict(seq=s, window=window, dtype=str(dtype)[6:], batch=batch,
               heads=h // batch, kv_heads=kv // batch, head_dim=hd,
               softcap=cap, q_scale=q_scale, **check, ms=ms,
               ms_device_bound=device_bound, tflop_per_s=flops / ms / 1e9,
               bound_fraction=bound_ms / ms,
               plain_ms=queued_ms(plain, 2)[0],
               library_ms=queued_ms(library, 3)[0],
               library="scaled_dot_product_attention(enable_gqa=True), "
                       "softcap off", bound_ms=bound_ms, bound_by=bound_by,
               bound_bytes=nbytes, bound_flops=flops, visible_pairs=pairs)
    del q, k, v, got, want, mask
    return out


def window_mask(s, window, device):
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(s, device=device)[None, :]
    return (cols <= rows) & (cols > rows - window)


def decode_case(cfg, pos, window, dtype, device, gen, q_scale=1.0):
    """flash_decode_bkv vs flash_decode_ref at batch 8 over an 8192
    cache; q scaled by ``q_scale``."""
    kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim_
    bkv = DECODE_BATCH * kv
    q = (torch.randn(bkv, g, hd, generator=gen, device=device)
         * q_scale).to(dtype)
    k, v = (torch.randn(bkv, DECODE_CACHE, hd, generator=gen,
                        device=device).to(dtype) for _ in range(2))
    at = torch.tensor(pos, dtype=torch.int32, device=device)
    cap = cfg.attn_softcap

    def kernel():
        return fdk.flash_decode_bkv(q, k, v, at, window=window, softcap=cap)

    def plain():
        return kref.flash_decode_ref(q, k, v, at, window=window, softcap=cap)

    got, want = kernel(), plain()
    check = compare(got, want, dtype)
    if q_scale != 1.0:
        check["no_cap_within_tol"] = compare(got, kref.flash_decode_ref(
            q, k, v, at, window=window), dtype)["within_tol"]
    cols = torch.arange(DECODE_CACHE, device=device)
    valid = cols <= pos
    if window is not None:
        valid &= cols > pos - window
    ql = q.reshape(DECODE_BATCH, kv * g, 1, hd)
    kl = k.reshape(DECODE_BATCH, kv, DECODE_CACHE, hd)
    vl = v.reshape(DECODE_BATCH, kv, DECODE_CACHE, hd)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=valid[None, :], enable_gqa=True)

    ms, device_bound = queued_ms(kernel, 20)
    n_vis = int(valid.sum())
    nbytes = k.element_size() * 2 * bkv * n_vis * hd \
        + 2 * q.element_size() * q.numel()
    flops = 4 * hd * n_vis * bkv * g
    bound_ms, bound_by = bound(nbytes, flops, CORE_PEAK_FLOPS[dtype])
    out = dict(pos=pos, window=window, dtype=str(dtype)[6:],
               batch=DECODE_BATCH, kv_heads=kv, group=g, head_dim=hd,
               cache=DECODE_CACHE, softcap=cap, q_scale=q_scale, **check,
               ms=ms, ms_device_bound=device_bound,
               gb_per_s=nbytes / ms / 1e6, bound_fraction=bound_ms / ms,
               plain_ms=queued_ms(plain, 5)[0],
               library_ms=queued_ms(library, 20)[0],
               library="scaled_dot_product_attention(enable_gqa=True, "
                       "attn_mask), softcap off", bound_ms=bound_ms,
               bound_by=bound_by, bound_bytes=nbytes, bound_flops=flops,
               visible_keys=n_vis)
    del q, k, v, got, want
    return out


def check_cases(phase, cases):
    for c in cases:
        emit(phase, **c)
    bad = [c for c in cases if not c["within_tol"]]
    if bad:
        raise AssertionError(f"{phase}: kernel differs from its plain "
                             f"version beyond tolerance: {bad}")
    blind = [c for c in cases if c.get("no_cap_within_tol")]
    if blind:
        raise AssertionError(f"{phase}: the softcap case does not tell a "
                             f"capped from an uncapped result: {blind}")


def zero_counts():
    rsk.run_rounds.launches = 0
    rsk.zero_outer_steps()
    rsk.chunk_step.launches = 0
    fak.flash_attention_bkv.launches = 0
    fdk.flash_decode_bkv.launches = 0
    ssk.ssd_scan_bh.launches = 0


def read_counts():
    """Launches of each kernel since ``zero_counts``: ``round_step`` the
    engine's one-launch runs, ``round_step_chunk`` the one-step entry."""
    return {"round_step": rsk.run_rounds.launches,
            "round_step_chunk": rsk.chunk_step.launches,
            "flash_attention": fak.flash_attention_bkv.launches,
            "flash_decode": fdk.flash_decode_bkv.launches,
            "ssd_scan": ssk.ssd_scan_bh.launches}


# The stages of a rounds sweep that wall_split times: the host pack of
# the traces into tensors on the card, the lanes' startup (their tables,
# the kernel's stacked inputs and the t = 0 round) and the kernel.
SPLIT_STAGES = (("pack", sweeplib, "_pack_rounds"),
                ("startup", roundslib, "_lane_ctx"),
                ("startup", roundslib, "_startup"),
                ("startup", rsk, "lane_inputs"),
                ("kernel", rsk, "run_rounds"))


def wall_split(fn):
    """Where one call of ``fn`` (a sweep or the headline queries) spends
    its wall: each stage of ``SPLIT_STAGES`` is wrapped with a
    synchronize on both sides and its host wall summed; ``other_s`` is
    the rest (DCS / EC2 rows, row assembly, copies to the host). The
    synchronizes take away any overlap of host and device, so this is a
    call of its own, beside the unwrapped wall."""
    spent = {"pack": 0.0, "startup": 0.0, "kernel": 0.0}
    saved = []

    def wrap(stage, orig):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            spent[stage] += time.perf_counter() - t0
            return out
        # run_rounds counts into the attribute its module name holds
        if hasattr(orig, "launches"):
            timed.launches = orig.launches
        return timed

    for stage, module, name in SPLIT_STAGES:
        orig = getattr(module, name)
        saved.append((module, name, orig))
        setattr(module, name, wrap(stage, orig))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for module, name, orig in saved:
            if hasattr(orig, "launches"):
                orig.launches = getattr(module, name).launches
            setattr(module, name, orig)
    return dict(wall_s=wall, **{f"{k}_s": v for k, v in spent.items()},
                other_s=wall - sum(spent.values()))


def breakdown(fn, sum_of=None):
    """Where one call of ``fn`` spends its time: its host wall (host
    clock around the call and a synchronize, after a warm-up call), the
    device time of all its kernels from a ``torch.profiler`` trace of a
    second call (None when the trace holds none), the busy share
    device / wall, the five kernels with the most device time, and for
    each ``key: name part`` of ``sum_of`` the device ms of the kernels
    whose name holds that part, under ``key``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue              # host ops: their kernels are listed too
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us:
            per_kernel[ev.key[:80]] = us / 1e3
    device_ms = sum(per_kernel.values()) or None
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms if device_ms else None,
                top_kernels_ms=top,
                **{key: sum(ms for name, ms in per_kernel.items()
                            if part in name)
                   for key, part in (sum_of or {}).items()})


def kernel_launches(fn, part, calls=3, tries=5):
    """Device kernels whose name holds ``part`` per call of ``fn``, from a
    ``torch.profiler`` trace of host and device over ``calls`` calls, as
    ``breakdown`` takes it. A trace that holds no device kernel at all
    (now and then one does on an H100) is taken again, up to ``tries``
    times; then the count was not measured, and this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA]
        if events:
            return sum(ev.count for ev in events if part in ev.key) / calls
    raise AssertionError(f"{tries} profiler traces of {calls} calls held no "
                         f"device kernel: the launches were not counted")


# The prefill profiles' device ms of the model kernels, by name part.
PREFILL_KERNELS = {"flash_attention_ms": "flash_fwd", "ssd_scan_ms": "ssd_"}


def ssm_states(cache):
    """The Mamba layers' SSM states of a cache (none for attention)."""
    return {name: layer["state"].clone() for name, layer in cache.items()
            if "state" in layer}


def serve_phase(cfg, device, phase, prompts, max_len, kernel):
    """The serving path at full width: AutoscaledService of Replicas that
    share one float32 model, one request per prompt length; ``kernel``
    launches once per layer of each admission's prefill."""
    model = Model(cfg, device, compute_dtype=torch.float32).init(LM_SEED)
    prefills = []
    prefill = model.prefill

    def recording_prefill(batch, cache):
        t0 = time.perf_counter()
        logits, cache = prefill(batch, cache)
        torch.cuda.synchronize()
        prefills.append((batch["tokens"], logits, ssm_states(cache),
                         time.perf_counter() - t0))
        return logits, cache

    model.prefill = recording_prefill
    rng = np.random.default_rng(LM_SEED)
    requests = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=n)
                        .astype(np.int32), max_new_tokens=SERVE_NEW)
                for i, n in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    svc = AutoscaledService(cfg, device, slots_per_replica=SERVE_SLOTS,
                            max_len=max_len, params=model)
    for r in requests:
        svc.submit(r, now=0.0)
    trace = []
    for tick in range(4 * SERVE_NEW):
        svc.tick(now=float(tick))
        trace.append(len(svc.replicas))
        if not svc.queue and all(r.n_active == 0 for r in svc.replicas):
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    del model.prefill
    if len(svc.completed) != len(requests):
        raise AssertionError(f"{phase}: {len(svc.completed)} of "
                             f"{len(requests)} requests completed")
    if len(prefills) != len(requests) or any(
            n != (cfg.n_layers * len(prefills) if k == kernel else 0)
            for k, n in counts.items()):
        raise AssertionError(f"{phase}: {counts} launches for "
                             f"{len(prefills)} admissions")
    tokens = sum(len(r.output) for r in svc.completed)
    replicas = max(trace)
    del svc
    torch.cuda.empty_cache()
    # Each admission's logits (and SSM states) against a plain prefill of
    # its prompt.
    plain = model.with_impl("torch")
    errs, state_errs = [], []
    for toks, logits, states, _ in prefills:
        cache = plain.init_cache(1, toks.shape[1], dtype=torch.float32)
        want, cache = plain.prefill({"tokens": toks}, cache)
        errs.append(float((logits - want).abs().max()))
        want_states = ssm_states(cache)
        state_errs += [errors(states[k], want_states[k], *SSD_STATE_TOL)
                       for k in states]
        del cache, want
    # Where a serving step's time goes: the longest admission's prefill
    # through the kernels, and one decode step of a full replica (4 slots
    # at their own positions).
    toks = prefills[-1][0]
    prefill_profile = breakdown(lambda: model.prefill(
        {"tokens": toks}, model.init_cache(1, toks.shape[1],
                                           dtype=torch.float32)),
        sum_of=PREFILL_KERNELS)
    cache = model.init_cache(SERVE_SLOTS, max_len, dtype=torch.float32)
    slot_pos = torch.as_tensor(prompts[-SERVE_SLOTS:], device=device)
    slot_tok = torch.zeros(SERVE_SLOTS, 1, dtype=torch.long, device=device)
    step_profile = breakdown(lambda: model.decode(slot_tok, cache, slot_pos))
    del cache
    out = dict(arch=cfg.name, dtype="float32", requests=len(requests),
               prompts=list(prompts), max_new_tokens=SERVE_NEW,
               slots_per_replica=SERVE_SLOTS, max_len=max_len,
               completed=len(requests), tokens=tokens, wall_s=wall,
               tokens_per_s=tokens / wall, prefill_s=sum(p[3] for p in
                                                         prefills),
               prefill_s_each=[p[3] for p in prefills],
               max_replicas=replicas, instance_trace=trace,
               peak_memory_gb=peak / 1e9, launches=counts,
               prefill_max_abs_err=errs, tol=SERVE_TOL,
               prefill_profile=prefill_profile, step_profile=step_profile)
    if state_errs:
        out.update(state_max_abs_err=[e["max_abs_err"] for e in state_errs],
                   state_rel_err=[e["rel_err"] for e in state_errs],
                   state_tol=state_errs[0]["tol"])
    emit(phase, **out)
    if not max(errs) <= SERVE_TOL:
        raise AssertionError(f"{phase}: prefill logits differ from the "
                             f"plain path: {errs}")
    if not all(e["within_tol"] for e in state_errs):
        raise AssertionError(f"{phase}: SSM states differ from the plain "
                             f"path: {state_errs}")
    del model, plain, prefills
    torch.cuda.empty_cache()
    return out


def generate_phase(cfg, device, phase, batch, prompt, cache_len, expected):
    """The decode cell's path: bfloat16 weights and compute, a batch
    prefill of ``prompt`` tokens, then GEN_STEPS decode steps at one
    scalar position; the plain route replays the same tokens
    (teacher-forced). ``expected``: the launches of each kernel."""
    model = Model(cfg, device, compute_dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16).init(LM_SEED)
    rng = np.random.default_rng(LM_SEED + 1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt)),
                           device=device)
    zero_counts()
    t0 = time.perf_counter()
    cache = model.init_cache(batch, cache_len, dtype=torch.bfloat16)
    lg0, cache = model.prefill({"tokens": toks}, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pos = torch.tensor(prompt, device=device)
    nxt = torch.argmax(lg0[:, -1], dim=-1)
    fed, logits = [], []
    t1 = time.perf_counter()
    for _ in range(GEN_STEPS):
        fed.append(nxt)
        lg, cache = model.decode(nxt[:, None], cache, pos)
        logits.append(lg[:, 0])
        nxt = torch.argmax(lg[:, 0], dim=-1)
        pos = pos + 1
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    counts = read_counts()
    if any(counts[k] != expected.get(k, 0) for k in counts):
        raise AssertionError(f"{phase}: launches {counts}, expected "
                             f"{expected}")
    step_profile = breakdown(lambda: model.decode(nxt[:, None], cache, pos),
                             sum_of={"flash_decode_ms": "decode_"})
    del cache
    torch.cuda.empty_cache()
    prefill_profile = breakdown(lambda: model.prefill(
        {"tokens": toks}, model.init_cache(batch, cache_len,
                                           dtype=torch.bfloat16)),
        sum_of=PREFILL_KERNELS)
    torch.cuda.empty_cache()
    plain = model.with_impl("torch")
    cache = plain.init_cache(batch, cache_len, dtype=torch.bfloat16)
    lp0, cache = plain.prefill({"tokens": toks}, cache)
    pos = torch.tensor(prompt, device=device)
    errs, means, agree = [], [], []
    for tok, lg in zip(fed, logits):
        lp, cache = plain.decode(tok[:, None], cache, pos)
        d = (lg.float() - lp[:, 0].float()).abs()
        errs.append(float(d.max()))
        means.append(float(d.mean()))
        agree.append(float((torch.argmax(lp[:, 0], -1) ==
                            torch.argmax(lg, -1)).float().mean()))
        pos = pos + 1
    prefill_err = float((lg0.float() - lp0.float()).abs().max())
    out = dict(arch=cfg.name, dtype="bfloat16", batch=batch,
               prompt=prompt, steps=GEN_STEPS, cache=cache_len,
               prefill_s=prefill_s, decode_s=decode_s,
               decode_ms_per_step=1e3 * decode_s / GEN_STEPS,
               tokens_per_s=batch * GEN_STEPS / decode_s,
               launches=counts,
               prefill_flash_attention_device_ms=prefill_profile[
                   "flash_attention_ms"],
               prefill_ssd_scan_device_ms=prefill_profile["ssd_scan_ms"],
               step_flash_decode_device_ms=step_profile["flash_decode_ms"],
               prefill_max_abs_err=prefill_err,
               step_max_abs_err=max(errs), step_mean_abs_err=max(means),
               argmax_agreement=sum(agree) / len(agree), tol=GEN_TOL,
               min_argmax_agreement=GEN_MIN_AGREEMENT,
               prefill_profile=prefill_profile, step_profile=step_profile)
    emit(phase, **out)
    if not max(errs + [prefill_err]) <= GEN_TOL:
        raise AssertionError(f"{phase}: logits differ from the plain "
                             f"route beyond {GEN_TOL}: {errs}")
    if not out["argmax_agreement"] >= GEN_MIN_AGREEMENT:
        raise AssertionError(f"{phase}: argmax agreement "
                             f"{out['argmax_agreement']} below "
                             f"{GEN_MIN_AGREEMENT}")
    del model, plain, cache
    torch.cuda.empty_cache()
    return out


def ssd_case(cfg, batch, seq, dtype, device, gen, with_s0=False,
             strong_decay=False, sequential=False):
    """ssd_scan_bh vs ssd_scan_bh_ref at the model's heads, head dim and
    state, inputs scaled as the reference's tests scale them; with
    ``sequential``, both also against the token-by-token ssd_ref."""
    _, nh, n = ssm_dims(cfg)
    p, bh, q = cfg.ssm_head_dim, batch * nh, SSD_CHUNK

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    x = (0.5 * randn(bh, seq, p)).to(dtype)
    if strong_decay:
        # dt·A with A = -16 (A_log = log 16, the last head) and dt in
        # [0.5, 1.5): the upper triangle's exponents overflow to inf.
        a = -16.0 * (0.5 + torch.rand(bh, seq, generator=gen, device=device))
    else:
        a = -torch.nn.functional.softplus(randn(bh, seq))
    B, C = ((0.3 * randn(bh, seq, n)).to(dtype) for _ in range(2))
    s0 = 0.3 * randn(bh, p, n) if with_s0 else None

    def kernel():
        return ssk.ssd_scan_bh(x, a, B, C, s0=s0, chunk=q)

    def plain():
        return kref.ssd_scan_bh_ref(x, a, B, C, s0=s0, chunk=q)

    (y, sT), (want_y, want_s) = kernel(), plain()
    check = errors(y, want_y, *SSD_TOL[dtype])
    state = errors(sT, want_s, *SSD_STATE_TOL)
    check.update(state_max_abs_err=state["max_abs_err"],
                 state_rel_err=state["rel_err"], state_tol=state["tol"])
    check["within_tol"] &= state["within_tol"]
    if sequential:
        seq_y, seq_s = kref.ssd_ref(x, a, B, C, s0)
        for got, want, tol, key in ((y, seq_y, SSD_TOL[dtype], "seq"),
                                    (sT, seq_s, SSD_STATE_TOL, "seq_state")):
            e = errors(got, want, *tol)
            check[f"{key}_max_abs_err"] = e["max_abs_err"]
            check["within_tol"] &= e["within_tol"]
    ms, device_bound = queued_ms(kernel, 5)
    if s0 is None and seq > q:
        # What the chain costs: the same chunks, each a row of its own (no
        # wait, no hand-off read), against the chained call.
        xs, as_, Bs, Cs = (t.reshape(-1, q, *t.shape[2:])
                           for t in (x, a, B, C))
        unchained = queued_ms(
            lambda: ssk.ssd_scan_bh(xs, as_, Bs, Cs, chunk=q), 5)[0]
        check.update(unchained_ms=unchained, chain_ms=ms - unchained)
        del xs, as_, Bs, Cs
    # Per chunk: C·Bᵀ and (C·Bᵀ∘L)·x over the Q(Q+1)/2 pairs the mask
    # keeps, C·Sᵀ and (x∘w)ᵀ·B in full.
    pairs = q * (q + 1) // 2
    flops = bh * (seq // q) * (2 * pairs * (n + p) + 4 * q * n * p)
    e = x.element_size()
    nbytes = (e * (2 * x.numel() + B.numel() + C.numel()) + 4 * a.numel()
              + 4 * bh * p * n * (2 if with_s0 else 1))
    bound_ms, bound_by = bound(nbytes, flops, TENSOR_PEAK_FLOPS[dtype])
    if dtype == torch.float32:
        core_ms = 1e3 * flops / CUDA_CORE_FLOPS
        check.update(cuda_core_bound_ms=core_ms,
                     cuda_core_bound_fraction=core_ms / ms)
    launches = kernel_launches(kernel, "ssd_")
    out = dict(batch=batch, seq=seq, heads=nh, head_dim=p, state=n,
               chunk=q, dtype=str(dtype)[6:], with_s0=with_s0,
               strong_decay=strong_decay, a_min=float(a.min()), **check,
               ms=ms, ms_device_bound=device_bound,
               kernel_launches_per_call=launches,
               bound_fraction=bound_ms / ms,
               plain_ms=queued_ms(plain, 2)[0], bound_ms=bound_ms,
               bound_by=bound_by, bound_bytes=nbytes, bound_flops=flops)
    del x, a, B, C, s0, y, sT, want_y, want_s
    if launches != 1:
        raise AssertionError(f"ssd_scan_bh made {launches} kernel launches "
                             f"a call, expected 1: {out}")
    return out


def mean_of(cases, key):
    return sum(c[key] for c in cases) / len(cases)


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

    # --- build: one nvcc per source, all started together
    t0 = time.time()
    libraries = (rsk.LIBRARY, fak.LIBRARY, fdk.LIBRARY, ssk.LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as pool:
        built = list(pool.map(lambda lib: lib.build(verbose=True),
                              libraries))
    emit("build", seconds=time.time() - t0,
         libraries=[b.name for b in built],
         flags={lib.name: " ".join(lib.flags) for lib in libraries})

    # --- kernel vs plain, chunk by chunk, on the sweep's own packs
    wc = traces.worldcup98(seed=0, peak_vms=128)
    workloads = [(traces.nasa_ipsc(seed=0), wc), (traces.sdsc_blue(seed=0),
                                                  wc)]
    trace_names = ("nasa_ipsc", "sdsc_blue")
    runs = []
    for batch in (None, COALESCE):
        for wl, horizon, dtype in ((workloads, big, torch.float32),
                                   (cut(workloads, small), small,
                                    torch.float64)):
            for policy, w, grid, pk, spec in sweep_lanes(
                    wl, horizon, dtype, device, coalesce=batch):
                r = kernel_vs_plain(policy, trace_names[w], grid, pk, spec,
                                    horizon)
                runs.append(r)
                emit("kernel_vs_plain", **r)
    idle = [r for r in runs if r["batch"] > 1 and not r["coalesced"] > 0]
    if idle:
        raise AssertionError(f"the coalescer never engaged: {idle}")

    # --- the main path: the paper-grid sweep through the kernel
    grid = paper_grid(128)
    zero_counts()
    t0 = time.time()
    rows = run_sweep_workloads(grid, workloads, big, mode="rounds",
                               device=device)
    torch.cuda.synchronize()
    sweep_s = time.time() - t0
    counts = read_counts()
    launches, steps = counts["round_step"], rsk.outer_steps()
    # one launch per (trace, policy); kernel_vs_plain stepped the same
    # packs the same way, chunk by chunk.
    f32 = [r for r in runs if r["dtype"] == "float32" and r["batch"] == 1]
    if launches != len(f32) or any(v for k, v in counts.items()
                                   if k != "round_step"):
        raise AssertionError(f"the sweep's launches: {counts}, expected "
                             f"{len(f32)} runs")
    if steps != sum(r["chunks"] for r in f32):
        raise AssertionError(f"the sweep ran {steps} outer steps, the "
                             f"chunk-by-chunk check "
                             f"{sum(r['chunks'] for r in f32)}")
    split = wall_split(lambda: run_sweep_workloads(
        grid, workloads, big, mode="rounds", device=device))
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
    max_rounds = max(r.get("rounds", 0) for rs in rows for r in rs)
    emit("sweep", points=len(grid), workloads=len(workloads),
         horizon_days=big / DAY, kernel_launches=launches,
         outer_steps=steps, kernel_device_ms=sum(r["run_ms"] for r in f32),
         wall_s=sweep_s, wall_split=split, rows_equal_plain=True,
         plain_wall_s=plain_s, event_wall_s=event_s,
         max_rounds=max_rounds,
         contract=CONTRACTS["rounds"].__dict__, rows_nasa=rows[0])

    # --- the coalesced sweep through the kernel
    coal_opts = ScanOptions(coalesce=COALESCE)
    zero_counts()
    t0 = time.time()
    rows_c = run_sweep_workloads(grid, workloads, big, mode="rounds",
                                 device=device, scan_options=coal_opts)
    torch.cuda.synchronize()
    coal_s = time.time() - t0
    counts = read_counts()
    launches_c, steps_c = counts["round_step"], rsk.outer_steps()
    f32_c = [r for r in runs if r["dtype"] == "float32" and r["batch"] > 1]
    if launches_c != len(f32_c) or steps_c != sum(
            r["chunks"] for r in f32_c) or any(
            v for k, v in counts.items() if k != "round_step"):
        raise AssertionError(f"the coalesced sweep's launches: {counts}, "
                             f"{steps_c} outer steps; the chunk-by-chunk "
                             f"check {sum(r['chunks'] for r in f32_c)}")
    for w in range(len(workloads)):
        for i, (a, b) in enumerate(zip(rows[w], rows_c[w])):
            if a["system_kind"] in ("fb", "flb_nub") and \
                    a["completed_jobs"] != b["completed_jobs"]:
                raise AssertionError(
                    f"coalesced sweep workload {w} row {i}: completed "
                    f"{b['completed_jobs']} vs {a['completed_jobs']}")
    violations = check_fidelity(
        [r if r["system_kind"] in ("fb", "flb_nub") else None
         for r in rows_c[0]], event)
    if violations:
        raise AssertionError(f"coalesced rounds contract violated: "
                             f"{violations}")
    split_c = wall_split(lambda: run_sweep_workloads(
        grid, workloads, big, mode="rounds", device=device,
        scan_options=coal_opts))
    # Both walls again, in the other order (coalesced first).
    again = {}
    for name, opts in (("coalesced", coal_opts),
                       ("uncoalesced", ScanOptions())):
        t0 = time.time()
        run_sweep_workloads(grid, workloads, big, mode="rounds",
                            device=device, scan_options=opts)
        torch.cuda.synchronize()
        again[name] = time.time() - t0
    emit("sweep_coalesced", batch=COALESCE, kernel_launches=launches_c,
         outer_steps=steps_c,
         kernel_device_ms=sum(r["run_ms"] for r in f32_c),
         max_rounds=max(r.get("rounds", 0) for rs in rows_c for r in rs),
         coalesced=sum(r.get("coalesced", 0) for rs in rows_c for r in rs),
         wall_s=coal_s, wall_again_s=again["coalesced"], wall_split=split_c,
         uncoalesced={"kernel_launches": launches, "outer_steps": steps,
                      "max_rounds": max_rounds, "wall_s": sweep_s,
                      "wall_again_s": again["uncoalesced"],
                      "kernel_device_ms": sum(r["run_ms"] for r in f32),
                      "wall_split": split},
         rows_nasa=rows_c[0])

    # --- headline queries, coalescing off and on
    ref = json.loads((ROOT / "results" / "BENCH_capacity.json"
                      ).read_text())["headline"]
    walls = {}
    for phase, opts in (("headline", ScanOptions()),
                        ("headline_coalesced", coal_opts)):
        zero_counts()
        t0 = time.time()
        hl = headline_queries(scan_options=opts, device=device)
        torch.cuda.synchronize()
        wall_s = time.time() - t0
        hl_counts = read_counts()
        hl_launches, hl_steps = hl_counts["round_step"], rsk.outer_steps()
        for part, key in (("private", "min_fb_capacity"),
                          ("private", "dcs_size"), ("public", "flb_peak"),
                          ("public", "ec2_peak")):
            if hl[part][key] != ref[part][key]:
                raise AssertionError(f"{phase} {key}: {hl[part][key]} != "
                                     f"{ref[part][key]}")
        gate = HEADLINE_CONTRACT.check(hl["private"]["config_reduction"],
                                       hl["public"]["peak_reduction"])
        if gate or not hl["gate"]["ok"]:
            raise AssertionError(f"{phase} HEADLINE_CONTRACT: {gate}")
        if hl_launches == 0 or hl_counts["round_step_chunk"]:
            raise AssertionError(f"{phase} launches: {hl_counts}")
        walls[phase] = wall_s
        hl_split = wall_split(lambda: headline_queries(scan_options=opts,
                                                       device=device))
        emit(phase, wall_s=wall_s, headline_wall_s=walls["headline"],
             round_step_launches=hl_launches, outer_steps=hl_steps,
             wall_split=hl_split, **hl)

    # --- the serving slice at gemma2-2b's full width
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    dtypes = (torch.float32, torch.bfloat16)
    attn = [attn_case(cfg, s, w, dt, device, gen) for s in ATTN_SEQS
            for w in ATTN_WINDOWS for dt in dtypes]
    attn += [attn_case(cfg, ATTN_SEQS[1], ATTN_WINDOWS[0], dt, device, gen,
                       q_scale=CAP_Q_SCALE) for dt in dtypes]
    # the generate phase's prefill shape: bfloat16, batch 8, S 4600
    attn += [attn_case(cfg, GEN_PROMPT, w, torch.bfloat16, device, gen,
                       batch=GEN_BATCH) for w in ATTN_WINDOWS]
    check_cases("attn_kernel_vs_plain", attn)
    dec = [decode_case(cfg, p, w, dt, device, gen) for p in DECODE_POSITIONS
           for w in ATTN_WINDOWS for dt in dtypes]
    dec += [decode_case(cfg, DECODE_CAP_POS, ATTN_WINDOWS[0], dt, device,
                        gen, q_scale=CAP_Q_SCALE) for dt in dtypes]
    check_cases("decode_kernel_vs_plain", dec)
    torch.cuda.empty_cache()
    serve = serve_phase(cfg, device, "serve", SERVE_PROMPTS, SERVE_MAX_LEN,
                        "flash_attention")
    generate = generate_phase(
        cfg, device, "generate", GEN_BATCH, GEN_PROMPT, DECODE_CACHE,
        {"flash_decode": cfg.n_layers * GEN_STEPS,
         "flash_attention": cfg.n_layers})

    # --- the Mamba2 slice at mamba2-130m's full width
    ssm_cfg = get_config(SSM_ARCH)
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    ssd = [ssd_case(ssm_cfg, batch, seq, dt, device, gen, with_s0=s0,
                    strong_decay=strong, sequential=seq <= SSD_SEQ_MAX)
           for batch, seq, s0, strong in SSD_CASES for dt in dtypes]
    check_cases("ssd_kernel_vs_plain", ssd)
    torch.cuda.empty_cache()
    serve_ssm = serve_phase(ssm_cfg, device, "serve_mamba", SSM_PROMPTS,
                            SERVE_MAX_LEN, "ssd_scan")
    generate_ssm = generate_phase(
        ssm_cfg, device, "generate_mamba", GEN_SSM_BATCH, GEN_SSM_PROMPT,
        GEN_SSM_PROMPT + GEN_STEPS, {"ssd_scan": ssm_cfg.n_layers})

    # --- the kernel table line
    # round_step: times and bounds at the main path's shapes, the float32
    # two-week packs of both traces and policies, weighted by launches.
    def per_launch(key, cases=f32):
        return (sum(r[key] * r["chunks"] for r in cases)
                / sum(r["chunks"] for r in cases))

    # round_step: the engine's one-launch runs of the sweep (one per
    # trace and policy), each timed, bounded and held against the plain
    # host loop on its own pack; per launch, the mean over the runs.
    def per_run(key, cases=f32):
        return sum(r[key] for r in cases) / len(cases)

    line = {"kernels": [{
        "name": "round_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/round_step.cu",
        "replaces": "src/repro/kernels/round_step.py:165",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in f32),
        "ms": per_run("run_ms"),
        "plain_ms": per_run("plain_run_ms"),
        "bound_ms": per_run("run_bound_ms"),
        "bound_by": "bytes" if 2 * sum(r["run_bound_by"] == "bytes"
                                       for r in f32) >= len(f32)
        else "operations",
        "library_ms": None,
        # the outer steps of those runs (the per-chunk path's launches),
        # and the one-step entry's time per launch (launch-weighted)
        "outer_steps": steps,
        "ms_per_outer_step": sum(r["run_ms"] for r in f32) / steps,
        "chunk_ms": per_launch("kernel_ms_per_launch"),
        "chunk_bound_ms": per_launch("bound_ms"),
        # the same for the coalesced sweep (batch 8)
        "coalesced_launches": launches_c,
        "coalesced_outer_steps": steps_c,
        "coalesced_ms": per_run("run_ms", f32_c),
        "coalesced_plain_ms": per_run("plain_run_ms", f32_c),
        "coalesced_bound_ms": per_run("run_bound_ms", f32_c),
        "coalesced_ms_per_outer_step": sum(r["run_ms"] for r in f32_c)
        / steps_c,
        "coalesced_chunk_ms": per_launch("kernel_ms_per_launch", f32_c),
        "coalesced_max_abs_err": max(r["max_abs_err"] for r in f32_c),
    }]}
    # One row per attention kernel and dtype, at its path's shape, the
    # mean of its local (window 4096) and global layers: flash_attention
    # float32 on serve (b 1, the ragged S 4600), bfloat16 on generate's
    # prefill (batch 8, S 4600); flash_decode bfloat16 on generate's
    # step (batch 8, pos 4616).
    short = {"float32": "f32", "bfloat16": "bf16"}
    for name, cases, launches_on_path, match in (
            ("flash_attention", attn, serve["launches"]["flash_attention"],
             dict(seq=4600, dtype="float32", q_scale=1.0, batch=1)),
            ("flash_attention", attn,
             generate["launches"]["flash_attention"],
             dict(seq=GEN_PROMPT, dtype="bfloat16", q_scale=1.0,
                  batch=GEN_BATCH)),
            ("flash_decode", dec, generate["launches"]["flash_decode"],
             dict(pos=4616, dtype="bfloat16", q_scale=1.0))):
        sel = [c for c in cases if all(c[k] == v for k, v in match.items())]
        same_dtype = [c for c in cases if c["dtype"] == match["dtype"]]
        row = {
            "name": f"{name}_{short[match['dtype']]}",
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": {"flash_attention":
                         "src/repro/kernels/flash_attention.py:122",
                         "flash_decode":
                         "src/repro/kernels/flash_decode.py:98"}[name],
            "launches": launches_on_path,
            "max_abs_err": max(c["max_abs_err"] for c in same_dtype),
            "ms": mean_of(sel, "ms"),
            "plain_ms": mean_of(sel, "plain_ms"),
            "bound_ms": mean_of(sel, "bound_ms"),
            "bound_by": sel[0]["bound_by"],
            "library_ms": mean_of(sel, "library_ms"),
            "dtype": match["dtype"],
        }
        if match["dtype"] == "float32" and name == "flash_attention":
            row["cuda_core_bound_ms"] = mean_of(sel, "cuda_core_bound_ms")
        line["kernels"].append(row)
    # ssd_scan, one row per dtype on its path: bfloat16 on generate_mamba's
    # prefill (batch 8, L 4096), float32 on serve_mamba's admissions (its
    # longest, b 1, L 4096).
    for launches_on_path, match in (
            (generate_ssm["launches"]["ssd_scan"],
             dict(batch=GEN_SSM_BATCH, dtype="bfloat16")),
            (serve_ssm["launches"]["ssd_scan"],
             dict(batch=1, dtype="float32"))):
        sel = [c for c in ssd if c["batch"] == match["batch"] and
               c["seq"] == GEN_SSM_PROMPT and c["dtype"] == match["dtype"]
               and not c["with_s0"] and not c["strong_decay"]]
        row = {
            "name": f"ssd_scan_{short[match['dtype']]}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:79",
            "launches": launches_on_path,
            "max_abs_err": max(c["max_abs_err"] for c in ssd
                               if c["dtype"] == match["dtype"]),
            "ms": mean_of(sel, "ms"),
            "plain_ms": mean_of(sel, "plain_ms"),
            "bound_ms": mean_of(sel, "bound_ms"),
            "bound_by": sel[0]["bound_by"],
            "library_ms": None,
            "dtype": match["dtype"],
            "kernel_launches_per_call": sel[0]["kernel_launches_per_call"],
            "chain_ms": mean_of(sel, "chain_ms"),
        }
        if match["dtype"] == "float32":
            row["cuda_core_bound_ms"] = mean_of(sel, "cuda_core_bound_ms")
        line["kernels"].append(row)
    emit("chain", chain_ms=per_launch("chain_ms"),
         bound_ms=per_launch("bound_ms"),
         coalesced_chain_ms=per_launch("chain_ms", f32_c),
         coalesced_bound_ms=per_launch("bound_ms", f32_c),
         note="serial chain of block barriers per launch x measured "
              "barrier cost, beside the bytes/operations bound; "
              "coalesced: every round with a queue, an upper bound")
    emit("done", wall_s=time.time() - t_all)
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
