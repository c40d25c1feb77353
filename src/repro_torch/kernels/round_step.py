"""The fused round-step of the event-rounds engine: a CUDA kernel and its
plain PyTorch version.

One outer step of ``repro_torch.sim.rounds`` — stable compaction of the
done window lanes, admission of the next job-table rows, the power-of-two
size classes and ``compact_every`` event rounds (first-fit, §5.1 kills
for FB, §5.2 U/V/G at ticks for FLB-NUB, and with ``spec.batch > 1`` the
contended-stretch coalescer) — runs in ``csrc/round_step.cu`` with one
thread block per (point × trace) lane and one thread per window slot.
It replaces the Pallas kernel ``repro.kernels.round_step.chunk_step`` of
the JAX package. :func:`run_rounds` runs every lane's whole outer loop in
ONE launch (each block loops its own lane until the engine's predicate
fails, as the JAX package's ``while_loop`` does on the device); that is
the engine's path. :func:`chunk_step` runs one outer step per launch,
for comparing the kernel with its plain version after every step.

State layout (the JAX package's, so the two pack and unpack alike):
``sc`` (N, ``SC_SIZE``) holds the nine loop scalars followed by the eleven
metric accumulators in ``rounds.ACC_KEYS`` order; ``win`` (N,
``WIN_ROWS``, K) holds submit / size / runtime / run / done / start / end
per slot. Inputs per lane: ``jobs`` (N, 3, Jp) job table, ``rises``
(N, 2, NR) FB demand-rise stops, ``wstab`` (N, 2, NT) WS fold tables and
``prm`` the policy scalars ((N, 2) FB: lease, C; (N, 6) FLB-NUB: lease,
B, lb_ws, U, V, G). The pack is exact for every field: flags are 0/1 and
the two int cursors stay far below 2**24.

A pack with fault schedules (the chaos tier, FB only) adds a fourth
table, ``ftab`` (N, 3, NF): fault times, the failed count after each and
the raw demand at each (:func:`fault_table`). Only the plain version
takes it; :func:`chunk_step` and :func:`run_rounds` refuse it, as the
JAX package's fused Pallas step refuses fault packs, and the engine runs
such packs on the plain step (``RoundsSpec.resolve_kernel``).

:func:`chunk_step_ref` is the plain version: unpack → the engine's own
``_chunk_core`` → pack. :func:`chunk_step` and :func:`run_rounds` launch
the kernel on CUDA tensors and count each launch in their ``launches``;
they raise on CPU tensors (there is no kernel for the CPU:
``RoundsSpec.kernel`` chooses the plain version there).
:func:`outer_steps` reads the outer steps the ``run_rounds`` launches
made (the largest lane count of each, summed): the launches the
one-step path would have made for the same work. :func:`busiest_lane_steps`
holds the last launch's count, on the device.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.cudalib import CudaLibrary
from repro_torch.sim import rounds as _rounds
from repro_torch.sim.rounds import ACC_KEYS, RoundsSpec

__all__ = ["SC_SIZE", "WIN_ROWS", "pack_carry", "unpack_carry",
           "lane_inputs", "fault_table", "chunk_step", "chunk_step_ref",
           "run_rounds", "outer_steps", "zero_outer_steps", "build",
           "chain_barriers", "chain_probe"]

# ----------------------------------------------------------- state layout

SC_T = 0            # current time (the outer loop's exit test reads this)
SC_OWNED = 1
SC_POOL = 2
SC_USED = 3
SC_HAS_QUEUE = 4    # bool as 0/1
SC_WSV = 5
SC_ALLOC_PREV = 6
SC_RISE_I = 7       # int cursor as float (exact < 2**24)
SC_NEXT_ROW = 8     # int cursor as float (exact < 2**24)
SC_ACC0 = 9         # first of the len(ACC_KEYS) accumulators
SC_SIZE = SC_ACC0 + len(ACC_KEYS)

WIN_SUB, WIN_SZ, WIN_RT, WIN_RUN, WIN_DONE, WIN_START, WIN_END = range(7)
WIN_ROWS = 7


def pack_carry(core) -> Tuple[torch.Tensor, torch.Tensor]:
    """17-tuple loop state → ``(sc (N, SC_SIZE), win (N, WIN_ROWS, K))``."""
    (t, owned, pool_pbj, used, has_queue, wsv, alloc_prev, rise_i,
     next_row, w_sub, w_sz, w_rt, run, done, start_t, end_t, acc) = core
    f = w_sub.dtype
    sc = torch.stack([v.to(f) for v in
                      (t, owned, pool_pbj, used, has_queue, wsv, alloc_prev,
                       rise_i, next_row)]
                     + [acc[k].to(f) for k in ACC_KEYS], dim=1)
    win = torch.stack([w_sub, w_sz, w_rt, run.to(f), done.to(f), start_t,
                       end_t], dim=1)
    return sc, win


def unpack_carry(sc: torch.Tensor, win: torch.Tensor):
    """Inverse of :func:`pack_carry` — exact for every field."""
    acc = {k: sc[:, SC_ACC0 + i] for i, k in enumerate(ACC_KEYS)}
    return (sc[:, SC_T], sc[:, SC_OWNED], sc[:, SC_POOL], sc[:, SC_USED],
            sc[:, SC_HAS_QUEUE] > 0, sc[:, SC_WSV], sc[:, SC_ALLOC_PREV],
            sc[:, SC_RISE_I].to(torch.int32),
            sc[:, SC_NEXT_ROW].to(torch.int32),
            win[:, WIN_SUB], win[:, WIN_SZ], win[:, WIN_RT],
            win[:, WIN_RUN] > 0, win[:, WIN_DONE] > 0,
            win[:, WIN_START], win[:, WIN_END], acc)


def fault_table(ctx: Dict) -> Optional[torch.Tensor]:
    """The chaos tier's stop table ``ftab`` (N, 3, NF) — fault times,
    failed count after each, raw demand at each — from the engine's ctx
    dict, or ``None`` when the pack has no fault schedules."""
    if "fault_times" not in ctx:
        return None
    return torch.stack([ctx[k] for k in _rounds._FAULT_FIELDS],
                       dim=1).contiguous()


def lane_inputs(policy: str, ctx: Dict, ftab: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """The engine's per-lane ctx dict → the kernel's four stacked,
    contiguous input tensors ``(jobs, rises, wstab, prm)``, checked once
    here (with the fault table ``ftab`` when given) for every launch of
    a simulation (:func:`chunk_step` checks only the state it is
    given)."""
    jobs = torch.stack([ctx["tr_submit"], ctx["tr_size"],
                        ctx["tr_runtime"]], dim=1)
    rises = torch.stack([ctx["rise_times"], ctx["rise_vals"]], dim=1)
    wstab = torch.stack([ctx["ws_winmax"], ctx["ws_at_tick"]], dim=1)
    f = jobs.dtype
    keys = ("L", "C") if policy == "fb" else ("L", "B", "lb_ws", "U", "V",
                                              "G")
    prm = torch.stack([ctx[k].to(f) for k in keys], dim=1)
    inputs = (jobs.contiguous(), rises.contiguous(), wstab.contiguous(),
              prm.contiguous())
    _check_lane_inputs(policy, *inputs, ftab=ftab)
    return inputs


def _check_lane_inputs(policy, jobs, rises, wstab, prm, ftab=None) -> None:
    f = jobs.dtype
    if f not in (torch.float32, torch.float64):
        raise TypeError(f"round_step takes float32 or float64, got {f}")
    N = jobs.shape[0]
    n_prm = 2 if policy == "fb" else 6
    shapes = {"jobs": (jobs, (N, 3, jobs.shape[-1])),
              "rises": (rises, (N, 2, rises.shape[-1])),
              "wstab": (wstab, (N, 2, wstab.shape[-1])),
              "prm": (prm, (N, n_prm))}
    if ftab is not None:
        if policy != "fb":
            raise ValueError("fault tables are FB-only")
        shapes["ftab"] = (ftab, (N, 3, ftab.shape[-1]))
    for name, (x, shape) in shapes.items():
        if x.dtype != f or x.device != jobs.device:
            raise TypeError(f"{name}: {x.dtype} on {x.device}, expected "
                            f"{f} on {jobs.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: shape {tuple(x.shape)} (contiguous="
                             f"{x.is_contiguous()}), expected {shape}")


def _ctx_from_inputs(policy: str, jobs, rises, wstab, prm,
                     ftab=None) -> Dict:
    """Rebuild the engine's ctx dict from the stacked kernel inputs —
    the exact inverse of :func:`lane_inputs` and :func:`fault_table`."""
    ctx = {
        "L": prm[:, 0],
        "tr_submit": jobs[:, 0], "tr_size": jobs[:, 1],
        "tr_runtime": jobs[:, 2],
        "rise_times": rises[:, 0], "rise_vals": rises[:, 1],
        "ws_winmax": wstab[:, 0], "ws_at_tick": wstab[:, 1],
    }
    if policy == "fb":
        ctx["C"] = prm[:, 1]
    else:
        ctx["B"], ctx["lb_ws"], ctx["U"], ctx["V"], ctx["G"] = (
            prm[:, 1], prm[:, 2], prm[:, 3], prm[:, 4], prm[:, 5])
    if ftab is not None:
        # Contiguous rows: the round body binary-searches the times.
        for i, k in enumerate(_rounds._FAULT_FIELDS):
            ctx[k] = ftab[:, i].contiguous()
    return ctx


def chunk_step_ref(jobs, rises, wstab, prm, sc, win, *, policy: str,
                   spec: RoundsSpec, ftab: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`chunk_step`: the same pack →
    ``_chunk_core`` → unpack round trip as tensor ops over all lanes,
    with the chaos tier's fault stops when ``ftab`` is given."""
    ctx = _ctx_from_inputs(policy, jobs, rises, wstab, prm, ftab)
    core = unpack_carry(sc, win)
    return pack_carry(_rounds._chunk_core(policy, ctx, spec, core))


# ------------------------------------------------------------- the kernel

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.round_step_chunk
    fn.argtypes = ([ctypes.c_int] * 10 + [ctypes.c_double]
                   + [ctypes.c_void_p] * 9)
    fn.restype = ctypes.c_int
    run = lib.round_step_run
    run.argtypes = ([ctypes.c_int] * 11 + [ctypes.c_double]
                    + [ctypes.c_void_p] * 10)
    run.restype = ctypes.c_int
    lib.round_step_error_string.argtypes = [ctypes.c_int]
    lib.round_step_error_string.restype = ctypes.c_char_p
    probe = lib.round_step_chain_probe
    probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    probe.restype = ctypes.c_int


LIBRARY = CudaLibrary("round_step", NVCC_FLAGS, _declare)


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/round_step.cu`` with nvcc for ``sm_90a`` into a
    shared library under ``kernels/build/`` (named by the hash of the
    source and flags, so an edited source rebuilds) and return its
    path. With ``verbose`` the ptxas register/shared-memory report is
    printed."""
    return LIBRARY.build(verbose)


def _library() -> ctypes.CDLL:
    return LIBRARY.get()


def _check_state(jobs, sc, win, spec, ftab) -> None:
    """The per-launch checks: no fault table, the state against the lane
    inputs (which :func:`lane_inputs` checked) and the spec."""
    if ftab is not None:
        raise NotImplementedError(
            "fault injection is not supported by the fused CUDA round "
            "step; use kernel=\"torch\" (chunk_step_ref)")
    if sc.device.type != "cuda":
        raise ValueError(f"chunk_step launches the CUDA kernel and takes "
                         f"CUDA tensors, got {sc.device}; the CPU runs "
                         f"chunk_step_ref (kernel=\"torch\")")
    N, K = jobs.shape[0], spec.window
    for name, x, shape in (("sc", sc, (N, SC_SIZE)),
                           ("win", win, (N, WIN_ROWS, K))):
        if x.dtype != jobs.dtype or x.device != jobs.device:
            raise TypeError(f"{name}: {x.dtype} on {x.device}, expected "
                            f"{jobs.dtype} on {jobs.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: shape {tuple(x.shape)} (contiguous="
                             f"{x.is_contiguous()}), expected {shape}")
    if not 1 <= K <= min(1024, jobs.shape[-1]):
        raise ValueError(f"window {K} must lie in [1, 1024] and fit the "
                         f"job table ({jobs.shape[-1]} rows)")


def chunk_step(jobs, rises, wstab, prm, sc, win, *, policy: str,
               spec: RoundsSpec, ftab: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused outer step for every lane: compaction + admission +
    size classes + ``spec.compact_every`` rounds, as ONE kernel launch
    (one thread block per lane), with the contended-stretch coalescer
    when ``spec.batch > 1``. The inputs come from :func:`lane_inputs`;
    the tensors must lie on a CUDA device, where the kernel runs or this
    raises. A fault table ``ftab`` raises: the kernel has no fault
    stops."""
    _check_state(jobs, sc, win, spec, ftab)
    lib = _library()
    sc_out = torch.empty_like(sc)
    win_out = torch.empty_like(win)
    stream = torch.cuda.current_stream(sc.device).cuda_stream
    err = lib.round_step_chunk(
        0 if policy == "fb" else 1, int(sc.dtype == torch.float64),
        sc.shape[0], win.shape[-1], jobs.shape[-1], rises.shape[-1],
        wstab.shape[-1], spec.compact_every, spec.ff_passes, _batch(spec),
        float(spec.duration), jobs.data_ptr(), rises.data_ptr(),
        wstab.data_ptr(), prm.data_ptr(), sc.data_ptr(), win.data_ptr(),
        sc_out.data_ptr(), win_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("round_step kernel launch failed: "
                           + lib.round_step_error_string(err).decode())
    chunk_step.launches += 1
    return sc_out, win_out


chunk_step.launches = 0

# Per device: the outer steps of the run_rounds launches (the largest
# lane count of each launch, summed on the device, so counting needs no
# host sync), and the last launch's largest lane count.
_OUTER_STEPS: Dict[torch.device, torch.Tensor] = {}
_BUSIEST: Dict[torch.device, torch.Tensor] = {}


def run_rounds(jobs, rises, wstab, prm, sc, win, *, policy: str,
               spec: RoundsSpec, outer_max: int,
               ftab: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every lane's whole outer loop as ONE kernel launch: each block
    runs outer steps of its lane (those of :func:`chunk_step`) while
    ``(steps < outer_max) & (t < spec.duration)``, the engine's per-lane
    predicate, and a lane that fails it keeps its state. Returns the
    final ``(sc, win)`` and each lane's outer-step count (int32, on the
    device). The inputs come from :func:`lane_inputs`; the tensors must
    lie on a CUDA device, where the kernel runs or this raises. A fault
    table ``ftab`` raises, as in :func:`chunk_step`."""
    _check_state(jobs, sc, win, spec, ftab)
    lib = _library()
    sc_out = torch.empty_like(sc)
    win_out = torch.empty_like(win)
    steps = torch.empty(sc.shape[0], dtype=torch.int32, device=sc.device)
    stream = torch.cuda.current_stream(sc.device).cuda_stream
    err = lib.round_step_run(
        0 if policy == "fb" else 1, int(sc.dtype == torch.float64),
        sc.shape[0], win.shape[-1], jobs.shape[-1], rises.shape[-1],
        wstab.shape[-1], spec.compact_every, spec.ff_passes, _batch(spec),
        int(outer_max), float(spec.duration), jobs.data_ptr(),
        rises.data_ptr(), wstab.data_ptr(), prm.data_ptr(), sc.data_ptr(),
        win.data_ptr(), sc_out.data_ptr(), win_out.data_ptr(),
        steps.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("round_step kernel launch failed: "
                           + lib.round_step_error_string(err).decode())
    run_rounds.launches += 1
    if sc.shape[0]:
        busiest = _BUSIEST[sc.device] = steps.max()
        total = _OUTER_STEPS.setdefault(
            sc.device, torch.zeros((), dtype=torch.int64, device=sc.device))
        total += busiest
    else:
        _BUSIEST.pop(sc.device, None)
    return sc_out, win_out, steps


run_rounds.launches = 0


def outer_steps() -> int:
    """The outer steps :func:`run_rounds` has run since the last
    :func:`zero_outer_steps`: per launch the count of its busiest lane,
    summed (it synchronises with the devices)."""
    return sum(int(v) for v in _OUTER_STEPS.values())


def busiest_lane_steps(device: torch.device) -> Optional[torch.Tensor]:
    """The outer steps of the busiest lane of the last :func:`run_rounds`
    launch on ``device``, a 0-d tensor there (read without a host sync);
    None before any launch with lanes."""
    return _BUSIEST.get(device)


def zero_outer_steps() -> None:
    for v in _OUTER_STEPS.values():
        v.zero_()


# ------------------------------------------------- the serial chain's cost

def _batch(spec: RoundsSpec) -> int:
    """The coalescing batch the kernel runs: top-k cannot exceed the
    window, as in the engine."""
    return min(spec.batch, spec.window)


def chain_barriers(policy: str, spec: RoundsSpec) -> int:
    """Block-wide barriers one launch of the kernel passes in sequence,
    counted from ``csrc/round_step.cu``: 3 for the compaction, then per
    event round 2 per block reduction or scan, 3 for the FB kill classes
    and 4 per first-fit pass (FB: 17 + 4·passes; FLB-NUB, which runs
    first-fit twice: 14 + 8·passes). With batch 1 the kernel runs every
    round of the chunk the same way, so the count does not depend on the
    data.

    With coalescing on (batch k > 1), a round whose lane has a queue
    runs the coalescer, 2·k + 7 barriers (k + 1 reductions for the
    instants and the frontier, the admission scan, the started-by
    buckets, the divergence reduction; fewer when the instants run out
    before k), and skips the horizon's three reductions (6); a round
    without a queue runs one reduction for its horizon (2). The count
    returned is a chunk in which every round has a queue (FB: 18 + 4·
    passes + 2·k; FLB-NUB: 15 + 8·passes + 2·k): an upper bound."""
    per_round = (17 + 4 * spec.ff_passes if policy == "fb"
                 else 14 + 8 * spec.ff_passes)
    k = _batch(spec)
    if k > 1:
        per_round += 2 * k + 7 - 6
    return 3 + spec.compact_every * per_round


def chain_probe(out: torch.Tensor, steps: int) -> None:
    """Launch the chain-cost probe of ``csrc/round_step.cu``: ``steps``
    dependent block-wide sums (two barriers each) in ``out.shape[0]``
    blocks of ``out.shape[1]`` threads (a multiple of 32), the same
    reduction the kernel's stages use. Not counted in
    ``chunk_step.launches``: it is a measurement, not the engine."""
    if out.device.type != "cuda" or out.dim() != 2 \
            or out.dtype not in (torch.float32, torch.float64) \
            or not out.is_contiguous():
        raise ValueError("chain_probe takes a contiguous (blocks, threads) "
                         "float32 or float64 CUDA tensor")
    lib = _library()
    err = lib.round_step_chain_probe(
        int(out.dtype == torch.float64), out.shape[0], out.shape[1], steps,
        out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError("round_step chain probe launch failed: "
                           + lib.round_step_error_string(err).decode())
