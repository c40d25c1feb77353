"""The fused round-step of the event-rounds engine: a CUDA kernel and its
plain PyTorch version.

One outer step of ``repro_torch.sim.rounds`` — stable compaction of the
done window lanes, admission of the next job-table rows, the power-of-two
size classes and ``compact_every`` event rounds (first-fit, §5.1 kills
for FB, §5.2 U/V/G at ticks for FLB-NUB) — runs as ONE launch for every
(point × trace) lane: one thread block per lane, one thread per window
slot (``csrc/round_step.cu``). It replaces the Pallas kernel
``repro.kernels.round_step.chunk_step`` of the JAX package.

State layout (the JAX package's, so the two pack and unpack alike):
``sc`` (N, ``SC_SIZE``) holds the nine loop scalars followed by the eleven
metric accumulators in ``rounds.ACC_KEYS`` order; ``win`` (N,
``WIN_ROWS``, K) holds submit / size / runtime / run / done / start / end
per slot. Inputs per lane: ``jobs`` (N, 3, Jp) job table, ``rises``
(N, 2, NR) FB demand-rise stops, ``wstab`` (N, 2, NT) WS fold tables and
``prm`` the policy scalars ((N, 2) FB: lease, C; (N, 6) FLB-NUB: lease,
B, lb_ws, U, V, G). The pack is exact for every field: flags are 0/1 and
the two int cursors stay far below 2**24.

:func:`chunk_step_ref` is the plain version: unpack → the engine's own
``_chunk_core`` → pack. :func:`chunk_step` launches the kernel on CUDA
tensors and counts each launch in ``chunk_step.launches``; it raises on
CPU tensors (there is no kernel for the CPU: ``RoundsSpec.kernel``
chooses the plain version there).

The kernel covers the engine's default ``batch == 1``; the contended-
stretch coalescer (``batch > 1``) runs on the plain version only.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels.cudalib import CudaLibrary
from repro_torch.sim import rounds as _rounds
from repro_torch.sim.rounds import ACC_KEYS, RoundsSpec

__all__ = ["SC_SIZE", "WIN_ROWS", "pack_carry", "unpack_carry",
           "lane_inputs", "chunk_step", "chunk_step_ref", "build",
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


def lane_inputs(policy: str, ctx: Dict) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor, torch.Tensor]:
    """The engine's per-lane ctx dict → the kernel's four stacked,
    contiguous input tensors ``(jobs, rises, wstab, prm)``, checked once
    here for every launch of a simulation (:func:`chunk_step` checks only
    the state it is given)."""
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
    _check_lane_inputs(policy, *inputs)
    return inputs


def _check_lane_inputs(policy, jobs, rises, wstab, prm) -> None:
    f = jobs.dtype
    if f not in (torch.float32, torch.float64):
        raise TypeError(f"round_step takes float32 or float64, got {f}")
    N = jobs.shape[0]
    n_prm = 2 if policy == "fb" else 6
    shapes = {"jobs": (jobs, (N, 3, jobs.shape[-1])),
              "rises": (rises, (N, 2, rises.shape[-1])),
              "wstab": (wstab, (N, 2, wstab.shape[-1])),
              "prm": (prm, (N, n_prm))}
    for name, (x, shape) in shapes.items():
        if x.dtype != f or x.device != jobs.device:
            raise TypeError(f"{name}: {x.dtype} on {x.device}, expected "
                            f"{f} on {jobs.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: shape {tuple(x.shape)} (contiguous="
                             f"{x.is_contiguous()}), expected {shape}")


def _ctx_from_inputs(policy: str, jobs, rises, wstab, prm) -> Dict:
    """Rebuild the engine's ctx dict from the stacked kernel inputs —
    the exact inverse of :func:`lane_inputs`."""
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
    return ctx


def chunk_step_ref(jobs, rises, wstab, prm, sc, win, *, policy: str,
                   spec: RoundsSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`chunk_step`: the same pack →
    ``_chunk_core`` → unpack round trip as tensor ops over all lanes."""
    ctx = _ctx_from_inputs(policy, jobs, rises, wstab, prm)
    core = unpack_carry(sc, win)
    return pack_carry(_rounds._chunk_core(policy, ctx, spec, core))


# ------------------------------------------------------------- the kernel

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.round_step_chunk
    fn.argtypes = ([ctypes.c_int] * 9 + [ctypes.c_double]
                   + [ctypes.c_void_p] * 9)
    fn.restype = ctypes.c_int
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


def _check_state(jobs, sc, win, spec) -> None:
    """The per-launch checks: the state against the lane inputs (which
    :func:`lane_inputs` checked) and the spec."""
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
               spec: RoundsSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused outer step for every lane: compaction + admission +
    size classes + ``spec.compact_every`` rounds, as ONE kernel launch
    (one thread block per lane). The inputs come from
    :func:`lane_inputs`; the tensors must lie on a CUDA device, where the
    kernel runs or this raises."""
    _check_state(jobs, sc, win, spec)
    if min(spec.batch, spec.window) > 1:
        raise NotImplementedError(
            "the CUDA round step covers batch == 1; the contended-stretch "
            "coalescer (batch > 1) runs with kernel=\"torch\"")
    lib = _library()
    sc_out = torch.empty_like(sc)
    win_out = torch.empty_like(win)
    stream = torch.cuda.current_stream(sc.device).cuda_stream
    err = lib.round_step_chunk(
        0 if policy == "fb" else 1, int(sc.dtype == torch.float64),
        sc.shape[0], win.shape[-1], jobs.shape[-1], rises.shape[-1],
        wstab.shape[-1], spec.compact_every, spec.ff_passes,
        float(spec.duration), jobs.data_ptr(), rises.data_ptr(),
        wstab.data_ptr(), prm.data_ptr(), sc.data_ptr(), win.data_ptr(),
        sc_out.data_ptr(), win_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("round_step kernel launch failed: "
                           + lib.round_step_error_string(err).decode())
    chunk_step.launches += 1
    return sc_out, win_out


chunk_step.launches = 0


# ------------------------------------------------- the serial chain's cost

def chain_barriers(policy: str, spec: RoundsSpec) -> int:
    """Block-wide barriers one launch of the kernel passes in sequence,
    counted from ``csrc/round_step.cu``: 3 for the compaction, then per
    event round 2 per block reduction or scan, 3 for the FB kill classes
    and 4 per first-fit pass (FB: 17 + 4·passes; FLB-NUB, which runs
    first-fit twice: 14 + 8·passes). The kernel runs every round of the
    chunk, so the count does not depend on the data."""
    per_round = (17 + 4 * spec.ff_passes if policy == "fb"
                 else 14 + 8 * spec.ff_passes)
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
