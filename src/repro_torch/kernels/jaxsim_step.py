"""The §6.6.4 FLB-NUB tick simulator's run over parameter lanes: a CUDA
kernel and its plain PyTorch version.

``repro_torch.core.jaxsim.simulate`` steps every parameter lane of one
packed trace through ``n_steps`` substeps of ``dt = lease / substeps``:
advance the running jobs, read the queue (demand, used, biggest), at a
tick boundary grant the pool and apply §5.2's U / V / G adjust, then
start queued jobs first-fit in arrival order. It is the counterpart of
the jitted ``lax.scan`` of ``repro.core.jaxsim.simulate``, vmapped over
lanes; the JAX package has no Pallas kernel for it.

* :func:`simulate_ref` is the plain version: one torch function over
  all L lanes and the whole job table, a host loop over substeps, the
  first-fit a loop of whole-lane jumps (:func:`first_fit`), not a loop
  over jobs.
* :func:`simulate_kernel` launches ``csrc/jaxsim.cu`` ONCE per call,
  one thread block per lane, each block stepping its lane through every
  substep. It takes CUDA tensors only and counts each launch in
  ``simulate_kernel.launches``. A lane's job state (remaining run time,
  finish time, the running / done flags) and the submit and size
  columns live in the block's shared memory when the table fits
  (:func:`fits_shared_memory`: ``n_jobs · (4 · itemsize + 1)`` bytes
  within the card's per-block opt-in limit, 2603 NASA jobs take 44 KB
  in float32), else in a global scratch of the wrapper's, with submit
  and size read from the inputs.

Inputs of both: ``prm`` (L, 4) = B, U, V, G per lane and ``submit``,
``size``, ``runtime`` (J,), ``ws`` (n_steps,), all of one float dtype
(float32 or float64). Outputs: the reference's five per-lane values.
Sizes and WS demands are integer-valued, so every sum a decision reads
(demand, used) is exact in any order; the two output sums (allocation,
turnaround) are taken in float64 and rounded once in both versions.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels.cudalib import CudaLibrary, require_cuda

__all__ = ["OUTPUTS", "first_fit", "simulate_ref", "simulate_kernel",
           "fits_shared_memory", "LIBRARY", "build"]

OUTPUTS = ("completed_jobs", "avg_turnaround", "node_hours", "peak_nodes",
           "adjust_events")


# ------------------------------------------------------- the plain version

def first_fit(queued: torch.Tensor, size: torch.Tensor,
              free: torch.Tensor) -> torch.Tensor:
    """Which queued jobs a sequential first-fit in table order starts,
    per lane: ``queued`` (L, J) bool, ``size`` (J,) or (L, J), ``free``
    (L,). Returns the (L, J) bool starts.

    The reference scans the table once (``repro.core.jaxsim``, the inner
    ``lax.scan``): job i starts iff ``queued[i] & (size[i] <= fr)``, and
    ``fr`` drops by ``size[i]`` when it does. ``fr`` changes only at a
    start, so the next job the scan starts is the first queued job after
    the last start whose size is at most the current ``fr``. Each pass
    here finds that job in every lane at once (a masked ``argmax``),
    starts it and subtracts its size, until no lane has one: the same
    starts and the same float subtractions in the same order as the
    scan, so the same bits, in (starts + 1) passes instead of J steps."""
    L, J = queued.shape
    sz = size.expand(L, J)
    idx = torch.arange(J, device=queued.device)
    starts = torch.zeros_like(queued)
    fr = free.clone()
    after = torch.full((L,), -1, dtype=torch.long, device=queued.device)
    while True:
        cand = queued & (sz <= fr[:, None]) & (idx > after[:, None])
        lanes = cand.any(1).nonzero().squeeze(1)
        if lanes.numel() == 0:
            return starts
        j = cand[lanes].to(torch.uint8).argmax(1)    # the first candidate
        starts[lanes, j] = True
        fr[lanes] = fr[lanes] - sz[lanes, j]
        after[lanes] = j


def _per_hour(dtype, device) -> torch.Tensor:
    """``1 / 3600`` in ``dtype``. The reference's ``sum(alloc) * dt /
    3600.0`` compiles (XLA's algebraic simplifier) to ``sum(alloc) * c``
    with ``c = dt * (1 / 3600)`` folded in the dtype: its optimized HLO
    multiplies by float32 0.0833333358 at a one-hour lease. A true
    division rounds differently on some sums (one of the §6.6.4 study's
    twelve), so both versions multiply by the folded constant."""
    return torch.tensor(1.0 / 3600.0, dtype=dtype, device=device)


def _sum_once(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum in float64, rounded once to ``x``'s dtype, as the kernel sums.
    The allocations are integers, so below 2**24 this is the float32 sum
    in any order, the reference's too; above it no float32 order is
    exact, and the two versions still agree. A float64 sum of the
    float32 turnarounds is exact, so the two agree on it bit for bit;
    the reference's float32 sum differs in the last bits."""
    return x.double().sum(dim).to(x.dtype)


def simulate_ref(prm, submit, size, runtime, ws, *, n_steps: int,
                 lease_seconds: float, lb_ws: int = 12,
                 substeps: int = 12) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of :func:`simulate_kernel`: every lane at
    once, op for op the reference's step (``repro.core.jaxsim.simulate``)
    in the inputs' dtype. Steps off a tick boundary skip the tick's
    arithmetic, which there adds and subtracts zeros only."""
    L, J = prm.shape[0], submit.shape[0]
    dtype, dev = submit.dtype, submit.device
    B, U, V, G = prm.unbind(1)
    dt = torch.tensor(lease_seconds / substeps, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    owned = torch.clamp_min(B - lb_ws, 1.0)
    pool = owned.clone()
    remaining = runtime.expand(L, J).clone()
    running = torch.zeros(L, J, dtype=torch.bool, device=dev)
    done = torch.zeros_like(running)
    finish = torch.zeros(L, J, dtype=dtype, device=dev)
    ts = (torch.arange(n_steps, dtype=dtype, device=dev) + 1.0) * dt
    pool_ws = torch.clamp_max(ws, float(lb_ws))
    ws_beyond = torch.clamp_min(ws - pool_ws, 0.0)
    alloc = torch.empty(n_steps, L, dtype=dtype, device=dev)
    events = torch.zeros(n_steps, L, dtype=torch.float32, device=dev)
    for s in range(n_steps):
        t = ts[s]
        # 1. advance the running jobs one substep
        remaining = torch.where(running, remaining - dt, remaining)
        completing = running & (remaining <= 0)
        finish = torch.where(completing, t, finish)
        done |= completing
        running &= ~completing
        queued = (submit <= t) & ~running & ~done
        qsize = torch.where(queued, size, zero)
        demand = qsize.sum(1)
        used = torch.where(running, size, zero).sum(1)
        # 2+3. at a tick: the pool's grant and the §5.2 U/V/G adjust
        if s % substeps == substeps - 1:
            grant = torch.clamp_min(B - pool_ws[s] - pool, 0.0)
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
            events[s] = (req > 0).float() + (rss > 0).float()
        # 4. first-fit in arrival order
        running |= first_fit(queued, size, owned - used)
        # 5. accounting: B pool + leased + WS beyond its lower bound
        alloc[s] = B + torch.clamp_min(owned - pool, 0.0) + ws_beyond[s]
    n_done = done.sum(1)
    turnaround = _sum_once(torch.where(done, finish - submit, zero), 1)
    return {"completed_jobs": n_done,
            "avg_turnaround": turnaround / torch.clamp_min(n_done, 1)
            .to(dtype),
            "node_hours": _sum_once(alloc, 0) * (dt * _per_hour(dtype, dev)),
            "peak_nodes": alloc.amax(0),
            "adjust_events": events.sum(0)}


# ------------------------------------------------------------- the kernel

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.jaxsim_run
    fn.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_double] * 2
                   + [ctypes.c_void_p] * 9)
    fn.restype = ctypes.c_int
    lib.jaxsim_smem_limit.argtypes = [ctypes.c_int]
    lib.jaxsim_smem_limit.restype = ctypes.c_int
    lib.jaxsim_error_string.argtypes = [ctypes.c_int]
    lib.jaxsim_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("jaxsim", NVCC_FLAGS, _declare)


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/jaxsim.cu`` for ``sm_90a`` (``-fmad=false``, no fast
    math: the reference's ratio is an IEEE division) and return the
    library's path; ``verbose`` prints the ptxas report."""
    return LIBRARY.build(verbose)


def _smem_bytes(n_jobs: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a lane's table: submit, size, remaining,
    finish (``dtype``) and one flag byte per job."""
    return n_jobs * (4 * dtype.itemsize + 1)


def fits_shared_memory(n_jobs: int, dtype: torch.dtype,
                       device: torch.device) -> bool:
    """Whether a lane's job state fits the block's shared memory on
    ``device`` (else the kernel keeps it in a global scratch)."""
    limit = LIBRARY.get().jaxsim_smem_limit(device.index or 0)
    if limit < 0:
        raise RuntimeError("jaxsim: cannot read the shared-memory limit: "
                           + LIBRARY.get().jaxsim_error_string(-limit)
                           .decode())
    return _smem_bytes(n_jobs, dtype) <= limit


def _check(prm, submit, size, runtime, ws, n_steps, substeps) -> None:
    require_cuda("simulate_kernel", "simulate_ref", submit)
    dtype, dev = submit.dtype, submit.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"jaxsim: float32 or float64 inputs, got {dtype}")
    J = submit.shape[0] if submit.dim() == 1 else -1
    for name, x, shape in (("prm", prm, (prm.shape[0], 4)),
                           ("submit", submit, (J,)), ("size", size, (J,)),
                           ("runtime", runtime, (J,)),
                           ("ws", ws, (n_steps,))):
        if x.dtype != dtype or x.device != dev:
            raise TypeError(f"{name}: {x.dtype} on {x.device}, expected "
                            f"{dtype} on {dev}")
        if x.dim() != len(shape) or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name}: shape {tuple(x.shape)} (contiguous="
                             f"{x.is_contiguous()}), expected {shape}")
    if prm.dim() != 2 or prm.shape[0] < 1:
        raise ValueError(f"prm: shape {tuple(prm.shape)}, expected (L, 4) "
                         f"with L >= 1")
    if J < 1 or n_steps < 1 or substeps < 1:
        raise ValueError(f"jaxsim: needs at least one job, step and "
                         f"substep (jobs {J}, n_steps {n_steps}, substeps "
                         f"{substeps})")


def simulate_kernel(prm, submit, size, runtime, ws, *, n_steps: int,
                    lease_seconds: float, lb_ws: int = 12,
                    substeps: int = 12) -> Dict[str, torch.Tensor]:
    """Every lane's whole run as ONE launch of ``csrc/jaxsim.cu`` (a
    block per lane). Same inputs and outputs as :func:`simulate_ref`;
    the tensors must lie on a CUDA device, where the kernel runs or this
    raises."""
    _check(prm, submit, size, runtime, ws, n_steps, substeps)
    lib = LIBRARY.get()
    L, J, dev, dtype = prm.shape[0], submit.shape[0], submit.device, \
        submit.dtype
    in_smem = fits_shared_memory(J, dtype, dev)
    if in_smem:
        scratch = flags = torch.empty(0, dtype=dtype, device=dev)
    else:
        scratch = torch.empty(L, 2, J, dtype=dtype, device=dev)
        flags = torch.empty(L, J, dtype=torch.uint8, device=dev)
    out = torch.empty(L, len(OUTPUTS), dtype=dtype, device=dev)
    err = lib.jaxsim_run(
        int(dtype == torch.float64), L, J, n_steps, substeps, int(in_smem),
        lease_seconds / substeps, float(lb_ws), submit.data_ptr(),
        size.data_ptr(), runtime.data_ptr(), ws.data_ptr(), prm.data_ptr(),
        scratch.data_ptr(), flags.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("jaxsim kernel launch failed: "
                           + lib.jaxsim_error_string(err).decode())
    simulate_kernel.launches += 1
    return {"completed_jobs": out[:, 0].long(),
            "avg_turnaround": out[:, 1], "node_hours": out[:, 2],
            "peak_nodes": out[:, 3],
            "adjust_events": out[:, 4].to(torch.float32)}


simulate_kernel.launches = 0
