"""The WS fold tables of a generated scenario batch: a CUDA kernel and
its plain PyTorch version.

:func:`repro_torch.sim.scenarios.pack_scenarios` folds every lane's WS
demand into the three per-(lane, point) tables the round step reads
(:class:`repro_torch.sim.rounds.PackedEventWorkloads`): ``ws_integral``
(W, P), the integral of the policy's WS share over the horizon;
``ws_winmax`` (W, P, NT), the share's maximum in each lease window; and
``ws_at_tick`` (W, P, NT), the demand at each lease boundary. The host
builds the same tables with numpy, ``repro_torch.sim.rounds
.ws_fold_tables_batch`` (the JAX package's ``repro.sim.rounds
.ws_fold_tables_batch``), which the trace-driven pack keeps using, and
so does ``pack_scenarios`` under the round step's plain backend
(``kernel="torch"``, the CPU's default); the JAX package has no Pallas
kernel for them.

* :func:`fold_tables_ref` is the plain version: the host function's
  steps in torch, on any device.
* :func:`fold_tables` is the wrapper: CPU tensors run the plain version,
  CUDA tensors launch ``csrc/ws_fold.cu`` once (a block per point and 8
  lanes) on the current stream, without a synchronize, and count the
  launch in ``fold_tables.launches``. Nothing falls back: a CUDA input
  the kernel does not take raises.

Inputs of both: ``times`` (N,) float64, one sorted, non-negative time
axis shared by every lane; ``values`` (W, N) float32 or float64 demands;
``leases`` and ``levels`` (P,) float64 (the level is the capacity C for
FB, the WS lower bound for FLB-NUB); ``duration``, ``policy`` (``"fb"``
or ``"flb_nub"``), ``nt`` (:func:`table_width`) and the pack ``dtype``.
Both compute in float64 and round once to ``dtype``. The window index
is numpy's float64 floor division (``times // L``), which torch's floor
division computes too. With integer demands and levels every share is
an integer and every width a multiple of the step, so the integral is
exact in any summation order and the tables equal the host's bit for
bit; with other widths the integral's summation order shows in its last
bits.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Sequence, Tuple

import torch

from repro_torch.kernels.cudalib import CudaLibrary, require_cuda

__all__ = ["POLICIES", "table_width", "fold_tables_ref", "fold_tables",
           "LIBRARY", "build"]

# The policy codes of the C interface (round_step.cu's too).
POLICIES = {"fb": 0, "flb_nub": 1}


def table_width(duration: float, leases: Sequence[float]) -> int:
    """NT, the tables' last dimension: the shortest lease's windows over
    the horizon, plus the probe at the horizon (``ws_fold_tables_batch``'s
    ``nt``)."""
    return max(math.ceil(duration / min(float(x) for x in leases)), 1) + 1


def _policy(policy: str) -> int:
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected one of "
                         f"{tuple(POLICIES)}")
    return POLICIES[policy]


# ------------------------------------------------------- the plain version

def fold_tables_ref(times: torch.Tensor, values: torch.Tensor,
                    leases: torch.Tensor, levels: torch.Tensor, *,
                    duration: float, policy: str, nt: int,
                    dtype: torch.dtype
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fold_tables` on any device:
    ``(integral (W, P), winmax (W, P, NT), at_tick (W, P, NT))`` in
    ``dtype``, step for step ``ws_fold_tables_batch``'s."""
    flb = _policy(policy)
    f64 = dict(dtype=torch.float64, device=times.device)
    v = values.double()
    W, N = v.shape
    P = leases.shape[0]
    horizon = torch.tensor(duration, **f64)
    edges = torch.minimum(torch.cat([times[1:], horizon[None]]), horizon)
    widths = torch.clamp_min(edges - torch.minimum(times, horizon), 0.0)
    if flb:
        share = torch.clamp_min(v[:, None, :] - levels[None, :, None], 0.0)
    else:
        share = torch.minimum(v[:, None, :], levels[None, :, None])
    integral = share @ widths                                   # (W, P)
    n_win = torch.clamp_min(torch.ceil(horizon / leases), 1).long()
    win_edges = torch.arange(nt, **f64)[None, :] * leases[:, None]
    # The point each lease boundary falls in (right-continuous), with
    # numpy's wrap of -1 to the last point.
    bidx = torch.searchsorted(times, win_edges.reshape(-1),
                              right=True).reshape(P, nt) - 1
    bidx = torch.where(bidx < 0, bidx + N, bidx)
    at_tick = v[:, bidx]                                        # (W, P, NT)
    winmax = share.gather(2, bidx.expand(W, P, nt))
    # The interior points' maximum per window index.
    widx = torch.clamp_max(torch.div(times[None, :], leases[:, None],
                                     rounding_mode="floor").long(), nt - 1)
    interior = torch.where((times < horizon)[None, None, :], share,
                           torch.tensor(-math.inf, **f64))
    winmax = winmax.scatter_reduce(2, widx[None].expand(W, P, N), interior,
                                   reduce="amax", include_self=True)
    live = (torch.arange(nt, device=times.device)[None, :]
            <= n_win[:, None])[None]
    zero = torch.zeros((), **f64)
    return (integral.to(dtype), torch.where(live, winmax, zero).to(dtype),
            torch.where(live, at_tick, zero).to(dtype))


# ------------------------------------------------------------- the kernel

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.ws_fold_run
    fn.argtypes = ([ctypes.c_int] * 7 + [ctypes.c_double]
                   + [ctypes.c_void_p] * 8)
    fn.restype = ctypes.c_int
    lib.ws_fold_error_string.argtypes = [ctypes.c_int]
    lib.ws_fold_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("ws_fold", NVCC_FLAGS, _declare)


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/ws_fold.cu`` for ``sm_90a`` (``-fmad=false``: every
    product and sum rounded on its own, as numpy's) and return the
    library's path; ``verbose`` prints the ptxas report."""
    return LIBRARY.build(verbose)


def _check(times, values, leases, levels, nt, dtype) -> None:
    require_cuda("fold_tables", "fold_tables_ref", values)
    dev = values.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ws_fold: the pack dtype is float32 or float64, "
                        f"got {dtype}")
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"values: float32 or float64, got {values.dtype}")
    if values.dim() != 2 or values.shape[0] < 1 or values.shape[1] < 1:
        raise ValueError(f"values: shape {tuple(values.shape)}, expected "
                         f"(W, N) with W, N >= 1")
    W, N = values.shape
    P = leases.shape[0] if leases.dim() == 1 else -1
    for name, x, shape in (("times", times, (N,)), ("leases", leases, (P,)),
                           ("levels", levels, (P,))):
        if x.dtype != torch.float64:
            raise TypeError(f"{name}: float64, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                             f"{shape}")
    for name, x in (("times", times), ("values", values),
                    ("leases", leases), ("levels", levels)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous and on {dev}")
    if not 1 <= P <= 65535 or nt < 1:
        raise ValueError(f"ws_fold: needs 1 to 65535 points and nt >= 1 "
                         f"(points {P}, nt {nt})")


def fold_tables(times: torch.Tensor, values: torch.Tensor,
                leases: torch.Tensor, levels: torch.Tensor, *,
                duration: float, policy: str, nt: int, dtype: torch.dtype
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fold tables of every (lane, point): the plain version on CPU
    tensors, ONE launch of ``csrc/ws_fold.cu`` on CUDA tensors. Same
    inputs and outputs as :func:`fold_tables_ref`."""
    if values.device.type == "cpu":
        return fold_tables_ref(times, values, leases, levels,
                               duration=duration, policy=policy, nt=nt,
                               dtype=dtype)
    flb = _policy(policy)
    _check(times, values, leases, levels, nt, dtype)
    lib = LIBRARY.get()
    W, N = values.shape
    P = leases.shape[0]
    dev = values.device
    integral = torch.empty(W, P, dtype=dtype, device=dev)
    winmax = torch.empty(W, P, nt, dtype=dtype, device=dev)
    at_tick = torch.empty(W, P, nt, dtype=dtype, device=dev)
    err = lib.ws_fold_run(
        int(values.dtype == torch.float64), int(dtype == torch.float64), flb,
        W, N, P, nt, float(duration), times.data_ptr(), values.data_ptr(),
        leases.data_ptr(), levels.data_ptr(), integral.data_ptr(),
        winmax.data_ptr(), at_tick.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("ws_fold kernel launch failed: "
                           + lib.ws_fold_error_string(err).decode())
    fold_tables.launches += 1
    return integral, winmax, at_tick


fold_tables.launches = 0
