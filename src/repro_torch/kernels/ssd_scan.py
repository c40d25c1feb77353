"""Mamba2 SSD chunked scan: the CUDA kernel's wrapper.

``ssd_scan_bh`` launches ``csrc/ssd_scan.cu`` on CUDA tensors (built
with nvcc for ``sm_90a`` at first use, bound with ``ctypes``) and counts
each call in ``ssd_scan_bh.launches``; it raises on CPU tensors. One
call is one launch: a block per chunk of a row (and 64 head-dim
columns) runs the chunk's four products on the tensor cores (``wgmma``;
bfloat16 with the float32 intermediates split into two bf16 terms,
float32 as 3 × TF32) and hands the float32 state to the row's next chunk
through a chained scan (a ticket counter hands the chunks out in order,
a flag per row says when the row's slot, ``sT`` itself, holds a chunk's
start state). The counter and the flags live in a buffer per (device,
stream) (``cudalib.stream_zeroed_ints``), zero between launches: the
launch leaves them so, and launches on one stream never overlap.

It replaces the JAX package's Pallas kernel
``repro.kernels.ssd_scan.ssd_scan_bh`` and keeps its layout contract:
x (BH, L, P), a (BH, L), B / C (BH, L, N), s0 (BH, P, N), the groups
already broadcast to heads and batch × heads folded into BH; y in x's
dtype, the final state in float32. The plain version is
``ref.ssd_scan_bh_ref``; ``ops.ssd`` folds the model layout into this
one and picks the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.cudalib import (DTYPE_CODES, SM90A_FLAGS,
                                        CudaLibrary, require_cuda,
                                        require_layout, stream_zeroed_ints)

__all__ = ["ssd_scan_bh", "LIBRARY", "MAX_CHUNK", "MAX_STATE"]

# The kernel's tiles hold a chunk of up to 128 tokens and a state of up
# to 128; P and N must be multiples of 8 (16-byte row loads). A block
# takes 64 head-dim columns.
MAX_CHUNK = 128
MAX_STATE = 128
HEAD_TILE = 64


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.ssd_scan_fwd
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 9
    fn.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("ssd_scan", SM90A_FLAGS, _declare,
                      headers=("common.cuh", "sm90.cuh"))


def _check(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
           C: torch.Tensor, s0: Optional[torch.Tensor], chunk: int) -> None:
    require_cuda("ssd_scan_bh", "ref.ssd_scan_bh_ref", x)
    if x.dim() != 3 or B.dim() != 3 or B.shape != C.shape \
            or B.shape[:2] != x.shape[:2] or a.shape != x.shape[:2]:
        raise ValueError(f"expected x (BH, L, P), a (BH, L), B/C (BH, L, "
                         f"N); got {tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    bh, l, p = x.shape
    n = B.shape[-1]
    if s0 is not None and s0.shape != (bh, p, n):
        raise ValueError(f"s0 {tuple(s0.shape)}: expected {(bh, p, n)}")
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"chunk {chunk}")
    blocks = bh * -(-p // HEAD_TILE) * (l // max(chunk, 1))
    if bh <= 0 or chunk > MAX_CHUNK or p % 8 or n % 8 \
            or not 0 < n <= MAX_STATE or p == 0 or blocks >= 2 ** 31:
        raise ValueError(f"BH {bh} positive, chunk {chunk} at most "
                         f"{MAX_CHUNK}, P {p} and N {n} multiples of 8, N "
                         f"at most {MAX_STATE}, fewer than 2^31 blocks")
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise TypeError(f"x {x.dtype}, B {B.dtype}, C {C.dtype}: the kernel "
                        f"takes float32 or bfloat16, one type for all three")


def ssd_scan_bh(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, s0: Optional[torch.Tensor] = None,
                chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (BH, L, P); a: (BH, L) log-decay; B, C: (BH, L, N); s0: (BH,
    P, N) or None (zero). ``chunk = min(chunk, L)`` must divide L, as in
    the reference. One kernel launch on the current stream; returns y
    (BH, L, P) in x's dtype and the final state (BH, P, N) in float32."""
    chunk = min(chunk, x.shape[1])
    _check(x, a, B, C, s0, chunk)
    a = a.float().contiguous()
    if s0 is not None:
        s0 = s0.float().contiguous()
    require_layout(x.device, x=x, a=a, B=B, C=C,
                   **({} if s0 is None else {"s0": s0}))
    lib = LIBRARY.get()
    bh, l, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    sT = torch.empty(bh, p, n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device)
    sync = stream_zeroed_ints(stream, 1 + bh * -(-p // HEAD_TILE))
    err = lib.ssd_scan_fwd(
        DTYPE_CODES[x.dtype], bh, l, p, n, chunk, x.data_ptr(), a.data_ptr(),
        B.data_ptr(), C.data_ptr(), None if s0 is None else s0.data_ptr(),
        y.data_ptr(), sT.data_ptr(), sync.data_ptr(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_scan kernel launch failed: "
                           + lib.ssd_scan_error_string(err).decode())
    ssd_scan_bh.launches += 1
    return y, sT


ssd_scan_bh.launches = 0
