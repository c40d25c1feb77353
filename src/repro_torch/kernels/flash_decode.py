"""Flash decode: the CUDA kernel's wrapper.

``flash_decode_bkv`` launches ``csrc/flash_decode.cu`` (split-K over
256-key chunks, then a combine pass; built with nvcc for ``sm_90a`` at
first use, bound with ``ctypes``) on CUDA tensors and counts each call
in ``flash_decode_bkv.launches``; it raises on CPU tensors. It replaces
the JAX package's Pallas kernel
``repro.kernels.flash_decode.flash_decode_bkv`` and keeps its layout
contract: q (B·KV, G, hd) one token per row group, k/v (B·KV, S, hd), a
scalar position ``pos``. The plain version is ``ref.flash_decode_ref``;
``ops.flash_decode`` folds the serving layout into this one and picks
the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from repro_torch.kernels.cudalib import (DTYPE_CODES, HEAD_DIMS,
                                        SM90A_FLAGS, CudaLibrary,
                                        require_cuda, require_layout)

__all__ = ["flash_decode_bkv", "LIBRARY", "MAX_GROUP"]

MAX_GROUP = 8


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.flash_decode_fwd
    fn.argtypes = ([ctypes.c_int] * 7 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p] * 8)
    fn.restype = ctypes.c_int
    lib.flash_decode_chunk_keys.argtypes = []
    lib.flash_decode_chunk_keys.restype = ctypes.c_int
    lib.flash_decode_error_string.argtypes = [ctypes.c_int]
    lib.flash_decode_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("flash_decode", SM90A_FLAGS, _declare,
                      headers=("common.cuh",))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    require_cuda("flash_decode_bkv", "ref.flash_decode_ref", q)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"expected q (BKV, G, hd), k/v (BKV, S, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bkv, g, hd = q.shape
    if hd not in HEAD_DIMS or not 0 < g <= MAX_GROUP \
            or not 0 < bkv <= 65535 or k.shape[1] == 0:
        raise ValueError(f"head_dim {hd} must be one of {HEAD_DIMS}, G {g} "
                         f"at most {MAX_GROUP}, BKV {bkv} at most 65535")
    if q.dtype not in DTYPE_CODES or k.dtype not in DTYPE_CODES \
            or v.dtype != k.dtype \
            or (q.dtype == torch.bfloat16 and k.dtype == torch.float32):
        raise TypeError(f"q {q.dtype}, k {k.dtype}, v {v.dtype}: the kernel "
                        f"takes float32 or bfloat16 (a float32 q may read a "
                        f"bfloat16 cache)")
    require_layout(q.device, q=q, k=k, v=v)


def flash_decode_bkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Union[int, torch.Tensor], *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q: (BKV, G, hd); k/v: (BKV, S, hd); pos: the current absolute
    position (cache write index), an int or a 0-d int32 tensor on q's
    device, which the kernel reads on the device (no host sync).
    Returns (BKV, G, hd) in q's dtype."""
    _check(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"window {window} must be positive")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap {softcap} must be positive")
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    if pos.dim() != 0:
        raise ValueError(f"pos must be a scalar, got shape "
                         f"{tuple(pos.shape)}")
    pos = pos.contiguous()
    lib = LIBRARY.get()
    bkv, g, hd = q.shape
    s = k.shape[1]
    nchunk = -(-s // lib.flash_decode_chunk_keys())
    part_acc = torch.empty(bkv, nchunk, g, hd, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(bkv, nchunk, g, 2, dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    err = lib.flash_decode_fwd(
        DTYPE_CODES[q.dtype], DTYPE_CODES[k.dtype], bkv, g, s, hd,
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), 1.0 / math.sqrt(hd),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_decode kernel launch failed: "
                           + lib.flash_decode_error_string(err).decode())
    flash_decode_bkv.launches += 1
    return out


flash_decode_bkv.launches = 0
