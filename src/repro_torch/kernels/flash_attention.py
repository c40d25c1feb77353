"""Flash attention forward: the CUDA kernel's wrapper.

``flash_attention_bkv`` launches ``csrc/flash_attention.cu`` (built with
nvcc for ``sm_90a`` at first use, bound with ``ctypes``; float32 on the
CUDA cores, bfloat16 on the tensor cores with wgmma) on CUDA tensors
and counts each launch in ``flash_attention_bkv.launches``; it raises on
CPU tensors. It replaces the JAX package's Pallas kernel
``repro.kernels.flash_attention.flash_attention_bkv`` and keeps its
layout contract: q (B·KV·G, Sq, hd) where consecutive G rows share one
kv head, k/v (B·KV, Skv, hd), out like q. The plain version is
``ref.flash_attention_ref``; ``ops.flash_attention`` folds the model
layout into this one and picks the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.cudalib import (DTYPE_CODES, HEAD_DIMS,
                                        SM90A_FLAGS, CudaLibrary,
                                        require_cuda, require_layout)

__all__ = ["flash_attention_bkv", "LIBRARY"]


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                         ctypes.c_float]
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("flash_attention", SM90A_FLAGS, _declare,
                      headers=("common.cuh", "sm90.cuh"))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    require_cuda("flash_attention_bkv", "ref.flash_attention_ref", q)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"expected q (BH, Sq, hd), k/v (BKV, Skv, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, sq, hd = q.shape
    bkv, skv, hdk = k.shape
    if hdk != hd or hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} (k: {hdk}) must be one of "
                         f"{HEAD_DIMS}")
    if bh % bkv or not 0 < bh <= 65535 or sq == 0 or skv == 0:
        raise ValueError(f"BH {bh} must be a multiple of BKV {bkv} (at most "
                         f"65535) and Sq, Skv nonzero")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise TypeError(f"{name}: {x.dtype} on {x.device}, expected "
                            f"{q.dtype} on {q.device}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype}: the kernel takes float32 or "
                        f"bfloat16")
    require_layout(q.device, q=q, k=k, v=v)


def flash_attention_bkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q: (BH, Sq, hd) with BH = B·KV·G; k/v: (BKV, Skv, hd). Query row
    i sits at absolute position ``q_offset + i``. One launch on the
    current stream; returns (BH, Sq, hd) in q's dtype."""
    _check(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"window {window} must be positive")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap {softcap} must be positive")
    lib = LIBRARY.get()
    bh, sq, hd = q.shape
    bkv, skv, _ = k.shape
    out = torch.empty_like(q)
    err = lib.flash_attention_fwd(
        DTYPE_CODES[q.dtype], bh, bkv, sq, skv, hd, int(causal),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), int(q_offset),
        1.0 / math.sqrt(hd), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention_bkv.launches += 1
    return out


flash_attention_bkv.launches = 0
