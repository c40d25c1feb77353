"""Flash decode: the CUDA kernel's wrapper.

``flash_decode_bkv`` launches ``csrc/flash_decode.cu`` (split-K: one
block per SM, each streaming a run of the visible cache through a ring
of shared memory, the last block of each row group combining the runs in
the same launch; built with nvcc for ``sm_90a`` at first use, bound with
``ctypes``) on CUDA tensors and counts each call in
``flash_decode_bkv.launches``; it raises on CPU tensors. It replaces
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

from repro_torch.kernels.cost import H100_SMS
from repro_torch.kernels.cudalib import (DTYPE_CODES, HEAD_DIMS,
                                        SM90A_FLAGS, CudaLibrary,
                                        require_cuda, require_layout,
                                        stream_zeroed_ints)

__all__ = ["flash_decode_bkv", "LIBRARY", "MAX_GROUP", "chunk_keys",
           "partials", "runs"]

MAX_GROUP = 8
# csrc/flash_decode.cu's K_BYTES and MAX_CK: a chunk holds 16 KB of K
# rows, at most 256 keys.
CHUNK_K_BYTES = 16384
MAX_CHUNK_KEYS = 256


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.flash_decode_fwd
    fn.argtypes = ([ctypes.c_int] * 8 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p] * 9)
    fn.restype = ctypes.c_int
    lib.flash_decode_chunk_keys.argtypes = [ctypes.c_int] * 2
    lib.flash_decode_chunk_keys.restype = ctypes.c_int
    lib.flash_decode_error_string.argtypes = [ctypes.c_int]
    lib.flash_decode_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("flash_decode", SM90A_FLAGS, _declare,
                      headers=("common.cuh", "sm90.cuh"))
# Per device: the number of SMs.
_SMS: dict = {}


def runs(device: torch.device, bkv: int, nchunk: int) -> int:
    """Blocks per row group: one wave of one block per SM (an H100 SXM's
    132 on the meta device)."""
    if device.type == "meta":
        return max(1, min(nchunk, H100_SMS // bkv))
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return max(1, min(nchunk, _SMS[device] // bkv))


def chunk_keys(dtype: torch.dtype, hd: int) -> int:
    """Keys per chunk of the kernel's ring for a ``dtype`` cache: the
    kernel's ``flash_decode_chunk_keys``, without building it."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return min(CHUNK_K_BYTES // (hd * itemsize), MAX_CHUNK_KEYS)


def partials(q: torch.Tensor, nb: int):
    """The split-K scratch of ``nb`` runs per row group: the runs' float32
    accumulators (BKV, nb, G, hd) and their (max, sum) pairs."""
    bkv, g, hd = q.shape
    return (torch.empty(bkv, nb, g, hd, dtype=torch.float32,
                        device=q.device),
            torch.empty(bkv, nb, g, 2, dtype=torch.float32,
                        device=q.device))


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
    Returns (BKV, G, hd) in q's dtype; zeros where no key is visible."""
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
    nb = runs(q.device, bkv,
              -(-s // lib.flash_decode_chunk_keys(DTYPE_CODES[k.dtype], hd)))
    part_acc, part_ml = partials(q, nb)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device)
    err = lib.flash_decode_fwd(
        DTYPE_CODES[q.dtype], DTYPE_CODES[k.dtype], bkv, g, s, hd,
        0 if window is None else int(window), nb,
        0.0 if softcap is None else float(softcap), 1.0 / math.sqrt(hd),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        stream_zeroed_ints(stream, bkv).data_ptr(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError("flash_decode kernel launch failed: "
                           + lib.flash_decode_error_string(err).decode())
    flash_decode_bkv.launches += 1
    return out


flash_decode_bkv.launches = 0
