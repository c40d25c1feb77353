"""Build and load the port's CUDA sources: one shared helper for every
kernel, and the launch checks the attention kernels share.

Each kernel lives in ``csrc/<name>.cu`` with a plain C interface (the
attention kernels also include ``csrc/common.cuh``). On first use it is
compiled with nvcc for ``sm_90a`` into a shared library under
``kernels/build/`` (gitignored), named by the hash of the source, the
headers it includes and the flags, so an edited source or header or
changed flags rebuild; the build
writes a temporary file and renames it into place, so concurrent builds
never load a half-written library. The library is then loaded once per
process with ``ctypes`` under a lock, and its functions' argument types
are declared by the kernel module's ``declare`` callback.

nvcc is looked up on ``PATH``, then under ``$CUDA_HOME/bin`` (default
``/usr/local/cuda``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

__all__ = ["CSRC", "BUILD_DIR", "SM90A_FLAGS", "HEAD_DIMS", "DTYPE_CODES",
           "CudaLibrary", "nvcc", "require_cuda", "require_layout",
           "stream_zeroed_ints"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# nvcc flags of the attention kernels (round_step adds -fmad=false).
SM90A_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
# Head dims the attention kernels are instantiated for, and the dtype
# codes of their C interface.
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Per (device, stream): the int32 counters and flags the kernels
# synchronise their blocks through (see ``stream_zeroed_ints``).
_STREAM_INTS: dict = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "with the CUDA toolkit's nvcc (set CUDA_HOME)")
    return found


class CudaLibrary:
    """One ``csrc/<name>.cu`` source, built on demand and loaded once.

    ``declare(lib)`` sets ``argtypes`` / ``restype`` of the library's C
    functions (pointers and the stream as ``ctypes.c_void_p``);
    ``headers`` names the ``csrc/`` headers the source includes."""

    def __init__(self, name: str, flags: Sequence[str],
                 declare: Callable[[ctypes.CDLL], None],
                 headers: Sequence[str] = ()):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.headers = tuple(CSRC / h for h in headers)
        self.flags = tuple(flags)
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        text = b"".join(f.read_bytes() for f in (self.source, *self.headers))
        tag = hashlib.sha256(text + " ".join(self.flags).encode()).hexdigest()
        return BUILD_DIR / f"{self.name}_{tag[:16]}.so"

    def build(self, verbose: bool = False) -> Path:
        """Compile the source unless its library exists, and return the
        library's path. With ``verbose`` it always compiles and prints
        the ptxas register / shared-memory report."""
        out = self.path()
        if out.exists() and not verbose:
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *self.flags, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({res.returncode}):\n{res.stderr}")
        if verbose:
            print(res.stderr, end="", flush=True)
        os.replace(tmp, out)
        return out

    def get(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self._lib = lib
            return self._lib


def require_cuda(kernel: str, plain: str, x: torch.Tensor) -> None:
    """A wrapper launches its kernel on CUDA tensors only; on the CPU the
    caller runs the plain version ``plain``."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} launches the CUDA kernel and takes CUDA "
                         f"tensors, got {x.device}; the CPU runs {plain}")


def require_layout(device: torch.device, **tensors: torch.Tensor) -> None:
    """Every operand lies on ``device``, contiguous and 16-byte aligned
    (the kernels read rows with 16-byte loads)."""
    for name, x in tensors.items():
        if x.device != device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned "
                             f"and on {device}")


def stream_zeroed_ints(stream: torch.cuda.Stream, size: int) -> torch.Tensor:
    """At least ``size`` int32 counters for the kernels launched on
    ``stream``, zero between launches: allocated zeroed on that stream,
    and every kernel that uses them leaves them at zero when it ends.
    Launches on one stream never overlap, so its kernels share one
    buffer; a buffer per stream keeps concurrent streams apart."""
    key = (stream.device, stream.cuda_stream)
    buf = _STREAM_INTS.get(key)
    if buf is None or buf.numel() < size:
        with torch.cuda.stream(stream):
            buf = torch.zeros(max(size, 65536), dtype=torch.int32,
                              device=stream.device)
        _STREAM_INTS[key] = buf
    return buf
