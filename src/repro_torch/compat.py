"""Device and dtype resolution shared by the port's entry points.

``resolve_device`` is the one place that decides where work runs: the
card by default, the CPU only when the caller asks for it. There is no
silent CPU fallback — a caller that wants the CPU says so.
``resolve_backend`` is the one place that decides what runs there: a
CUDA kernel on the card, its plain PyTorch version on the CPU, and the
plain version on the card only when the caller asks for it.

``resolve_pack_dtype`` is the counterpart of ``repro.compat.
resolve_pack_dtype``: packs default to float32 (what the JAX package
uses without x64), and float64 is an explicit request.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "resolve_backend", "resolve_pack_dtype",
           "check_devices", "BACKENDS", "Device"]

Device = Optional[Union[str, torch.device]]
# "cuda": the hand-written kernels; "torch": their plain PyTorch versions.
BACKENDS = ("cuda", "torch")


def resolve_device(device: Device = None) -> torch.device:
    """``None`` → the current CUDA device; raises when there is none.
    ``"cpu"`` (or a CPU ``torch.device``) → the CPU. A CUDA device that
    is asked for but absent raises too."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run "
                "the plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected cuda "
                         f"or cpu")
    return dev


def resolve_backend(choice: Optional[str], device: torch.device,
                    name: str = "impl", plain_on_cpu: bool = False) -> str:
    """The backend that runs on ``device``: ``None`` → ``"cuda"`` on a
    CUDA device and ``"torch"`` on the CPU; ``"torch"`` on a card only
    when asked for. ``"cuda"`` on the CPU raises, unless
    ``plain_on_cpu``: then the kernels' wrappers are called and each runs
    its plain version on the CPU tensors it is given. ``name`` is the
    caller's option in messages."""
    if choice is None:
        return "cuda" if device.type == "cuda" else "torch"
    if choice not in BACKENDS:
        raise ValueError(f"{name} {choice!r}: expected one of {BACKENDS}")
    if choice == "cuda" and device.type != "cuda" and not plain_on_cpu:
        raise ValueError(f"{name}=\"cuda\" needs CUDA tensors; the CPU "
                         f"runs {name}=\"torch\"")
    return choice


def resolve_pack_dtype(dtype=None) -> np.dtype:
    """Packing dtype as a numpy dtype: float32 by default, float64 on
    request. Accepts numpy or torch float dtypes."""
    if dtype is None:
        return np.dtype(np.float32)
    if isinstance(dtype, torch.dtype):
        dtype = {torch.float32: np.float32,
                 torch.float64: np.float64}.get(dtype)
    dt = np.dtype(dtype) if dtype is not None else None
    if dt not in (np.dtype(np.float32), np.dtype(np.float64)):
        raise ValueError(f"pack dtype must be float32 or float64, got "
                         f"{dtype!r}")
    return dt


def check_devices(devices) -> None:
    """The JAX package's ``devices=`` option shards sweep lanes across
    devices. The port runs one device; the lane splitter over several
    GPUs is a later slice, so anything but ``None`` / 1 raises."""
    if devices is None or (isinstance(devices, int) and devices == 1):
        return
    raise NotImplementedError(
        f"devices={devices!r}: the multi-GPU lane splitter is not ported "
        f"yet (ROADMAP, queued work of the port); run on one device")
