"""Device and dtype resolution shared by the port's entry points.

``resolve_device`` is the one place that decides where work runs: the
card by default, the CPU only when the caller asks for it. There is no
silent CPU fallback — a caller that wants the CPU says so. ``"meta"``
(shapes and dtypes, no storage) is taken only when asked for: the dry
run (``launch/dryrun.py``) builds its cells there.
``resolve_backend`` is the one place that decides what runs there: a
CUDA kernel on the card, its plain PyTorch version on the CPU, and the
plain version on the card only when the caller asks for it. On the meta
device the default is what the card would run, the kernels, whose
wrappers then allocate their outputs and report their cost
(``kernels/cost.py``).

``resolve_pack_dtype`` is the counterpart of ``repro.compat.
resolve_pack_dtype``: packs default to float32 (what the JAX package
uses without x64), and float64 is an explicit request.
"""

from __future__ import annotations

import os
from typing import List, Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "resolve_backend", "resolve_pack_dtype",
           "resolve_devices", "BACKENDS", "Device"]

Device = Optional[Union[str, torch.device]]
# "cuda": the hand-written kernels; "torch": their plain PyTorch versions.
BACKENDS = ("cuda", "torch")


def resolve_device(device: Device = None) -> torch.device:
    """``None`` → the current CUDA device; raises when there is none.
    ``"cpu"`` (or a CPU ``torch.device``) → the CPU; ``"meta"`` → the
    meta device. A CUDA device that is asked for but absent raises
    too."""
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
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}; expected cuda, "
                         f"cpu or meta")
    return dev


def resolve_backend(choice: Optional[str], device: torch.device,
                    name: str = "impl", plain_on_cpu: bool = False) -> str:
    """The backend that runs on ``device``: ``None`` → ``"cuda"`` on a
    CUDA or meta device and ``"torch"`` on the CPU; ``"torch"`` on a card
    only when asked for. ``"cuda"`` on the CPU raises, unless
    ``plain_on_cpu``: then the kernels' wrappers are called and each runs
    its plain version on the CPU tensors it is given. ``name`` is the
    caller's option in messages."""
    if choice is None:
        return "cuda" if device.type in ("cuda", "meta") else "torch"
    if choice not in BACKENDS:
        raise ValueError(f"{name} {choice!r}: expected one of {BACKENDS}")
    if choice == "cuda" and device.type == "cpu" and not plain_on_cpu:
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


def resolve_devices(devices) -> Optional[List[torch.device]]:
    """The counterpart of ``repro.compat.resolve_devices``: a ``devices``
    option as the list of devices the sweep's lanes are split across, or
    ``None`` for the plain single-device path.

    ``None``, ``1`` and a sequence of one device give ``None``. An int
    ``n >= 2`` takes ``cuda:0`` … ``cuda:n-1`` and raises when fewer
    cards are visible: nothing falls back to fewer devices than were
    asked for. A sequence is resolved entry by entry through
    :func:`resolve_device` (``"cpu"``, ``"cuda:1"``, ``torch.device``)
    and may name a device more than once: the splitter issues no
    collective, so two shards on one device simply run one after the
    other (the way to drive it on the CPU or on a one-card machine)."""
    if devices is None:
        return None
    if isinstance(devices, int):
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        if devices == 1:
            return None
        visible = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if devices > visible:
            raise ValueError(
                f"devices={devices} requested but only {visible} CUDA "
                f"device(s) visible (CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES', '<unset>')}); "
                f"pass a device list such as [\"cpu\", \"cpu\"] to split "
                f"lanes over one device")
        return [torch.device("cuda", i) for i in range(devices)]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("devices must be >= 1, got an empty sequence")
    return devs if len(devs) > 1 else None
