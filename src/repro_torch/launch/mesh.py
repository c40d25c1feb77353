"""Device layouts: the counterpart of ``repro.launch.mesh``.

A ``Layout`` holds the axis names and sizes of the reference's
``jax.sharding.Mesh`` and, where the port can place tensors on it, a
``torch.distributed.device_mesh.DeviceMesh`` with the same names and
sizes, and the device this rank's tensors live on:

* ``make_local_mesh(device)`` is one card (or the CPU, or meta) with the
  production axis names and no ``DeviceMesh``: a model on it holds plain
  tensors;
* ``make_mesh(shape, axes)`` is a layout over the initialized process
  group (``init_device_mesh``); its world size must be the layout's
  size, and a model on it holds DTensors placed by the sharding specs;
* ``make_production_mesh(multi_pod=)`` is the reference's 16 × 16 or
  2 × 16 × 16 pod layout: a real ``DeviceMesh`` when a process group of
  that world size is up (the dry run brings one up with PyTorch's
  ``fake`` backend, so one process stands for every rank), otherwise a
  description with no devices.

As in the reference, building a layout is a function call: importing
this module touches no process group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.compat import Device, resolve_device

__all__ = ["Layout", "make_local_mesh", "make_mesh", "make_production_mesh"]


@dataclasses.dataclass(frozen=True)
class Layout:
    """Axis names and sizes; the device this rank's tensors live on
    (``None`` for a description of a layout with no process group); and
    the ``DeviceMesh`` of a layout over a process group (``None`` on one
    device)."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    device: Optional[torch.device] = None
    mesh: Optional[object] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_local_mesh(device: Device = None) -> Layout:
    """One card with the production axis names, ``("data", "model")`` of
    sizes (1, 1). ``device`` as ``compat.resolve_device`` takes it: the
    card by default (raises without one), ``"cpu"`` or ``"meta"`` on
    request."""
    return Layout((1, 1), ("data", "model"), resolve_device(device))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None) -> Layout:
    """A layout of ``shape`` with axis names ``axes`` over the
    initialized process group, whose world size must be the layout's
    size (no process group, or another size, raises).

    ``device_type`` is the mesh's (default: ``"cuda"`` under ``nccl``,
    ``"cpu"`` otherwise). This rank's tensors live on its card under
    ``nccl`` (``cuda:<rank mod the visible cards>``), on the meta device
    under the ``fake`` backend (nothing is stored), else on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    size = math.prod(shape)
    if len(shape) != len(axes):
        raise ValueError(f"layout {shape} needs one name per axis, got "
                         f"{axes}")
    if not dist.is_initialized():
        raise RuntimeError(
            f"layout {shape} needs a process group of {size} ranks; none "
            f"is initialized (torch.distributed.init_process_group)")
    if dist.get_world_size() != size:
        raise RuntimeError(
            f"layout {shape} needs a process group of {size} ranks; the "
            f"initialized one has {dist.get_world_size()}")
    backend = dist.get_backend()
    device_type = device_type or ("cuda" if backend == "nccl" else "cpu")
    if backend == "fake":
        device = "meta"
    elif backend == "nccl":
        device = torch.device(
            "cuda", dist.get_rank() % max(1, torch.cuda.device_count()))
    else:
        device = "cpu"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    return Layout(shape, axes, dev, mesh)


def make_production_mesh(*, multi_pod: bool = False) -> Layout:
    """The reference's production layouts: 16 × 16 (one pod, 256 chips;
    axes 'data' = FSDP / batch, 'model' = tensor / expert parallel) or
    2 × 16 × 16 (two pods; 'pod' = data parallel across pods). A real
    layout (``make_mesh``) when a process group of that world size is
    up, else a description with no devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.is_initialized() and dist.get_world_size() == math.prod(shape):
        return make_mesh(shape, axes)
    return Layout(shape, axes)
