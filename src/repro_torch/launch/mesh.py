"""Device layouts: the counterpart of ``repro.launch.mesh``.

The reference builds ``jax.sharding.Mesh`` objects: the production pod
meshes for its dry run and a one-device mesh with the production axis
names for tests. The port runs a model on one card, so a ``Layout`` is
device selection on one node, not a ``DeviceMesh``: its axes keep the
reference's names and sizes, and it holds the one device it runs on.

``make_production_mesh`` describes the reference's pod layouts (16 × 16
chips, or 2 × 16 × 16 across two pods) with no devices: sharding a cell
over them needs the parameter, cache and batch sharding specs that the
port does not have yet (ROADMAP A3), and the dry run refuses any layout
of more than one card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.compat import Device, resolve_device

__all__ = ["Layout", "make_local_mesh", "make_production_mesh"]


@dataclasses.dataclass(frozen=True)
class Layout:
    """Axis names and sizes, and the device of a one-card layout
    (``None`` for a description of a layout the port cannot run)."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    device: Optional[torch.device] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_local_mesh(device: Device = None) -> Layout:
    """One card with the production axis names, ``("data", "model")`` of
    sizes (1, 1). ``device`` as ``compat.resolve_device`` takes it: the
    card by default (raises without one), ``"cpu"`` or ``"meta"`` on
    request."""
    return Layout((1, 1), ("data", "model"), resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False) -> Layout:
    """The reference's production layouts as a description: 16 × 16
    (one pod, 256 chips; axes 'data' = FSDP / batch, 'model' = tensor /
    expert parallel) or 2 × 16 × 16 (two pods; 'pod' = data parallel
    across pods)."""
    if multi_pod:
        return Layout((2, 16, 16), ("pod", "data", "model"))
    return Layout((16, 16), ("data", "model"))
