"""Serving engine: continuous-batching decode over KV caches.

The counterpart of ``repro.serving.engine``, with the device in the
mesh's place. A ``Replica`` is the WS TRE's unit of scaling (the paper's
"Web service instance"): it owns a fixed pool of decode slots; requests
are prefilled into free slots and all slots step together, each at its
OWN cache position (per-slot ``pos``, the continuous-batching
invariant). Slot occupancy is the utilization signal the §6.4
instance-adjustment policy consumes (the 80 % rule), via
``Replica.utilization``.

``VirtualReplica`` is the replay tier: the same slot lifecycle and
utilization signal with a fixed tokens-per-request latency model instead
of a forward pass. ``LeastLoadedRouter`` is the LVS least-connection
analogue: requests go to the replica with the fewest outstanding slots.

A ``Replica``'s ``params`` is the ``Model`` that holds its weights, so
replicas built with ``params=other.params`` share one copy of them on
the device (the autoscaler does this).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.compat import Device, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import FRONTEND_FAMILIES, Model

__all__ = ["Request", "SlotPool", "Replica", "VirtualReplica",
           "LeastLoadedRouter"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 16
    submitted: float = 0.0
    completed: float = 0.0
    output: Optional[List[int]] = None


class SlotPool:
    """The slot-occupancy surface shared by the real and virtual tiers:
    whatever serves requests, the router and the §6.4 policy only ever
    see ``n_active`` / ``utilization`` / ``free_slot``."""

    slots: int
    active: Dict[int, Request]

    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def utilization(self) -> float:
        return self.n_active / self.slots

    def free_slot(self) -> Optional[int]:
        for s in range(self.slots):
            if s not in self.active:
                return s
        return None


class Replica(SlotPool):
    def __init__(self, cfg: ArchConfig, device: Device = None,
                 slots: int = 8, max_len: int = 256,
                 compute_dtype=torch.float32, params: Optional[Model] = None,
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = Model(cfg, self.device,
                           compute_dtype=compute_dtype).init(seed)
        self.model = self.params = params
        self.slots = slots
        self.max_len = max_len
        self.cache = self.model.init_cache(slots, max_len,
                                           dtype=compute_dtype)
        self.pos = np.zeros(slots, np.int32)       # next write position
        self.remaining = np.zeros(slots, np.int32)
        self.active: Dict[int, Request] = {}       # slot → request
        self.last_token = np.zeros(slots, np.int32)

    # ----------------------------------------------------------- serving

    def admit(self, req: Request) -> bool:
        slot = self.free_slot()
        if slot is None:
            return False
        # Prefill the slot: run the prompt through a single-row cache and
        # splice it in (batch=1 prefill keeps latency bounded).
        row_cache = self.model.init_cache(1, self.max_len,
                                          dtype=self.cache_dtype())
        batch = {"tokens": torch.as_tensor(req.prompt[None, :],
                                           device=self.device)}
        if self.cfg.family in FRONTEND_FAMILIES:
            # The reference's serving frontend: zero patch / frame
            # embeddings (every cross-attention sublayer then adds 0).
            batch["frontend"] = torch.zeros(
                1, self.cfg.frontend_len, self.cfg.d_model,
                dtype=torch.float32, device=self.device)
        logits, row_cache = self.model.prefill(batch, row_cache)
        for name, layer in self.cache.items():
            for key, full in layer.items():
                full[:, slot] = row_cache[name][key][:, 0]
        self.active[slot] = req
        self.pos[slot] = len(req.prompt)
        self.remaining[slot] = req.max_new_tokens
        self.last_token[slot] = int(torch.argmax(logits[0, -1]))
        req.output = [self.last_token[slot]]
        return True

    def cache_dtype(self):
        return next(iter(next(iter(self.cache.values())).values())).dtype

    def step(self) -> List[Request]:
        """One decode step for all slots; returns finished requests."""
        if not self.active:
            return []
        toks = torch.as_tensor(self.last_token[:, None], device=self.device)
        # Per-slot write positions: with heterogeneous prompt lengths
        # every slot rotates, writes and masks at its own cache position
        # (inactive rows write at stale positions — harmless, admit
        # re-splices the whole row cache).
        pos = torch.as_tensor(self.pos, device=self.device)
        logits, self.cache = self.model.decode(toks, self.cache, pos)
        nxt = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy() \
            .astype(np.int32)
        finished = []
        for slot, req in list(self.active.items()):
            self.last_token[slot] = nxt[slot]
            req.output.append(int(nxt[slot]))
            self.pos[slot] += 1
            self.remaining[slot] -= 1
            if self.remaining[slot] <= 0 or self.pos[slot] >= self.max_len - 1:
                req.completed = time.time()
                finished.append(req)
                del self.active[slot]
        return finished


class VirtualReplica(SlotPool):
    """The replay-tier replica: Replica's slot lifecycle — admit into a
    free slot, one token per step, finish after ``max_new_tokens`` —
    with no Model and no forward pass. A request therefore holds its
    slot for exactly ``max_new_tokens`` serve ticks."""

    def __init__(self, slots: int = 8):
        self.slots = slots
        self.active: Dict[int, Request] = {}
        self.remaining = np.zeros(slots, np.int32)

    def admit(self, req: Request) -> bool:
        slot = self.free_slot()
        if slot is None:
            return False
        self.active[slot] = req
        self.remaining[slot] = req.max_new_tokens
        req.output = []
        return True

    def step(self) -> List[Request]:
        finished = []
        for slot, req in list(self.active.items()):
            self.remaining[slot] -= 1
            req.output.append(0)         # a stand-in token per tick
            if self.remaining[slot] <= 0:
                finished.append(req)
                del self.active[slot]
        return finished


class LeastLoadedRouter:
    """LVS least-connection scheduling (§6.4) over replicas."""

    def route(self, replicas: List[SlotPool]) -> Optional[SlotPool]:
        candidates = [r for r in replicas if r.free_slot() is not None]
        if not candidates:
            return None
        return min(candidates, key=lambda r: r.n_active)
